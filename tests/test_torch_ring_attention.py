"""The port's sequence-parallel attention (``ops/ring_attention.py``
``ring_attention`` and ``ulysses_attention``, ``ops/flash_attention.py``
``ring_flash_attention``) against the JAX package's, on the CPU.

The port runs as 1, 2 or 4 gloo ranks (``launch/session.py
spawn_ranks``, ``tests/torch_sp_rank_fns.py::attention_rank``), each
holding its shard of the sequence; the reference runs under
``shard_map`` on ``conftest.py``'s 8 virtual CPU devices, its Pallas
kernels in interpret mode, called with ``block_q = block_k = 64`` (the
port's tile) wherever it runs them. Global q, k, v ``[2, 256, 4, 16]``
and the output's cotangent are drawn with numpy: at n = 2 each rank
holds 128 positions, so the merges cross K tiles of 64, at n = 4 it
holds 64. For every scheme, n in {2, 4}, causal and not, fp32 and bf16:
the outputs and the gradients of q, k and v; n = 1 degenerates to the
local step; Ulysses refuses heads the axis does not divide, with the
reference's message; the ring's exchange overlapped with the kernels
gives the bits of the serial order; and the plain versions of the flash
kernels on a hop whose keys all lie in the future give o = 0, lse <=
-1e29 and zero gradients.

Tolerances. fp32: atol 2e-5 on o and 5e-5 on the gradients (both ~1 in
size; the scores, the online softmax's merges and the backward's sums
run in another order in XLA and in PyTorch, a few fp32 ulps; the
reference's own ring test holds o to 2e-5). bf16: the inputs are bf16,
o is rounded to bf16 (each hop's o_j too, as the reference rounds it),
and the gradients are rounded to bf16 at the end; a sum a few fp32 ulps
apart can round to the neighbouring bf16 value, so o and the gradients
are held to 2^-7 of their largest value (one bf16 ulp at the top of the
range) and at most 2% of their elements may differ at all.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from theanompi_tpu.ops import pallas_attention as jfa
from theanompi_tpu.ops import ring_attention as jra
from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.ops import flash_attention as tfa

import torch
import torch_sp_rank_fns

SHAPE = (2, 256, 4, 16)
SCHEMES = torch_sp_rank_fns.SCHEMES
CASES = [(s, n, c, d) for n in (2, 4) for s in SCHEMES for c in (False, True)
         for d in ("float32", "bfloat16")]


def _inputs(shape=SHAPE, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def _reference_fn(scheme):
    flash64 = functools.partial(jfa.flash_attention, block_q=64, block_k=64)
    return {"ring": jra.ring_attention,
            "ring_flash": functools.partial(jfa.ring_flash_attention, block_q=64, block_k=64),
            "ulysses": jra.ulysses_attention,
            "ulysses_flash": functools.partial(jra.ulysses_attention, local_fn=flash64)}[scheme]


def _reference(scheme, n, causal, dtype, q, k, v, g):
    """The reference's (o, dq, dk, dv) over the whole sequence, as float32."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq")
    fn = _reference_fn(scheme)

    def sharded(q, k, v):
        return fn(q, k, v, "seq", causal=causal)

    run = jax.shard_map(sharded, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                        check_vma=False)
    dt = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(dt) for a in (q, k, v)]
    o, vjp = jax.vjp(jax.jit(run), *args)
    grads = vjp(jnp.asarray(g).astype(o.dtype))
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (o, *grads))


_PORT: dict = {}


def _port(n, monkeypatch):
    """Every case of ``n`` ranks in one spawn, cached: the CASES, the
    ring's serial order, and the refused Ulysses heads."""
    if n not in _PORT:
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        q, k, v, g = _inputs()
        cases = [(c, s, causal, d, q, k, v, g) for c in CASES if c[1] == n
                 for s, _, causal, d in [c]]
        if n == 1:
            cases = [((s, 1, True, "float32"), s, True, "float32", q, k, v, g) for s in SCHEMES]
        cases += [(("ring_flash_serial", n, causal, "bfloat16"), "ring_flash_serial", causal,
                   "bfloat16", q, k, v, g) for causal in (False, True)]
        q3, k3, v3, g3 = _inputs((1, 64, 3, 8), seed=1)
        cases += [("heads 3", "ulysses", True, "float32", q3, k3, v3, g3)]
        ranks = spawn_ranks(torch_sp_rank_fns.attention_rank, n, (cases,), device="cpu",
                            timeout=240)
        _PORT[n] = {label: ([r[label] for r in ranks] if isinstance(ranks[0][label], str) else
                            tuple(np.concatenate([r[label][i] for r in ranks], axis=1)
                                  for i in range(4)))
                    for label, *_ in cases}
    return _PORT[n]


def _check(got, want, dtype, what):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, (what, name)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 if name == "o" else 5e-5,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -7 * np.abs(b).max(),
                                       err_msg=f"{what} {name}")
            assert (a != b).mean() <= 0.02, (what, name, (a != b).mean())


@pytest.mark.parametrize("scheme,n,causal,dtype", CASES)
def test_matches_the_reference(monkeypatch, scheme, n, causal, dtype):
    got = _port(n, monkeypatch)[(scheme, n, causal, dtype)]
    want = _reference(scheme, n, causal, dtype, *_inputs())
    _check(got, want, dtype, f"{scheme} n={n} causal={causal} {dtype}")


def test_one_rank_degenerates_to_the_local_step(monkeypatch):
    port = _port(1, monkeypatch)
    q, k, v, g = _inputs()
    for scheme in SCHEMES:
        _check(port[(scheme, 1, True, "float32")],
               _reference(scheme, 1, True, "float32", q, k, v, g), "float32", scheme)


@pytest.mark.parametrize("n", [2, 4])
def test_the_overlapped_ring_gives_the_serial_bits(monkeypatch, n):
    port = _port(n, monkeypatch)
    for causal in (False, True):
        for a, b in zip(port[("ring_flash", n, causal, "bfloat16")],
                        port[("ring_flash_serial", n, causal, "bfloat16")]):
            np.testing.assert_array_equal(a, b)


def test_ulysses_refuses_heads_the_axis_does_not_divide(monkeypatch):
    msg = "ulysses attention needs local heads (3) divisible by the 'seq' axis size 2"
    assert _port(2, monkeypatch)["heads 3"] == [msg, msg]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_whole_future_hop_gives_zeros(dtype):
    """A ring hop with ``k_off >= q_off + Tq`` (every key in the future of
    every query): the plain versions give o = 0, lse <= -1e29, and exact
    zeros for dq, dk and dv; the merge then weights the hop by zero."""
    g = torch.Generator().manual_seed(3)
    q3, k3, v3, do3 = (torch.randn((6, 100, 16), generator=g).to(dtype) for _ in range(4))
    kw = dict(causal=True, scale=0.25, q_off=100, k_off=200)
    o, lse = tfa.flash_fwd(q3, k3, v3, **kw)
    assert o.dtype == dtype and torch.all(o == 0) and torch.all(lse <= -1e29)
    dsum = torch.randn((6, 100), generator=g)
    lse_global = torch.randn((6, 100), generator=g)  # the ring's global lse
    dq = tfa.flash_dq(q3, k3, v3, do3, lse_global, dsum, **kw)
    dk, dv = tfa.flash_dkv(q3, k3, v3, do3, lse_global, dsum, **kw)
    for t in (dq, dk, dv):
        assert t.dtype == torch.float32 and torch.all(t == 0)
    # merged after a hop that saw keys, the future hop changes nothing
    o0, lse0 = tfa.flash_fwd(q3, k3, v3, causal=True, scale=0.25, q_off=100, k_off=0)
    m = torch.maximum(lse0, lse)
    acc = o0.float() * torch.exp(lse0 - m)[..., None] + o.float() * torch.exp(lse - m)[..., None]
    l_sum = torch.exp(lse0 - m) + torch.exp(lse - m)
    assert torch.equal((acc / l_sum[..., None]).to(dtype), o0)
