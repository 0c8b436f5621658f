"""The port's flash attention (``theanompi_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels (``ops/pallas_attention.py``),
which run here in Pallas interpret mode, as the reference's own tests
run them.

On the CPU the wrappers run their plain PyTorch versions, so these tests
hold the plain versions (the card's reference for the CUDA kernels) to
the TPU kernels' function: the forward (o and lse) with ragged T and D,
T below one block, Tq != Tk, and nonzero global offsets (a fully future
K/V shard included); dq and dk/dv at offsets through the 1-D and the
2-D kernels; and the gradients of the autograd.Function against
``jax.grad`` of the reference entry point, with the 1-D dispatch and
with ``_BWD_2D_MIN_T`` monkeypatched to 1; bf16 heads whose rows are no
whole 16-byte units (D 36, 60 and the odd 33, the route of
``flash_fwd_mma_bf16``, ``flash_dq_mma_bf16`` and ``flash_dkv_mma_bf16``)
forward and backward. Beside them: the routes (``_fwd_route``,
``_dq_route``, ``_dkv_route``), the exact three-part bf16 split of p that
``flash_dkv_sm90`` and ``flash_dkv_mma_bf16`` run dv through, the tf32
split that ``flash_fwd_mma``, ``flash_dq_mma`` and ``flash_dkv_mma`` run
the fp32 products through (its rounding, and the three-product forward,
dq and dk/dv against the Pallas forward, the Pallas dq and the plain
dk/dv), and the variant tools' anchors.

Tolerances. fp32: o atol 3e-6 rtol 1e-5, lse atol 1e-5, dq/dk/dv atol
2e-5 rtol 1e-4 (the reference's own tests'): the sums run in another
order. bf16 (inputs, p and ds rounded at the same points on both sides,
the same K tiles): o within 1 bf16 ulp (rtol 2^-7) plus 1e-6, lse atol
1e-5; the gradients come back in bf16 through ds rounded to bf16, where
an fp32 difference in p can flip one rounding: rtol 2^-6 plus 2^-7 of
the largest value.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import theanompi_tpu.ops.pallas_attention as pa
from theanompi_tpu.ops.ring_attention import full_attention_reference as j_full
from theanompi_tpu_torch.ops import flash_attention as tfa
from theanompi_tpu_torch.ops.ring_attention import full_attention_reference as t_full


def _qkv(B, Tq, Tk, H, D, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, Tq, H, D).astype(np.float32), r.randn(B, Tk, H, D).astype(np.float32),
            r.randn(B, Tk, H, D).astype(np.float32))


def _heads_major(x):
    B, T, H, D = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, T, D))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _reference_fwd(q, k, v, causal, bq, bk, q_off, k_off, dtype=jnp.float32):
    """The Pallas forward (o, lse) at the given offsets, unpadded."""
    cfg, q3, k3, v3, _ = pa._prepare(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                     causal, None, None, bq, bk)
    o, lse = pa._fwd(cfg, q3, k3, v3, pa._as_off(q_off), pa._as_off(k_off))
    Tq = q.shape[1]
    return np.asarray(o[:, :Tq], np.float32), np.asarray(lse[:, :Tq, 0])


FWD_CASES = [
    # (B, Tq, Tk, H, D, bq, bk): the reference test's shapes, and Tq != Tk
    (2, 64, 64, 3, 32, 32, 32),   # exact multiples, several blocks
    (2, 80, 80, 3, 24, 32, 16),   # ragged T (query and key padding), ragged D
    (2, 16, 16, 3, 8, 128, 128),  # T smaller than one block
    (2, 40, 72, 2, 16, 32, 32),   # cross attention, Tq != Tk, both ragged
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,Tq,Tk,H,D,bq,bk", FWD_CASES)
def test_forward_and_lse_match_the_pallas_kernel(causal, B, Tq, Tk, H, D, bq, bk):
    q, k, v = _qkv(B, Tq, Tk, H, D, seed=Tq + D)
    want_o, want_lse = _reference_fwd(q, k, v, causal, bq, bk, 0, 0)
    got_o, got_lse = tfa.flash_fwd(*(_t(_heads_major(x)) for x in (q, k, v)), causal=causal,
                                   scale=1.0 / math.sqrt(D), block_k=bk)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=3e-6, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)


# (q_off, k_off): K/V shard behind, ahead (fully in the causal future: no
# row sees any key), partly overlapping
OFFSETS = [(64, 0), (0, 64), (32, 48)]


@pytest.mark.parametrize("q_off,k_off", OFFSETS)
def test_forward_at_global_offsets(q_off, k_off):
    B, T, H, D = 2, 48, 2, 16
    q, k, v = _qkv(B, T, T, H, D, seed=q_off + 3 * k_off)
    want_o, want_lse = _reference_fwd(q, k, v, True, 16, 16, q_off, k_off)
    got_o, got_lse = tfa.flash_fwd(*(_t(_heads_major(x)) for x in (q, k, v)), causal=True,
                                   scale=0.25, q_off=q_off, k_off=k_off, block_k=16)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=3e-6, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)
    if k_off >= q_off + T:  # every row blind: o = 0, lse the sentinel
        assert not got_o.any() and bool((got_lse <= -1e29).all())


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("q_off,k_off", [(0, 0)] + OFFSETS)
def test_dq_dkv_match_the_pallas_kernels(two_d, q_off, k_off):
    """dq and dk/dv given the same (q, k, v, dO, lse, dsum), at offsets,
    against the 1-D kernels (#8, #9) or the 2-D ones (#10, #11)."""
    B, Tq, Tk, H, D = 2, 40, 56, 2, 24
    q, k, v = _qkv(B, Tq, Tk, H, D, seed=11 + q_off)
    g = np.random.RandomState(5).randn(B * H, Tq, D).astype(np.float32)
    cfg, q3, k3, v3, _ = pa._prepare(*(jnp.asarray(x) for x in (q, k, v)), True, None, None,
                                     16, 16)
    g3 = jnp.pad(jnp.asarray(g), ((0, 0), (0, q3.shape[1] - Tq), (0, 0)))
    qo, ko = pa._as_off(q_off), pa._as_off(k_off)
    o, lse = pa._fwd(cfg, q3, k3, v3, qo, ko)
    dsum = pa._dsum_of(g3, o)
    dq_call, dkv_call = (pa._dq_call_2d, pa._dkv_call_2d) if two_d else (pa._dq_call, pa._dkv_call)
    want_dq = np.asarray(dq_call(cfg, q3, k3, v3, g3, lse, dsum, qo, ko))[:, :Tq]
    want_dk, want_dv = (np.asarray(a)[:, :Tk] for a in dkv_call(cfg, q3, g3, lse, dsum, k3, v3,
                                                                 qo, ko))
    args = [_t(_heads_major(x)) for x in (q, k, v)] + [
        _t(g), _t(np.asarray(lse)[:, :Tq, 0]), _t(np.asarray(dsum)[:, :Tq, 0])]
    kw = dict(causal=True, scale=cfg.scale, q_off=q_off, k_off=k_off)
    got_dq = tfa.flash_dq(*args, **kw)
    got_dk, got_dv = tfa.flash_dkv(*args, **kw)
    for name, a, b in (("dq", got_dq, want_dq), ("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=1e-4, err_msg=name)


def _loss_weights(D):
    return 1.0 + np.arange(D, dtype=np.float32)


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad_of_the_reference(causal, two_d, monkeypatch):
    """The autograd.Function's gradients against ``jax.grad`` through the
    reference's custom VJP, with its 1-D or its 2-D backward dispatch."""
    if two_d:
        monkeypatch.setattr(pa, "_BWD_2D_MIN_T", 1)
    B, T, H, D = 2, 48, 2, 24
    q, k, v = _qkv(B, T, T, H, D, seed=7)
    w = _loss_weights(D)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(pa.flash_attention(q, k, v, causal=causal, block_q=16,
                                                  block_k=16)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=16, block_k=16)
    torch.sum(torch.sin(out) * torch.from_numpy(w)).backward()
    for name, a, b in (("dq", tq.grad, want[0]), ("dk", tk.grad, want[1]),
                       ("dv", tv.grad, want[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-4,
                                   err_msg=f"{name} causal={causal} 2d={two_d}")


def test_bf16_forward_and_gradients():
    """bf16 in, bf16 out: the same cast points as the reference kernels
    (the K tile 16 on both sides, so p rounds against the same maxima)."""
    B, T, H, D = 2, 64, 2, 32
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
               for x in _qkv(B, T, T, H, D, seed=3))
    want_o, want_lse = _reference_fwd(q, k, v, True, 16, 16, 0, 0, dtype=jnp.bfloat16)
    got_o, got_lse = tfa.flash_fwd(*(_t(_heads_major(x), torch.bfloat16) for x in (q, k, v)),
                                   causal=True, scale=1.0 / math.sqrt(D), block_k=16)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)

    w = _loss_weights(D)

    def jloss(q, k, v):
        out = pa.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, block_q=16, block_k=16)
    assert out.dtype == torch.bfloat16
    torch.sum(torch.sin(out.float()) * torch.from_numpy(w)).backward()
    for name, a, b in (("dq", tq.grad, want[0]), ("dk", tk.grad, want[1]),
                       ("dv", tv.grad, want[2])):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2.0 ** -6,
                                   atol=2.0 ** -7 * np.abs(b).max(), err_msg=name)


def _bf16(x):
    """float32 numpy values rounded to bf16 (still float32 arrays)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _assert_bf16_grads(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2.0 ** -6,
                                   atol=2.0 ** -7 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [36, 60, 33])
def test_bf16_forward_and_gradients_for_heads_of_no_whole_16_byte_rows(D, causal):
    """bf16 heads that ``flash_fwd_mma_bf16`` takes on the card (D % 8 !=
    0, the odd 33 included): the forward and the gradients against the
    Pallas kernels at ``test_bf16_forward_and_gradients``' tolerances,
    ragged T (40 over K tiles of 16)."""
    B, T, H = 2, 40, 2
    q, k, v = (_bf16(x) for x in _qkv(B, T, T, H, D, seed=D + causal))
    want_o, want_lse = _reference_fwd(q, k, v, causal, 16, 16, 0, 0, dtype=jnp.bfloat16)
    got_o, got_lse = tfa.flash_fwd(*(_t(_heads_major(x), torch.bfloat16) for x in (q, k, v)),
                                   causal=causal, scale=1.0 / math.sqrt(D), block_k=16)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)

    w = _loss_weights(D)

    def jloss(q, k, v):
        out = pa.flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=16, block_k=16)
    torch.sum(torch.sin(out.float()) * torch.from_numpy(w)).backward()
    _assert_bf16_grads((tq.grad, tk.grad, tv.grad), want)


@pytest.mark.parametrize("D", [60, 33])
def test_bf16_heads_of_no_whole_16_byte_rows_at_global_offsets(D):
    """The same heads at a partly overlapping offset pair (q_off 32, k_off
    48: the first 16 rows see no key): o and lse against the Pallas
    forward, dq and dk/dv against the reference's 1-D kernels given the
    same (lse, dsum)."""
    B, T, H, q_off, k_off = 2, 48, 2, 32, 48
    q, k, v = (_bf16(x) for x in _qkv(B, T, T, H, D, seed=D))
    want_o, want_lse = _reference_fwd(q, k, v, True, 16, 16, q_off, k_off, dtype=jnp.bfloat16)
    args = [_t(_heads_major(x), torch.bfloat16) for x in (q, k, v)]
    kw = dict(causal=True, scale=1.0 / math.sqrt(D), q_off=q_off, k_off=k_off)
    got_o, got_lse = tfa.flash_fwd(*args, block_k=16, **kw)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)
    blind = k_off - q_off
    assert not got_o[:, :blind].float().any() and bool((got_lse[:, :blind] <= -1e29).all())

    g = _bf16(np.random.RandomState(D).randn(B * H, T, D).astype(np.float32))
    cfg, q3, k3, v3, _ = pa._prepare(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True,
                                     None, None, 16, 16)
    g3 = jnp.pad(jnp.asarray(g, jnp.bfloat16), ((0, 0), (0, q3.shape[1] - T), (0, 0)))
    qo, ko = pa._as_off(q_off), pa._as_off(k_off)
    o, lse = pa._fwd(cfg, q3, k3, v3, qo, ko)
    dsum = pa._dsum_of(g3, o)
    want_dq = np.asarray(pa._dq_call(cfg, q3, k3, v3, g3, lse, dsum, qo, ko), np.float32)[:, :T]
    want_dk, want_dv = (np.asarray(a, np.float32)[:, :T]
                        for a in pa._dkv_call(cfg, q3, g3, lse, dsum, k3, v3, qo, ko))
    rows = [_t(np.asarray(lse)[:, :T, 0]), _t(np.asarray(dsum)[:, :T, 0])]
    got_dq = tfa.flash_dq(*args, _t(g, torch.bfloat16), *rows, **kw)
    got_dk, got_dv = tfa.flash_dkv(*args, _t(g, torch.bfloat16), *rows, **kw)
    _assert_bf16_grads(tuple(x.to(torch.bfloat16) for x in (got_dq, got_dk, got_dv)),
                       (want_dq, want_dk, want_dv))


@pytest.mark.parametrize("causal", [False, True])
def test_highest_precision_and_the_oracle(causal):
    """``precision="highest"`` upcasts bf16 inputs to fp32 and returns
    bf16; the plain oracle (``full_attention_reference``) matches the
    reference's with Tq != Tk."""
    q, k, v = _qkv(2, 40, 72, 2, 16, seed=0)
    for fn_t, fn_j, kw in ((tfa.flash_attention, pa.flash_attention,
                            dict(precision="highest", block_q=32, block_k=32)),
                           (t_full, j_full, {})):
        want = fn_j(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal, **kw)
        got = fn_t(*(_t(x, torch.bfloat16) for x in (q, k, v)), causal=causal, **kw)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 40, 2, 16)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)
        want = fn_j(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, **kw)
        got = fn_t(*(_t(x) for x in (q, k, v)), causal=causal, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6, rtol=1e-5)


def test_cpu_path_counts_no_launch_and_other_devices_need_cuda():
    counters = (tfa.FLASH_FWD, tfa.FLASH_FWD_SM90, tfa.FLASH_FWD_MMA, tfa.FLASH_FWD_MMA_BF16,
                tfa.FLASH_DQ, tfa.FLASH_DQ_SM90, tfa.FLASH_DQ_MMA, tfa.FLASH_DQ_MMA_BF16,
                tfa.FLASH_DKV, tfa.FLASH_DKV_SM90, tfa.FLASH_DKV_MMA, tfa.FLASH_DKV_MMA_BF16)
    for c in counters:
        c.reset()
    for dt in (torch.float32, torch.bfloat16):
        for D in (8, 9):
            q = torch.randn(2, 16, 2, D).to(dt).requires_grad_(True)
            tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert [c.launches for c in counters] == [0] * len(counters)
    meta = torch.empty(4, 16, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(meta, meta, meta, causal=True, scale=1.0)
    rows = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dq(meta, meta, meta, meta, rows, rows, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dkv(meta, meta, meta, meta, rows, rows, causal=True, scale=1.0)
    wide = torch.empty(4, 16, 72, device="meta")
    with pytest.raises(ValueError, match="head dim 72"):
        tfa.flash_fwd(wide, wide, wide, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="tile K by 64"):
        tfa.flash_fwd(meta, meta, meta, causal=True, scale=1.0, block_k=32)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 40, "sm90"), (torch.bfloat16, 48, "sm90"),
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 36, "mma_bf16"),
    (torch.bfloat16, 60, "mma_bf16"), (torch.bfloat16, 33, "mma_bf16"),
    (torch.bfloat16, 1, "mma_bf16"), (torch.bfloat16, 63, "mma_bf16"),
    (torch.float32, 64, "mma"), (torch.float32, 40, "mma"), (torch.float32, 48, "mma"),
    (torch.float32, 30, "mma"), (torch.float32, 1, "mma"), (torch.float32, 33, "mma"),
])
def test_forward_route_is_chosen_from_dtype_and_head_dim(dtype, D, route):
    """bf16 heads whose rows are whole 16-byte units go to the TMA/wgmma
    kernel, fp32 at any head dim to the 3xTF32 mma.sync kernel, and the
    other bf16 heads, odd ones included, to the bf16 mma.sync kernel; the
    generic kernel serves no route. The route is a function of (dtype, D)
    alone, decided before any launch."""
    assert tfa._fwd_route(dtype, D) == route
    assert tfa._FWD_LAUNCH[route].__name__ == f"_launch_fwd_{route}"
    assert tfa._launch_fwd_generic not in tfa._FWD_LAUNCH.values()


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 40, "sm90"), (torch.bfloat16, 48, "sm90"),
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 36, "mma_bf16"),
    (torch.bfloat16, 60, "mma_bf16"), (torch.bfloat16, 33, "mma_bf16"),
    (torch.bfloat16, 1, "mma_bf16"), (torch.bfloat16, 63, "mma_bf16"),
    (torch.float32, 64, "mma"), (torch.float32, 40, "mma"), (torch.float32, 33, "mma"),
    (torch.float32, 1, "mma"),
])
def test_dkv_route_is_chosen_from_dtype_and_head_dim(dtype, D, route):
    """dk/dv routes as the forward does: bf16 heads of whole 16-byte rows
    to ``flash_dkv_sm90``, fp32 at any head dim (the LM's parity run) to
    ``flash_dkv_mma`` (3xTF32 on mma.sync), and other bf16 heads, odd ones
    included, to ``flash_dkv_mma_bf16`` (mma.sync bf16); the generic
    ``flash_dkv`` serves no route. The ctypes table binds each kernel's
    entry point."""
    assert tfa._dkv_route(dtype, D) == route
    assert tfa._DKV_LAUNCH[route].__name__ == f"_launch_dkv_{route}"
    assert tfa._launch_dkv_generic not in tfa._DKV_LAUNCH.values()
    assert f"tmpi_flash_dkv_{route}" in tfa._LIB.signatures


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 40, "sm90"), (torch.bfloat16, 48, "sm90"),
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 36, "mma_bf16"),
    (torch.bfloat16, 60, "mma_bf16"), (torch.float32, 64, "mma"),
    (torch.float32, 40, "mma"), (torch.bfloat16, 33, "mma_bf16"),
    (torch.float32, 33, "mma"), (torch.bfloat16, 1, "mma_bf16"),
    (torch.bfloat16, 63, "mma_bf16"),
])
def test_dq_route_is_chosen_from_dtype_and_head_dim(dtype, D, route):
    """dq routes as the forward does: bf16 heads of whole 16-byte rows to
    ``flash_dq_sm90``, other bf16 heads, odd ones included, to
    ``flash_dq_mma_bf16`` (mma.sync bf16), and fp32 (the LM's parity run)
    at any D to ``flash_dq_mma`` (3xTF32 on mma.sync). The generic
    ``flash_dq`` is on no route. The ctypes table binds each kernel's
    entry point."""
    assert tfa._dq_route(dtype, D) == route
    assert tfa._DQ_LAUNCH[route].__name__ == f"_launch_dq_{route}"
    assert tfa._launch_dq_generic not in tfa._DQ_LAUNCH.values()
    assert f"tmpi_flash_dq_{route}" in tfa._LIB.signatures


def _log_uniform_probs(n, seed):
    """fp32 values spread over [2^-100, 1]: a uniform exponent and a
    random full 24-bit significand."""
    r = np.random.RandomState(seed)
    mant = (1.0 + r.randint(0, 1 << 23, size=n) / float(1 << 23)).astype(np.float32)
    p = np.ldexp(mant, r.randint(-100, 0, size=n)).astype(np.float32)
    return torch.from_numpy(np.concatenate([p, np.float32([1.0, 2.0 ** -100, 0.0])]))


def test_three_part_bf16_split_is_exact_and_two_parts_are_not():
    """``split_bf16x3``: hi + mid + lo == p bit for bit over [2^-100, 1]
    (the sum taken in fp32, each step exact); hi + mid alone misses p."""
    p = _log_uniform_probs(200_000, seed=4)
    hi, mid, lo = tfa.split_bf16x3(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), p)
    assert torch.equal(((p - hi.float()) - mid.float()) - lo.float(), torch.zeros_like(p))
    two = hi.float() + mid.float()
    assert (two != p).float().mean().item() > 0.9
    rel = ((two - p).abs() / p.clamp_min(1e-38)).max().item()
    assert 2.0 ** -20 < rel <= 2.0 ** -17


def test_tf32_split_rounds_to_nearest_ties_away_as_cvt_rna():
    """``split_tf32x2``'s hi is ``cvt.rna.tf32.f32``: 10 stored bits (the
    low 13 cleared), to nearest, ties away from zero (where round to even
    would go the other way); lo is the remainder rounded the same way, and
    hi + lo is x within 2^-22 of |x| (2^-11 for hi alone). inf and NaN
    pass through."""
    one = 1.0
    ties = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11), one + 3 * 2.0 ** -11,
                         one + 2.0 ** -11 - 2.0 ** -23], dtype=torch.float32)
    hi, lo = tfa.split_tf32x2(ties)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one + 2 * 2.0 ** -10, one],
                        dtype=torch.float32)
    assert torch.equal(hi, want)
    assert torch.equal((hi + lo)[:3], ties[:3])  # a remainder of one bit is exact
    # against float64 arithmetic: round |x| / ulp + 1/2 down, ulp = 2^(e - 10)
    x = torch.from_numpy(np.random.RandomState(3).randn(100_000).astype(np.float32)
                         * np.float32(2.0) ** np.random.RandomState(4).randint(-60, 60, 100_000))
    hi, lo = tfa.split_tf32x2(x)
    x64 = x.double()
    ulp = torch.exp2(torch.floor(torch.log2(x64.abs())) - 10)
    ref = torch.sign(x64) * torch.floor(x64.abs() / ulp + 0.5) * ulp
    assert torch.equal(hi.double(), ref)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x64 - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x64.abs()).all()
    assert ((x64 - hi.double()).abs() / x64.abs()).max().item() > 2.0 ** -12
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0])
    hi, _ = tfa.split_tf32x2(special)
    assert torch.equal(hi[:2], special[:2]) and hi[2].isnan() and hi[3] == 0


def _dot_tf32x3(a, b):
    """A product as ``flash_fwd_mma`` forms it: lo_a hi_b + hi_a lo_b +
    hi_a hi_b, the small terms first (fp32 sums of exact tf32 products)."""
    ah, al = tfa.split_tf32x2(a)
    bh, bl = tfa.split_tf32x2(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def _dot_tf32(a, b):
    """One tf32 product: what a kernel that rounds to tf32 once computes."""
    return torch.matmul(tfa.split_tf32x2(a)[0], tfa.split_tf32x2(b)[0])


def _fwd_limit_shares(o, lse, want_o, want_lse):
    """chip_smoke's fp32 forward limits as shares (<= 1 passes): o rtol
    1e-5 + 1e-6 of max|o|, lse atol 1e-5."""
    o_x = ((np.abs(o - want_o) - 1e-5 * np.abs(want_o)).max()
           / (1e-6 * np.abs(want_o).max()))
    return o_x, np.abs(lse - want_lse).max() / 1e-5


@pytest.mark.parametrize("Tq,Tk,D,q_off,k_off", [
    (96, 200, 64, 160, 0),   # chip_smoke's "offsets q 160 k 0", at 2 heads
    (192, 192, 64, 0, 100),  # "offsets q 0 k 100": rows 0-99 see no key
    (200, 200, 40, 0, 0),    # a ragged T and head
])
def test_forward_from_three_tf32_products_meets_the_fp32_limits_and_one_does_not(
        Tq, Tk, D, q_off, k_off, monkeypatch):
    """The fp32 forward with every product taken as ``flash_fwd_mma``
    takes it (``split_tf32x2``, three tf32 products) meets the fp32 limits
    phase flash holds the kernel to, against the Pallas forward at a
    causal shape with offsets; with one tf32 product it misses the o
    limit many times over. The plain forward's own ``_dot`` is swapped
    for each (the tiling and the softmax are the kernel's)."""
    B, H = 1, 2
    q, k, v = _qkv(B, Tq, Tk, H, D, seed=Tq + k_off)
    want_o, want_lse = _reference_fwd(q, k, v, True, 64, 64, q_off, k_off)
    args = [_t(_heads_major(x)) for x in (q, k, v)]
    kw = dict(causal=True, scale=1.0 / math.sqrt(D), q_off=q_off, k_off=k_off)
    shares = {}
    for name, dot in (("tf32x3", _dot_tf32x3), ("tf32", _dot_tf32)):
        monkeypatch.setattr(tfa, "_dot", dot)
        o, lse = tfa.flash_fwd_plain(*args, **kw)
        shares[name] = _fwd_limit_shares(o.numpy(), lse.numpy(), want_o, want_lse)
    assert max(shares["tf32x3"]) <= 1, shares
    assert shares["tf32"][0] > 10, shares
    if k_off > q_off:  # the blind rows: o = 0 and the sentinel lse, as the kernel writes them
        monkeypatch.setattr(tfa, "_dot", _dot_tf32x3)
        o, lse = tfa.flash_fwd_plain(*args, **kw)
        assert not o[:, :k_off - q_off].any() and bool((lse[:, :k_off - q_off] <= -1e29).all())


def _dv_excess(got, want):
    """chip_smoke's dv limit (rtol 1e-4 + 1e-5 of the largest value) as a
    share: <= 1 passes."""
    return (((got - want).abs() - 1e-4 * want.abs()).max() / (1e-5 * want.abs().max())).item()


@pytest.mark.parametrize("D", [64, 60, 33])
def test_dv_from_the_three_part_split_meets_the_dv_limit_and_bf16_p_does_not(D):
    """dv as flash_dkv_sm90 (D 64) and flash_dkv_mma_bf16 (D 60, 33) form
    it (three bf16 products of p's parts with dO, summed in fp32) against
    ``flash_dkv_plain`` (p unrounded, an fp32 x fp32 product) at a small
    causal bf16 shape: within the fp32 dv limit chip_smoke holds the
    kernels to, while dv from bf16(p) fails it."""
    BH, T = 4, 192
    r = np.random.RandomState(6)
    q3, k3, v3, do3 = (torch.from_numpy(r.randn(BH, T, D).astype(np.float32)).to(torch.bfloat16)
                       for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    o, lse = tfa.flash_fwd_plain(q3, k3, v3, causal=True, scale=scale)
    dsum = torch.sum(do3.float() * o.float(), dim=-1)
    _, want = tfa.flash_dkv_plain(q3, k3, v3, do3, lse, dsum, causal=True, scale=scale)
    p, _ = tfa._probs_and_ds(q3, k3, v3, do3, lse, dsum, True, scale, 0, 0)
    hi, mid, lo = (tfa._dot(part.transpose(1, 2), do3) for part in tfa.split_bf16x3(p))
    assert _dv_excess((hi + mid) + lo, want) <= 1
    assert _dv_excess(hi, want) > 10


@pytest.mark.parametrize("Tq,Tk,D,q_off,k_off", [
    (96, 200, 64, 160, 0),   # chip_smoke's "offsets q 160 k 0", at 2 heads
    (192, 192, 64, 0, 100),  # "offsets q 0 k 100": rows 0-99 see no key
    (200, 200, 40, 0, 0),    # a ragged T and head
])
def test_dkv_from_three_tf32_products_meets_the_fp32_limit_and_one_does_not(
        Tq, Tk, D, q_off, k_off, monkeypatch):
    """dk and dv with every product taken as ``flash_dkv_mma`` takes it
    (S, dP, dV and dK each as three tf32 products) meet the fp32 dk/dv
    limit phase flash holds the kernel to (rtol 1e-4 + 1e-5 of the largest
    value) against ``flash_dkv_plain``, given the Pallas forward's lse at
    a causal shape with offsets; with one tf32 product they miss it. The
    plain version's own ``_dot`` is swapped for each."""
    B, H = 1, 2
    q, k, v = _qkv(B, Tq, Tk, H, D, seed=Tq + k_off + 1)
    g = np.random.RandomState(D + q_off).randn(B * H, Tq, D).astype(np.float32)
    o, lse = _reference_fwd(q, k, v, True, 64, 64, q_off, k_off)
    args = [_t(_heads_major(x)) for x in (q, k, v)] + [
        _t(g), _t(lse), _t(np.sum(g * o, axis=-1))]
    kw = dict(causal=True, scale=1.0 / math.sqrt(D), q_off=q_off, k_off=k_off)
    want = tfa.flash_dkv_plain(*args, **kw)
    shares = {}
    for name, dot in (("tf32x3", _dot_tf32x3), ("tf32", _dot_tf32)):
        monkeypatch.setattr(tfa, "_dot", dot)
        got = tfa.flash_dkv_plain(*args, **kw)
        shares[name] = [_dv_excess(a, b) for a, b in zip(got, want)]
    assert max(shares["tf32x3"]) <= 1, shares
    assert min(shares["tf32"]) > 10, shares
    if k_off > q_off:  # keys no query sees: dk = dv = 0
        seen = q_off + Tq - k_off
        assert not want[0][:, seen:].any() and not want[1][:, seen:].any()


@pytest.mark.parametrize("Tq,Tk,D,q_off,k_off", [
    (96, 200, 64, 160, 0),   # chip_smoke's "offsets q 160 k 0", at 2 heads
    (192, 192, 64, 0, 100),  # "offsets q 0 k 100": rows 0-99 see no key
    (200, 200, 40, 0, 0),    # a ragged T and head
])
def test_dq_from_three_tf32_products_meets_the_fp32_limit_and_one_does_not(
        Tq, Tk, D, q_off, k_off, monkeypatch):
    """dq with every product taken as ``flash_dq_mma`` takes it (S, dP and
    dQ each as three tf32 products) meets the fp32 dq limit phase flash
    holds the kernel to (rtol 1e-4 + 1e-5 of the largest value) against
    the Pallas dq kernel (``_dq_call``, interpret mode) at a causal shape
    with offsets, given the Pallas forward's lse; with one tf32 product
    it misses it. The plain version's own ``_dot`` is swapped for each."""
    B, H = 1, 2
    q, k, v = _qkv(B, Tq, Tk, H, D, seed=Tq + k_off + 2)
    g = np.random.RandomState(D + q_off + 1).randn(B * H, Tq, D).astype(np.float32)
    cfg, q3, k3, v3, _ = pa._prepare(*(jnp.asarray(x) for x in (q, k, v)), True, None, None,
                                     64, 64)
    g3 = jnp.pad(jnp.asarray(g), ((0, 0), (0, q3.shape[1] - Tq), (0, 0)))
    qo, ko = pa._as_off(q_off), pa._as_off(k_off)
    o, lse = pa._fwd(cfg, q3, k3, v3, qo, ko)
    dsum = pa._dsum_of(g3, o)
    want = _t(np.asarray(pa._dq_call(cfg, q3, k3, v3, g3, lse, dsum, qo, ko))[:, :Tq])
    args = [_t(_heads_major(x)) for x in (q, k, v)] + [
        _t(g), _t(np.asarray(lse)[:, :Tq, 0]), _t(np.asarray(dsum)[:, :Tq, 0])]
    kw = dict(causal=True, scale=cfg.scale, q_off=q_off, k_off=k_off)
    shares = {}
    for name, dot in (("tf32x3", _dot_tf32x3), ("tf32", _dot_tf32)):
        monkeypatch.setattr(tfa, "_dot", dot)
        shares[name] = _dv_excess(tfa.flash_dq_plain(*args, **kw), want)
    assert shares["tf32x3"] <= 1, shares
    assert shares["tf32"] > 10, shares
    if k_off > q_off:  # queries that see no key: dq = 0
        assert not want[:, :k_off - q_off].any()


def test_fwd_variants_find_their_anchors_in_the_source():
    """``tools/fwd_variants.py`` builds its variants by text edits of
    ``csrc/flash_attention.cu``: each edit's anchor must be there once."""
    from theanompi_tpu_torch.ops.kernels import CSRC_DIR
    from theanompi_tpu_torch.tools import fwd_variants

    src = (CSRC_DIR / "flash_attention.cu").read_text()
    variants = fwd_variants._variants(src)
    assert variants["base"] == [] and len(variants) == 8
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


def test_dkv_variants_find_their_anchors_in_the_source():
    """``tools/dkv_variants.py`` edits the same source for flash_dkv_sm90:
    each edit's anchor must be there once."""
    from theanompi_tpu_torch.ops.kernels import CSRC_DIR
    from theanompi_tpu_torch.tools import dkv_variants

    src = (CSRC_DIR / "flash_attention.cu").read_text()
    variants = dkv_variants._variants(src)
    assert variants["base"] == [] and len(variants) == 9
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


def test_dq_variants_find_their_anchors_in_the_source():
    """``tools/dq_variants.py`` edits the same source for flash_dq_sm90:
    each edit's anchor must be there once."""
    from theanompi_tpu_torch.ops.kernels import CSRC_DIR
    from theanompi_tpu_torch.tools import dq_variants

    src = (CSRC_DIR / "flash_attention.cu").read_text()
    variants = dq_variants._variants(src)
    assert variants["base"] == [] and len(variants) == 5
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


def test_fwd_mma_variants_find_their_anchors_in_the_source():
    """``tools/fwd_mma_variants.py`` edits the same source for
    flash_fwd_mma: each edit's anchor must be there once."""
    from theanompi_tpu_torch.ops.kernels import CSRC_DIR
    from theanompi_tpu_torch.tools import fwd_mma_variants

    src = (CSRC_DIR / "flash_attention.cu").read_text()
    variants = fwd_mma_variants._variants(src)
    assert variants["base"] == [] and len(variants) == 5
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


@pytest.mark.parametrize("tool,n", [("fwd_mma_bf16_variants", 4), ("dkv_mma_variants", 4),
                                    ("bwd_mma_bf16_variants", 15), ("dq_mma_variants", 6)])
def test_mma_variants_of_this_slice_find_their_anchors_in_the_source(tool, n):
    """``tools/fwd_mma_bf16_variants.py``, ``tools/dkv_mma_variants.py``,
    ``tools/bwd_mma_bf16_variants.py`` and ``tools/dq_mma_variants.py``
    edit the same source for flash_fwd_mma_bf16, flash_dkv_mma, the bf16
    mma.sync backward and flash_dq_mma: each edit's anchor must be there
    once."""
    import importlib

    from theanompi_tpu_torch.ops.kernels import CSRC_DIR

    src = (CSRC_DIR / "flash_attention.cu").read_text()
    variants = importlib.import_module(f"theanompi_tpu_torch.tools.{tool}")._variants(src)
    assert variants["base"] == [] and len(variants) == n
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name
