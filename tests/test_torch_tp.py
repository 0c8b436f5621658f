"""The port's tensor-parallel LM (``--tp``: Megatron heads, FFN and
vocabulary sharding in ``models/transformer.py``, the spec-driven sync and
``NDEngine`` over the ``(data, model, seq)`` mesh in ``parallel/nd.py``)
against the JAX package, on the CPU.

The port runs as 4 gloo ranks (``launch/session.py spawn_ranks``, the
rank functions in ``tests/torch_tp_rank_fns.py``), one spawn for every
case of the module; the reference runs under ``shard_map`` on
``conftest.py``'s 8 virtual CPU devices, its Pallas kernels in interpret
mode.

- ``_vocab_sharded_nll`` at tp 2 and 4: the value and the gradient of
  each rank's vocabulary columns against the reference's (computed the
  same way inside ``shard_map``: the gradient of the sum of every rank's
  loss, tp times the loss's own) and against the dense ``softmax_nll``
  of the whole logits (the gradient divided by tp).
- A 3-step Adam trajectory of a tiny fp32 LM (2 layers, d 32, 4 heads of
  8, d_ff 64, T 64, vocab 32, batch 4, weights at a trained scale) at
  ``--tp 4``, data 2 x tp 2 (attn ``flash``) and tp 2 x seq 2 under
  ``ring_flash`` and ``ulysses_flash``, from the same weights and
  batches as the reference's ``NDEngine`` on its ``("data", "model"[,
  "seq"])`` mesh: losses, and params, m and v gathered into the global
  layout. One more at data 2 x tp 2 with ``--wire-codec int8:ef``, its
  residuals in the reference's stacked layout ``[psum axes, *global
  shape]``.

The training loop, the CLI, checkpoints and the refusals:
``tests/test_torch_tp_loop.py``.

Tolerances (fp32), ``tests/test_torch_sp.py``'s: losses rtol 1e-5; after
3 Adam steps params and m atol 1e-6 rtol 1e-4, v atol 1e-9 rtol 1e-4 (the
einsums, the row-parallel psums and the mesh's gradient sums add in
another order in XLA and in PyTorch's CPU kernels, a few fp32 ulps a
layer). Under ``int8:ef`` m, v and the params in relative norm 1e-2, the
residuals in relative norm 5e-2 over the whole tree (a gradient element
the two packages round to neighbouring quantization levels moves by a
quantum). The vocab-sharded NLL: values rtol 1e-6 against the reference
and 1e-5 against the dense loss, gradients rtol 2e-6 atol 1e-7 (a few
fp32 ulps: the exponentials and their sums in another order).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from theanompi_tpu.models import lm as jlm
from theanompi_tpu.models.transformer import _vocab_sharded_nll as j_vocab_nll
from theanompi_tpu.parallel.nd import NDEngine as JND
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.launch.session import spawn_ranks

import torch_tp_rank_fns
from test_torch_sp import TINY, _batches, _trained_scale_params

N = 4
# (dp, tp, sp, attn)
MESHES = {"tp4": (1, 4, 1, "flash"), "dp2xtp2": (2, 2, 1, "flash"),
          "tp2xsp2 ring_flash": (1, 2, 2, "ring_flash"),
          "tp2xsp2 ulysses_flash": (1, 2, 2, "ulysses_flash")}
CODEC_RUN = "dp2xtp2 int8:ef"
RUNS = {**{k: (*v, None) for k, v in MESHES.items()}, CODEC_RUN: (2, 2, 1, "flash", "int8:ef")}
NLL_TP = (2, 4)


def _nll_inputs(seed=11, B=2, T=16, V=32):
    r = np.random.RandomState(seed)
    logits = (3 * r.randn(B, T, V)).astype(np.float32)
    return logits, r.randint(0, V, (B, T)).astype(np.int32), r.rand(B, T).astype(np.float32)


def _reference_nll(tp, logits, targets, w):
    """The reference's ``_vocab_sharded_nll`` over a ``(4 / tp, tp)``
    mesh: the loss and each device's gradient of ``sum(nll · w)``, joined
    over the model axis."""
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(N // tp, tp), ("data", "model"))

    def f(lg, t, wt):
        nll = j_vocab_nll(lg, t, "model")
        g = jax.grad(lambda x: jnp.sum(j_vocab_nll(x, t, "model") * wt))(lg)
        return nll, g

    fn = jax.shard_map(f, mesh=mesh, in_specs=(P(None, None, "model"), P(), P()),
                       out_specs=(P(), P(None, None, "model")), check_vma=False)
    nll, g = fn(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(w))
    return np.asarray(nll), np.asarray(g)


def _reference_run(label):
    """The reference's NDEngine over its mesh, 3 steps from the
    trained-scale params -> (initial Adam state, losses, state)."""
    dp, tp, sp, attn, codec = RUNS[label]
    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(attn=attn,
                                                                                **TINY))
    names = ("data", "model") + (("seq",) if sp > 1 else ())
    shape = (dp, tp) + ((sp,) if sp > 1 else ())
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(shape), names)
    eng = JND(jm, mesh, steps_per_epoch=1, dp_axis="data", tp_axis="model",
              sp_axis="seq" if sp > 1 else None, donate=False, wire_codec=codec)
    state = eng.init_state(jax.random.PRNGKey(5))
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, _trained_scale_params(3)),
                            eng.state_shardings.params)
    state = state._replace(params=params)
    opt0 = jax.tree_util.tree_map(np.asarray, state.opt_state)
    losses = []
    for tokens in _batches():
        t, _ = eng.place_batch(tokens, tokens)
        state, m = eng.train_step(state, t, t, jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return opt0, losses, jax.tree_util.tree_map(np.asarray, state)


_RUNS: dict = {}


def _results(monkeypatch):
    """Every case of the port in one spawn of 4 ranks, and the
    reference's; cached for the module."""
    if not _RUNS:
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        refs = {label: _reference_run(label) for label in RUNS}
        runs = [(label, tp, sp, dict(attn=attn, **TINY), _trained_scale_params(3),
                 refs[label][0], _batches(), codec)
                for label, (dp, tp, sp, attn, codec) in RUNS.items()]
        nll_cases = [(f"nll tp{tp}", tp, *_nll_inputs()) for tp in NLL_TP]
        ranks = spawn_ranks(torch_tp_rank_fns.parity_rank, N, (runs, nll_cases), device="cpu",
                            timeout=300)
        _RUNS.update(refs=refs, ranks=ranks)
    return _RUNS


def _global(tree, prefix):
    return dict(bridge._paths(jax.tree_util.tree_map(np.asarray, tree), prefix))


@pytest.mark.parametrize("tp", NLL_TP)
def test_vocab_sharded_nll_matches_the_reference_and_the_dense_loss(monkeypatch, tp):
    from theanompi_tpu_torch.models.transformer import softmax_nll

    import torch

    ranks = _results(monkeypatch)["ranks"]
    logits, targets, w = _nll_inputs()
    want_nll, want_g = _reference_nll(tp, logits, targets, w)
    V = logits.shape[-1] // tp
    got_g = np.zeros_like(logits)
    for r, res in enumerate(ranks):
        nll, g, t = res[f"nll tp{tp}"]
        np.testing.assert_allclose(nll, want_nll, rtol=1e-6, err_msg=f"rank {r}")
        got_g[..., t * V:(t + 1) * V] = g
    np.testing.assert_allclose(got_g, want_g, rtol=2e-6, atol=1e-7)
    # against the whole logits: the value, and the gradient of one rank's loss
    lt = torch.from_numpy(logits).requires_grad_(True)
    dense = softmax_nll(lt)(torch.from_numpy(targets))
    (dense * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ranks[0][f"nll tp{tp}"][0], dense.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(got_g / tp, lt.grad.numpy(), rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("label", list(MESHES))
def test_three_adam_steps_match_the_reference(monkeypatch, label):
    res = _results(monkeypatch)
    _, jlosses, jstate = res["refs"][label]
    ranks = [r[label] for r in res["ranks"]]
    assert abs(jlosses[0] - math.log(32)) > 0.5  # far from ln V: the weights matter
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, err_msg=f"rank {r}")
    entries = ranks[0]["entries"]
    assert int(entries[".opt_state/t"]) == int(jstate.opt_state["t"]) == 3
    for prefix, tree, atol in ((".params", jstate.params, 1e-6),
                               (".opt_state/m", jstate.opt_state["m"], 1e-6),
                               (".opt_state/v", jstate.opt_state["v"], 1e-9)):
        for k, want in _global(tree, prefix).items():
            np.testing.assert_allclose(entries[k], want, rtol=1e-4, atol=atol,
                                       err_msg=f"{label} {k}")
    _check_digests(ranks)


def _check_digests(ranks):
    """The ranks of one model index hold the same shards bit for bit;
    every rank the same replicated leaves."""
    by_t: dict = {}
    for got in ranks:
        by_t.setdefault(got["tp_index"], set()).add(got["digest"])
    assert all(len(d) == 1 for d in by_t.values()), by_t
    assert len({got["replicated_digest"] for got in ranks}) == 1


def test_the_int8_codec_with_error_feedback_matches_the_reference(monkeypatch):
    res = _results(monkeypatch)
    _, jlosses, jstate = res["refs"][CODEC_RUN]
    ranks = [r[CODEC_RUN] for r in res["ranks"]]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, err_msg=f"rank {r}")
    entries = ranks[0]["entries"]
    for prefix, tree in ((".params", jstate.params), (".opt_state/m", jstate.opt_state["m"]),
                         (".opt_state/v", jstate.opt_state["v"])):
        for k, want in _global(tree, prefix).items():
            rel = np.linalg.norm(entries[k] - want) / np.linalg.norm(want)
            assert rel < 1e-2, (k, rel)
    # the residual stacks: [4, ...] over (data, model) for the replicated
    # leaves, [2, ...] over data for the tp-sharded ones, in mesh order
    want = _global(jstate.ef, ".ef")
    assert {k: v.shape for k, v in want.items()} == {
        k: v.shape for k, v in entries.items() if k.startswith(".ef/")}
    assert entries[".ef/tok_emb"].shape[0] == 4 and entries[".ef/head"].shape[0] == 2
    got = np.concatenate([entries[k].ravel() for k in sorted(want)])
    ref = np.concatenate([want[k].ravel() for k in sorted(want)])
    assert np.count_nonzero(got) > 0.9 * got.size
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 5e-2, rel
    _check_digests(ranks)
