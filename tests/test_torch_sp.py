"""The port's sequence-parallel LM (``parallel/nd.py`` ``NDEngine``, the SP
hooks of ``models/transformer.py``, ``--sp`` in ``launch/worker.py`` and
``cli.py``) against the JAX package, on the CPU.

The port runs as 2 or 4 gloo ranks (``launch/session.py spawn_ranks``,
the rank functions in ``tests/torch_sp_rank_fns.py``); the reference
runs under ``shard_map`` on ``conftest.py``'s 8 virtual CPU devices, its
Pallas kernels in interpret mode.

- The SP loss equals the single-device loss (the reference's
  ``test_sp_loss_matches_single_device``), and the chunked loss under SP
  equals the unchunked one (``test_chunked_loss_under_sp``).
- A 3-step Adam trajectory of a tiny fp32 LM (2 layers, d 32, 4 heads
  of 8, T 64, vocab 32, batch 4) at ``--sp 4`` and at data 2 x seq 2,
  under each of ``ring``, ``ring_flash``, ``ulysses`` and
  ``ulysses_flash``, from the same weights and batches as the
  reference's ``NDEngine`` (the engine the reference's
  ``run_training(..., sp=...)`` builds, on its ``("data", "seq")``
  mesh): losses, params and Adam's m and v. One more at data 2 x seq 2
  under ``ring_flash`` with ``--wire-codec int8:ef``.

The training loop, the CLI and the refusals: ``tests/test_torch_sp_loop.py``.

Tolerances (fp32). The weights are drawn at a trained scale (as
``tests/test_torch_lm.py``'s bf16 tests draw them): at the N(0, 0.02)
init the loss is ln V to 1e-4 whatever the gradients. Losses rtol 1e-5;
after 3 Adam steps params and m atol 1e-6 rtol 1e-4, v atol 1e-9 rtol
1e-4 (``tests/test_torch_lm.py``'s limits: the einsums and the ring's
merges sum in another order in XLA and in PyTorch's CPU kernels, a few
fp32 ulps a layer, and the mesh's gradient sum runs as one all-reduce
here against the reference's two psums). Under ``int8:ef`` a gradient
element that the two packages round to neighbouring quantization levels
moves its m and v by a quantum: m, v and the params are held in relative
norm 1e-2 there, the residuals in relative norm 5e-2 over the whole tree
(``tests/test_torch_easgd.py``'s limit; one leaf of 32 values moves by a
whole quantum's share when one value rounds to the other level). The SP losses against one device rtol
2e-5 (the reference's own limit).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from theanompi_tpu.models import lm as jlm
from theanompi_tpu.models.transformer import TransformerLM as JLM
from theanompi_tpu.parallel.nd import NDEngine as JND
from theanompi_tpu_torch.launch.session import spawn_ranks

import torch_sp_rank_fns

N = 4
TINY = dict(input_shape=(64,), num_classes=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            batch_size=4, sched_kwargs={"lr": 1e-3})
MESHES = {"sp4": (1, 4), "dp2xsp2": (2, 2)}
CODEC_RUN = ("dp2xsp2", "ring_flash", "int8:ef")


def _trained_scale_params(seed, d=32, f=64, V=32, T=64, H=4, layers=2):
    """TINY params in the reference's tree at a trained scale: unit
    embeddings, fan-in-scaled matrices, gains near 1."""
    r = np.random.RandomState(seed)

    def n(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    params = {"tok_emb": n(V, d), "pos_emb": n(T, d), "head": n(d, V, scale=d ** -0.5),
              "blocks": []}
    for _ in range(layers):
        params["blocks"].append({
            "qkv": n(d, 3, H, d // H, scale=d ** -0.5), "proj": n(H, d // H, d, scale=d ** -0.5),
            "mlp_in": n(d, f, scale=d ** -0.5), "mlp_out": n(f, d, scale=f ** -0.5),
            "ln1": 1 + n(d, scale=0.1), "ln2": 1 + n(d, scale=0.1)})
    return params


def _batches(steps=3, seed=6):
    r = np.random.RandomState(seed)
    return [r.randint(0, 32, (4, 64)).astype(np.int32) for _ in range(steps)]


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _reference_run(attn, mesh_name, codec=None):
    """The reference's NDEngine over its ("data", "seq") mesh, 3 steps
    from the trained-scale params -> (initial Adam state, losses, state)."""
    dp, sp = MESHES[mesh_name]
    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(attn=attn,
                                                                                **TINY))
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(dp, sp), ("data", "seq"))
    eng = JND(jm, mesh, steps_per_epoch=1, dp_axis="data", sp_axis="seq", donate=False,
              wire_codec=codec)
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


def _trajectories(monkeypatch):
    """Every trajectory of the port, in one spawn of 4 ranks, and the
    reference's; cached for the module."""
    if not _RUNS:
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        cases = [(m, a, None) for m in MESHES for a in torch_sp_rank_fns.SCHEMES] + [CODEC_RUN]
        refs = {c: _reference_run(c[1], c[0], c[2]) for c in cases}
        runs = [(c, MESHES[c[0]][1], dict(attn=c[1], **TINY), _trained_scale_params(3),
                 refs[c][0], _batches(), c[2]) for c in cases]
        ranks = spawn_ranks(torch_sp_rank_fns.nd_train_rank, N, (runs,), device="cpu",
                            timeout=300)
        _RUNS.update({c: (refs[c], [r[c] for r in ranks]) for c in cases})
    return _RUNS


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("attn", torch_sp_rank_fns.SCHEMES)
def test_three_adam_steps_match_the_reference(monkeypatch, mesh_name, attn):
    (_, jlosses, jstate), ranks = _trajectories(monkeypatch)[(mesh_name, attn, None)]
    assert abs(jlosses[0] - math.log(32)) > 0.5  # far from ln V: the weights matter
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, err_msg=f"rank {r}")
        assert res["t"] == int(jstate.opt_state["t"]) == 3
        for name, got, want, atol in (("params", res["params"], jstate.params, 1e-6),
                                      ("m", res["m"], jstate.opt_state["m"], 1e-6),
                                      ("v", res["v"], jstate.opt_state["v"], 1e-9)):
            for a, b in zip(_leaves(got), _leaves(want)):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol,
                                           err_msg=f"{attn} {mesh_name} {name} rank {r}")
    # every rank holds the same replica, bit for bit
    assert len({res["digest"] for res in ranks}) == 1


def test_the_int8_codec_with_error_feedback_matches_the_reference(monkeypatch):
    (_, jlosses, jstate), ranks = _trajectories(monkeypatch)[CODEC_RUN]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, err_msg=f"rank {r}")
        for name, got, want in (("params", res["params"], jstate.params),
                                ("m", res["m"], jstate.opt_state["m"]),
                                ("v", res["v"], jstate.opt_state["v"])):
            for a, b in zip(_leaves(got), _leaves(want)):
                rel = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert rel < 1e-2, (name, r, rel)
        # the reference stacks the residuals over (data, seq): row r is rank
        # r's; over the whole tree (a leaf of 32 values moves by a whole
        # quantum's share when one of them rounds to the other level)
        got = np.concatenate([a.ravel() for a in _leaves(res["ef"])])
        want = np.concatenate([b[r].ravel() for b in _leaves(jstate.ef)])
        assert np.count_nonzero(got) > 0.9 * got.size
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 5e-2, (r, rel)
    assert len({res["digest"] for res in ranks}) == 1


def test_sp_loss_matches_single_device(monkeypatch):
    """The sharded global-mean loss (boundary targets fetched by a
    ppermute, the last global position masked, sum and count psum'd)
    equals one device's, the port's and the reference's, under every
    scheme; and the chunked loss under SP equals the unchunked one."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(vocab=32, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=64)
    params = _trained_scale_params(8, layers=1)
    tokens = _batches(1, seed=9)[0][:2]
    want = float(JLM(**kw).loss(jax.tree_util.tree_map(jnp.asarray, params),
                                jnp.asarray(tokens), None))
    cases = [(a, dict(kw, attn=a), tokens) for a in torch_sp_rank_fns.SCHEMES]
    cases += [("chunked", dict(kw, attn="ring_flash", loss_chunk=8), tokens),
              # a chunk must divide the LOCAL length (16 at sp 4)
              ("chunk 32", dict(kw, attn="ring", loss_chunk=32), tokens)]
    ranks = spawn_ranks(torch_sp_rank_fns.loss_rank, N, (params, cases), device="cpu",
                        timeout=120)
    for label, *_ in cases[:-1]:
        got = [r[label] for r in ranks]
        assert len(set(got)) == 1, (label, got)  # the same loss on every rank
        np.testing.assert_allclose(got[0], want, rtol=2e-5, err_msg=label)
    np.testing.assert_allclose(ranks[0]["chunked"], ranks[0]["ring_flash"], rtol=1e-6)
    assert all(r["chunk 32"] == "loss_chunk=32 must divide the local sequence length 16"
               for r in ranks)
