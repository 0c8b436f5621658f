"""The port's transformer LM slice (``models/transformer.py``,
``models/lm.py``, ``data/lm.py``, the LM routing of ``launch/worker.py``)
against the JAX package, on the CPU.

- The bridge carries LM params across exactly, with ``qkv`` kept at the
  reference's ``[d, 3, H, hd]``.
- Forward logits, loss and error metric of the same params and tokens,
  with ``attn="flash"`` (the reference's Pallas kernels in interpret
  mode, the port's plain versions) and ``attn="ring"`` (the oracle).
- A tiny fp32 LM (2 layers, d 32, 2 heads, T 64, vocab 32, batch 4,
  Adam) trained 3 steps by both packages' train steps from the same
  weights and batches.
- The token datasets window for window, and the CLI end to end.

Tolerances (fp32): logits atol 1e-5 rtol 1e-4, losses rtol 1e-5; after
3 Adam steps, params and m atol 1e-6 rtol 1e-4, and v atol 1e-9 rtol
1e-4 (v holds squared gradients, ~1e-5 here, so 1e-6 would check
nothing). The sums of the einsums and of the attention run in another
order in XLA and in PyTorch's CPU kernels, a few fp32 ulps per layer;
Adam's m / sqrt(v) update is insensitive to a gradient's relative error
except near zero, where eps bounds it.

bf16 compute (the 136M recipe's) is held at its cast points: the casts
of ``cast_block_params``, ``_rms``'s fp32 statistics and bf16 output,
GELU rounded op by op as ``jax.nn.gelu`` rounds it in bf16, the bf16
head and the flash kernels' bf16 p. The weights are drawn at a trained
scale (unit-variance activations, logits of a few units): at the
reference's N(0, 0.02) init the logits are ~6e-3 and the loss is ln V to
within 1e-4 for any weights, so it would check nothing. Readings on this
CPU: the logits are bit-identical and the loss agrees to 1e-7; a cast
moved (ln gains in bf16, GELU rounded once, the head in fp32, p unrounded
in the attention) leaves 43-75% of the logits different and moves the
loss by 2e-5 to 2e-4 of itself. So: at most 1% of the logits differ, by
at most 2^-7 of the largest; loss rtol 1e-5. The backward rounds in other
places (PyTorch's bf16 backward ops compute in fp32 and round once, JAX's
round op by op), so gradients differ by about one bf16 ulp: per leaf,
|error| <= 2^-6 |g| + 2^-7 max|g| (reads 0.37 of that) and the mean
|error| <= 2^-7 mean|g| (reads 0.49; ln gains cast to bf16 read 1.02).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.data.lm import LMSynthetic_data as JSynthetic
from theanompi_tpu.data.lm import LMText_data as JText
from theanompi_tpu.models import lm as jlm
from theanompi_tpu.train import init_train_state as j_init_state
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.data import get_dataset
from theanompi_tpu_torch.data.lm import LMSynthetic_data as TSynthetic
from theanompi_tpu_torch.data.lm import LMText_data as TText
from theanompi_tpu_torch.models import lm as tlm
from theanompi_tpu_torch.nn.layers import PLAIN
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import make_train_step as t_train_step
from theanompi_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_shape=(64,), num_classes=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            batch_size=4, sched_kwargs={"lr": 1e-3})
TINY_ARGS = ["--recipe-arg", "input_shape=[64]", "--recipe-arg", "num_classes=32",
             "--recipe-arg", "d_model=32", "--recipe-arg", "n_heads=2",
             "--recipe-arg", "n_layers=2", "--recipe-arg", "d_ff=64"]


def _models(attn, dtype="float32"):
    """The reference's and the port's TransformerLMModel at the TINY size,
    each from its default recipe (Adam, constant lr)."""
    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(
        attn=attn, compute_dtype=getattr(jnp, dtype), **TINY))
    tm = tlm.TransformerLMModel(tlm.TransformerLMModel.default_recipe().replace(
        attn=attn, compute_dtype=getattr(torch, dtype), **TINY))
    assert jm.recipe.optimizer == tm.recipe.optimizer == "adam"
    return jm, tm


def _ref_params(jm, seed=0):
    params, _ = jm.init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(n_batches, seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(0, TINY["num_classes"], (TINY["batch_size"], 64)).astype(np.int32)
            for _ in range(n_batches)]


def test_bridge_roundtrip_keeps_the_lm_layout():
    jm, tm = _models("flash")
    jp = _ref_params(jm)
    layouts = tm.param_layouts(jp)
    assert set(tree_leaves(layouts)) == {PLAIN}
    for tp in (bridge.params_from_jax(jp, layouts=layouts), bridge.params_from_jax(jp)):
        qkv = tp["blocks"][0]["qkv"]
        assert tuple(qkv.shape) == (32, 3, 2, 16) and qkv.is_contiguous() and qkv.requires_grad
        back = bridge.params_to_jax(tp, layouts)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("attn", ["flash", "ring"])
def test_forward_loss_and_error_match_the_reference(attn):
    jm, tm = _models(attn)
    jp = _ref_params(jm, seed=1)
    tp = bridge.params_from_jax(jp)
    (tokens,) = _tokens(1, seed=2)
    jlogits, _ = jm.apply(jp, {}, jnp.asarray(tokens))
    with torch.no_grad():
        tlogits, _ = tm.apply(tp, {}, torch.from_numpy(tokens))
    assert tuple(tlogits.shape) == (4, 64, 32) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-4)
    labels = torch.from_numpy(tokens)
    np.testing.assert_allclose(float(tm.loss(tlogits, labels)),
                               float(jm.loss(jlogits, jnp.asarray(tokens))), rtol=1e-5)
    # the same mistakes; the mean of 0/1 sums in another order
    np.testing.assert_allclose(float(tm.metrics(tlogits, labels)["error"]),
                               float(jm.metrics(jlogits, jnp.asarray(tokens))["error"]), rtol=1e-6)
    with torch.no_grad():
        tloss = float(tm.arch.loss(tp, labels))
    np.testing.assert_allclose(tloss,
                               float(jm.arch.loss(jp, jnp.asarray(tokens), None)), rtol=1e-5)


def _trained_scale_params(seed):
    """TINY params in the reference's tree at a trained scale: unit
    embeddings, fan-in-scaled matrices, gains near 1."""
    r = np.random.RandomState(seed)
    d, f, V, T, H = TINY["d_model"], TINY["d_ff"], TINY["num_classes"], 64, TINY["n_heads"]

    def n(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    params = {"tok_emb": n(V, d), "pos_emb": n(T, d), "head": n(d, V, scale=d ** -0.5),
              "blocks": []}
    for _ in range(TINY["n_layers"]):
        params["blocks"].append({
            "qkv": n(d, 3, H, d // H, scale=d ** -0.5), "proj": n(H, d // H, d, scale=d ** -0.5),
            "mlp_in": n(d, f, scale=d ** -0.5), "mlp_out": n(f, d, scale=f ** -0.5),
            "ln1": 1 + n(d, scale=0.1), "ln2": 1 + n(d, scale=0.1)})
    return params


def _bf16_pair():
    jm, tm = _models("flash", "bfloat16")
    (tokens,) = _tokens(1, seed=4)
    return jm, tm, _trained_scale_params(3), tokens


def test_bf16_compute_loss_matches_the_reference():
    jm, tm, jp, tokens = _bf16_pair()
    jlogits, _ = jm.apply(jp, {}, jnp.asarray(tokens))
    jlogits = np.asarray(jlogits.astype(jnp.float32))
    with torch.no_grad():
        tlogits, _ = tm.apply(bridge.params_from_jax(jp), {}, torch.from_numpy(tokens))
    assert tlogits.dtype == torch.bfloat16
    tlogits = tlogits.float().numpy()
    jloss = float(jm.loss(jnp.asarray(jlogits, jnp.bfloat16), jnp.asarray(tokens)))
    assert abs(jloss - math.log(TINY["num_classes"])) > 1.0  # far from ln V
    assert (tlogits != jlogits).mean() <= 0.01
    np.testing.assert_allclose(tlogits, jlogits, rtol=0, atol=2.0 ** -7 * np.abs(jlogits).max())
    np.testing.assert_allclose(
        float(tm.loss(torch.from_numpy(tlogits).bfloat16(), torch.from_numpy(tokens))),
        jloss, rtol=1e-5)


def test_bf16_compute_gradients_match_the_reference():
    jm, tm, jp, tokens = _bf16_pair()
    jloss, jgrads = jax.value_and_grad(lambda p: jm.arch.loss(p, jnp.asarray(tokens), None))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    tp = bridge.params_from_jax(jp)
    tloss = tm.arch.loss(tp, torch.from_numpy(tokens))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(jgrads), tree_leaves(tp)):
        a, b = a.grad.numpy(), np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        where = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, rtol=2.0 ** -6, atol=2.0 ** -7 * np.abs(b).max(),
                                   err_msg=where)
        assert np.abs(a - b).mean() <= 2.0 ** -7 * np.abs(b).mean(), where


def test_three_adam_steps_match_the_reference():
    jm, tm = _models("flash")
    jstate = j_init_state(jm, jax.random.PRNGKey(5))
    tstate = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    tstate = TrainState(
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)),
        {},
        bridge.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state)),
        tstate.step,
    )
    jstep = jax.jit(j_train_step(jm))
    tstep = t_train_step(tm)
    for i, tokens in enumerate(_tokens(3, seed=6)):
        jstate, jmet = jstep(jstate, jnp.asarray(tokens), jnp.asarray(tokens),
                             jax.random.PRNGKey(1))
        x = torch.from_numpy(tokens)
        tstate, tmet = tstep(tstate, x, x, None)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(float(tmet["error"]), float(jmet["error"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    tp = bridge.params_to_jax(tstate.params)
    tv = bridge.opt_state_to_jax(tstate.opt_state)
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    for key, atol in (("m", 1e-6), ("v", 1e-9)):
        for a, b in zip(jax.tree_util.tree_leaves(tv[key]),
                        jax.tree_util.tree_leaves(jstate.opt_state[key])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=atol, err_msg=key)
    assert tv["t"].shape == () and int(tv["t"]) == int(jstate.opt_state["t"]) == 3


def _same_windows(t, j):
    assert t.image_shape == j.image_shape and t.n_classes == j.n_classes
    for name in ("x_train", "y_train", "x_val", "y_val"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for (tx, ty), (jx, jy) in zip(t.train_epoch(1, 4, seed=3), j.train_epoch(1, 4, seed=3)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_token_datasets_are_the_references_window_for_window(tmp_path):
    kw = dict(seq_len=32, vocab=16, n_train=12, n_val=4, seed=7)
    _same_windows(TSynthetic(**kw), JSynthetic(**kw))
    _same_windows(TText(seq_len=64), JText(seq_len=64))
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(range(256)) * 9)
    _same_windows(TText(path=str(corpus), seq_len=16), JText(path=str(corpus), seq_len=16))
    assert isinstance(get_dataset("lm_synthetic", **kw), TSynthetic)
    assert isinstance(get_dataset("lm_text", path=str(corpus), seq_len=16), TText)


def _cli(*args, n="1", env=None):
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", n, "transformer_lm",
           "TransformerLM_136M", "--synthetic", "--device", "cpu", "--max-steps", "2",
           "--batch-size", "4", "--print-freq", "1", "--dataset-arg", "n_train=16",
           "--dataset-arg", "n_val=8", *TINY_ARGS, *args]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["model"] == "transformer_lm_136m" and summary["steps"] == 2
    assert len(summary["losses"]) == 2 and all(math.isfinite(v) for v in summary["losses"])
    assert summary["nonfinite_steps"] == 0 and set(summary["val"]) == {"loss", "error"}
    return summary


def test_cli_trains_the_lm_on_cpu():
    summary = _cli()
    assert summary["device"] == "cpu" and summary["devices"] == 1
    # the CPU runs the plain versions: no kernel launched
    assert not any(summary["kernel_launches_per_rank"][0].values())


def test_cli_two_ranks_with_the_int8_codec_keep_replicas_equal():
    summary = _cli("--wire-codec", "int8:ef", n="2")
    digests = summary["replica_digest_per_rank"]
    assert len(digests) == 2 and digests[0] == digests[1]
    assert all(x > 0 for x in summary["ef_norm_per_rank"])
