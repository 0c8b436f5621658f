"""The LM's one-card remainder against the JAX package, on the CPU:
per-block remat (``TransformerLM(remat=True)``: ``torch.utils.checkpoint``
without reentry, the reference's ``jax.checkpoint(block)``), the chunked
loss (``chunked_nll``, the reference's ``transformer.py::chunked_nll``)
and the ``TransformerLM_350M`` recipe.

- A 2-layer LM with remat on, port against reference (the reference's
  Pallas flash kernels in interpret mode, the port's plain versions), at
  the tolerances of ``tests/test_torch_lm.py``: fp32 loss rtol 1e-5,
  gradients rtol 1e-4 atol 1e-6 of the leaf's largest; bf16 (weights at
  a trained scale) loss rtol 1e-5, gradients |error| <= 2^-6 |g| + 2^-7
  max|g| and mean |error| <= 2^-7 mean|g|.
- The port's remat against its own run without remat, bit for bit (the
  recompute runs the same ops in the same order), fp32 and bf16; the
  forward kernel's wrapper is called twice a layer in a train step with
  remat and once without, dq and dk/dv once a layer either way.
- ``chunked_nll`` against ``softmax_nll`` on the full logits (the
  reference's equality test: loss rtol 1e-6, gradients atol 1e-6), the
  port's chunked loss against the reference's (rtol 1e-5 / the fp32
  gradient limits above), and a chunk that does not divide T refused.
- ``TransformerLM_350M``'s recipe field by field against the reference's,
  its zoo entry as the reference's, and the CLI on it at a tiny width: remat's losses equal to the same
  run without remat (the 136M class) bit for bit.
"""

import dataclasses
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

from theanompi_tpu.models import lm as jlm
from theanompi_tpu.models.zoo import zoo_entry as j_zoo_entry
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.launch.session import resolve_model
from theanompi_tpu_torch.models import lm as tlm
from theanompi_tpu_torch.models import transformer as ttr
from theanompi_tpu_torch.models.zoo import zoo_entry
from theanompi_tpu_torch.ops import flash_attention as fa
from theanompi_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_shape=(64,), num_classes=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            batch_size=4, sched_kwargs={"lr": 1e-3})


def _archs(dtype="float32", **kw):
    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(
        attn="flash", compute_dtype=getattr(jnp, dtype), **TINY))
    tm = tlm.TransformerLMModel(tlm.TransformerLMModel.default_recipe().replace(
        attn="flash", compute_dtype=getattr(torch, dtype), **TINY))
    return jm.arch._replace(**kw), dataclasses.replace(tm.arch, **kw)


def _trained_scale_params(seed):
    """TINY params at a trained scale (unit embeddings, fan-in-scaled
    matrices, gains near 1): at the N(0, 0.02) init the loss is ln V for
    any weights."""
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


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, TINY["num_classes"], (4, 64)).astype(np.int32)


def _ref_loss_and_grads(jarch, jp, tokens):
    loss, grads = jax.value_and_grad(lambda p: jarch.loss(p, jnp.asarray(tokens), None))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _port_loss_and_grads(tarch, jp, tokens):
    tp = bridge.params_from_jax(jp)
    loss = tarch.loss(tp, torch.from_numpy(tokens))
    loss.backward()
    return loss, [t.grad for t in tree_leaves(tp)]


def _check_fp32_grads(tg, jg):
    for a, b in zip(tg, jg):
        a = a.numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_the_reference(dtype):
    jarch, tarch = _archs(dtype, remat=True)
    jp = _trained_scale_params(1)
    tokens = _tokens(2)
    jloss, jg = _ref_loss_and_grads(jarch, jp, tokens)
    tloss, tg = _port_loss_and_grads(tarch, jp, tokens)
    assert abs(jloss - math.log(TINY["num_classes"])) > 0.5  # far from ln V
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-5)
    if dtype == "float32":
        _check_fp32_grads(tg, jg)
        return
    for a, b in zip(tg, jg):
        a = a.numpy()
        np.testing.assert_allclose(a, b, rtol=2.0 ** -6, atol=2.0 ** -7 * np.abs(b).max())
        assert np.abs(a - b).mean() <= 2.0 ** -7 * np.abs(b).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_equals_no_remat_bit_for_bit(dtype, monkeypatch):
    """Remat changes what is kept, never a value: loss and every gradient
    identical; the forward kernel's wrapper runs twice a layer (the
    recompute), the backward's once a layer."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fa, "flash_fwd", counted("fwd", fa.flash_fwd))
    monkeypatch.setattr(fa, "flash_dq", counted("dq", fa.flash_dq))
    monkeypatch.setattr(fa, "flash_dkv", counted("dkv", fa.flash_dkv))
    jp = _trained_scale_params(4)
    tokens = _tokens(5)
    out = {}
    for remat in (False, True):
        _, tarch = _archs(dtype, remat=remat)
        for k in calls:
            calls[k] = 0
        loss, grads = _port_loss_and_grads(tarch, jp, tokens)
        out[remat] = (loss, grads)
        L = TINY["n_layers"]
        assert calls == {"fwd": L * (2 if remat else 1), "dq": L, "dkv": L}, (remat, calls)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert l0.dtype == l1.dtype and torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    # under no_grad (validation) remat is off: one forward a layer
    _, tarch = _archs(dtype, remat=True)
    calls["fwd"] = 0
    with torch.no_grad():
        tarch.forward(bridge.params_from_jax(jp), torch.from_numpy(tokens))
    assert calls["fwd"] == TINY["n_layers"]


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_loss_matches_full_and_the_reference(chunk):
    """The reference's equality test (``tests/test_transformer_sp.py::
    test_chunked_loss_matches_full``) in the port, and the port's chunked
    loss against the reference's chunked loss."""
    jarch, tarch = _archs()
    jp = _trained_scale_params(6)
    tokens = _tokens(7)
    l0, g0 = _port_loss_and_grads(tarch, jp, tokens)
    tarch_c = dataclasses.replace(tarch, loss_chunk=chunk)
    l1, g1 = _port_loss_and_grads(tarch_c, jp, tokens)
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
    jloss, jg = _ref_loss_and_grads(jarch._replace(loss_chunk=chunk), jp, tokens)
    np.testing.assert_allclose(l1.item(), jloss, rtol=1e-5)
    _check_fp32_grads(g1, jg)


def test_chunked_loss_with_remat_and_bf16_matches_the_reference():
    jarch, tarch = _archs("bfloat16", remat=True, loss_chunk=16)
    jp = _trained_scale_params(8)
    tokens = _tokens(9)
    jloss, jg = _ref_loss_and_grads(jarch, jp, tokens)
    tloss, tg = _port_loss_and_grads(tarch, jp, tokens)
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-5)
    for a, b in zip(tg, jg):
        a = a.numpy()
        np.testing.assert_allclose(a, b, rtol=2.0 ** -6, atol=2.0 ** -7 * np.abs(b).max())


def test_chunk_that_does_not_divide_t_is_refused():
    _, tarch = _archs(loss_chunk=7)
    tp = bridge.params_from_jax(_trained_scale_params(0))
    with pytest.raises(ValueError, match="must divide"):
        tarch.loss(tp, torch.from_numpy(_tokens(0)))
    nll = ttr.chunked_nll(torch.zeros(2, 12, 4), torch.zeros(4, 5), 5, torch.float32)
    with pytest.raises(ValueError, match="loss_chunk=5 must divide"):
        nll(torch.zeros(2, 12, dtype=torch.int32))


def test_loss_chunk_is_refused_on_the_contract_path_as_the_reference_does():
    tm = tlm.TransformerLMModel(tlm.TransformerLMModel.default_recipe().replace(
        loss_chunk=8, **TINY))
    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(
        loss_chunk=8, **TINY))
    with pytest.raises(ValueError, match="loss_chunk"):
        jm.apply(jm.init(jax.random.PRNGKey(0))[0], {}, jnp.asarray(_tokens(0)))
    with pytest.raises(ValueError, match="loss_chunk"):
        tm.apply(tm.init(torch.Generator().manual_seed(0))[0], {}, torch.from_numpy(_tokens(0)))


def test_350m_recipe_equals_the_references_field_by_field():
    tr = tlm.TransformerLM_350M.default_recipe()
    jr = jlm.TransformerLM_350M.default_recipe()
    port_fields = [f.name for f in dataclasses.fields(tr)]
    # the reference's recipe also carries the MoE knobs, a later slice's
    assert set(f.name for f in dataclasses.fields(jr)) - set(port_fields) == {
        "n_experts", "capacity_factor", "aux_weight"}
    for name in port_fields:
        a, b = getattr(tr, name), getattr(jr, name)
        if name == "compute_dtype":
            assert a == torch.bfloat16 and jnp.dtype(b) == jnp.bfloat16
        else:
            assert a == b, name
    assert (tr.n_layers, tr.d_model, tr.n_heads, tr.d_ff, tr.input_shape, tr.num_classes,
            tr.batch_size, tr.remat, tr.attn) == (24, 1024, 16, 4096, (1024,), 32768, 8, True,
                                                  "flash")
    assert tlm.TransformerLM_350M.name == jlm.TransformerLM_350M.name == "transformer_lm_350m"
    m = tlm.TransformerLM_350M()
    assert m.arch.remat and m.arch.dtype == torch.bfloat16 and m.arch.d_model // m.arch.n_heads == 64
    # the CLI's `transformer_lm TransformerLM_350M`, and the zoo's entry as the reference's
    assert resolve_model("transformer_lm", "TransformerLM_350M") is tlm.TransformerLM_350M
    assert zoo_entry("transformer_lm_350m") == (tlm.TransformerLM_350M, 8)
    assert j_zoo_entry("transformer_lm_350m") == (jlm.TransformerLM_350M, 8)


def _cli(modelclass):
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "transformer_lm",
           modelclass, "--synthetic", "--device", "cpu", "--max-steps", "3", "--batch-size",
           "4", "--dataset-arg", "n_train=16", "--dataset-arg", "n_val=8",
           "--recipe-arg", "input_shape=[64]", "--recipe-arg", "num_classes=32",
           "--recipe-arg", "d_model=32", "--recipe-arg", "n_heads=2",
           "--recipe-arg", "n_layers=2", "--recipe-arg", "d_ff=64"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_trains_the_350m_class_with_remat_equal_to_no_remat():
    """``BSP 1 transformer_lm TransformerLM_350M`` at a tiny width: the
    remat run's losses, validation and replica digest equal those of the
    136M class at the same width (the same recipe but remat) bit for
    bit."""
    s350 = _cli("TransformerLM_350M")
    s136 = _cli("TransformerLM_136M")
    assert s350["model"] == "transformer_lm_350m" and s350["steps"] == 3
    assert all(math.isfinite(v) for v in s350["losses"])
    assert s350["losses"] == s136["losses"] and s350["val"] == s136["val"]
    assert s350["replica_digest_per_rank"] == s136["replica_digest_per_rank"]
