"""The port's checkpoint format (``utils/checkpoint.py``) and its
TrainState mapping (``bridge.state_entries`` / ``state_from_flat``)
against the JAX package's ``utils/checkpoint.py``.

A file written by either package loads in the other with every leaf
bit-identical after the layout mapping (conv kernels HWIO in the file,
OIHW in channels_last memory in the port), each package's
``verify_checkpoint`` accepts the other's file, and the integrity
manifest is the reference's. Values are compared, not only shapes: a
wrongly transposed square kernel (3x3x192x384 and the like) keeps its
shape. The small AlexNet of ``tests/test_torch_train.py`` (fp32) and a
two-layer ``TransformerLM`` (Adam) carry the states.
"""

import errno
import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.models import lm as jlm
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.train import init_train_state as j_init_state
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.models import lm as tlm
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.tree import tree_leaves, tree_map
from theanompi_tpu_torch.utils import checkpoint as tckpt

SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
LM_TINY = dict(input_shape=(64,), num_classes=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               batch_size=4, sched_kwargs={"lr": 1e-3})


@pytest.fixture
def scratch():
    """A directory removed when the test ends: its checkpoints take
    hundreds of MB, and pytest keeps every ``tmp_path`` of its last three
    sessions."""
    d = tempfile.mkdtemp(prefix="tmpi-test-")
    try:
        yield pathlib.Path(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _alexnet():
    jm = JAlexNet(JAlexNet.default_recipe().replace(compute_dtype=jnp.float32, **SMALL))
    tm = TAlexNet(TAlexNet.default_recipe().replace(compute_dtype=torch.float32, **SMALL))
    return jm, tm


def _lm():
    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(
        compute_dtype=jnp.float32, **LM_TINY))
    tm = tlm.TransformerLMModel(tlm.TransformerLMModel.default_recipe().replace(
        compute_dtype=torch.float32, **LM_TINY))
    assert jm.recipe.optimizer == tm.recipe.optimizer == "adam"
    return jm, tm


def _trained_jax_state(jm, lm=False, steps=2):
    """A JAX TrainState with non-trivial optimizer state: a few steps on
    seeded batches (dropout draws from a fixed key)."""
    state = j_init_state(jm, jax.random.PRNGKey(0))
    step = jax.jit(j_train_step(jm))
    r = np.random.RandomState(0)
    for _ in range(steps):
        if lm:
            x = y = r.randint(0, LM_TINY["num_classes"], (4, 64)).astype(np.int32)
        else:
            x = r.randn(4, 67, 67, 3).astype(np.float32)
            y = r.randint(0, 10, 4).astype(np.int32)
        state, _ = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
    return state


def _seeded_like(p, g):
    """Seeded values in ``p``'s shape, dtype f32 and strides (a conv
    kernel's residual is channels_last, as ``init_ef`` makes it)."""
    return torch.empty_like(p, dtype=torch.float32, requires_grad=False).copy_(
        torch.randn(p.shape, generator=g))


def _random_port_state(tm, seed=3, ef_ranks=0):
    """A port TrainState whose every float leaf holds distinct seeded
    values, and ``ef_ranks`` residual trees (the state carries the
    first)."""
    state = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in tree_leaves((state.params, state.opt_state)):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g))
    efs = [tree_map(lambda p: _seeded_like(p, g), state.params) for _ in range(ef_ranks)]
    state = state._replace(step=torch.tensor(7, dtype=torch.int32), ef=efs[0] if efs else ())
    return state, efs


def _assert_trees_equal(got, want):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) and gl
    for a, b in zip(gl, wl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_port_equal(state, want, template):
    """``state`` equals ``want`` bit for bit, with the template's dtypes,
    strides and ``requires_grad``."""
    for a, b, t in zip(tree_leaves(state), tree_leaves(want), tree_leaves(template)):
        assert a.dtype == t.dtype and a.stride() == t.stride(), (a.stride(), t.stride())
        assert a.requires_grad == t.requires_grad
        assert torch.equal(a.detach(), b.detach())


@pytest.mark.parametrize("model", ["alexnet", "lm"])
def test_a_jax_checkpoint_loads_in_the_port_bit_for_bit(scratch, model):
    jm, tm = _alexnet() if model == "alexnet" else _lm()
    jstate = _trained_jax_state(jm, lm=model == "lm")
    path = jckpt.save_checkpoint(str(scratch), jstate, int(jstate.step),
                                 rng=jax.random.PRNGKey(3))
    assert tckpt.verify_checkpoint(path)
    template = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    layouts = tm.param_layouts(template.params)
    state = bridge.state_from_flat(tckpt.load_checkpoint(path), template, layouts)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    want = TrainState(
        bridge.tree_from_jax(np_state.params, requires_grad=True, layouts=layouts),
        bridge.tree_from_jax(np_state.model_state),
        bridge.tree_from_jax(np_state.opt_state,
                             layouts=bridge._opt_layouts(template.opt_state, layouts)),
        torch.from_numpy(np.array(np_state.step)))
    _assert_port_equal(state, want, template)
    assert int(state.step) == 2
    if model == "lm":  # Adam's moments and its int32 count
        assert state.opt_state["t"].dtype == torch.int32 and int(state.opt_state["t"]) == 2


@pytest.mark.parametrize("model", ["alexnet", "lm"])
def test_a_port_checkpoint_loads_in_the_jax_package_bit_for_bit(scratch, model):
    jm, tm = _alexnet() if model == "alexnet" else _lm()
    state, _ = _random_port_state(tm)
    layouts = tm.param_layouts(state.params)
    flat = bridge.state_to_flat(state, layouts)
    path = tckpt.save_checkpoint(str(scratch), flat, 7)
    assert jckpt.verify_checkpoint(path) and tckpt.verify_checkpoint(path)
    jtemplate = j_init_state(jm, jax.random.PRNGKey(0))
    restored, rng = jckpt.load_checkpoint(path, jtemplate)
    assert rng is None  # the port writes no JAX key
    want = TrainState(
        bridge.tree_to_jax(state.params, layouts), bridge.tree_to_jax(state.model_state),
        bridge.tree_to_jax(state.opt_state, bridge._opt_layouts(state.opt_state, layouts)),
        np.array(state.step.numpy()))
    _assert_trees_equal(tuple(restored)[:4], tuple(want))
    assert int(restored.step) == 7
    # the reference's conv kernels are HWIO: a square one checked by value
    if model == "alexnet":
        np.testing.assert_array_equal(
            restored.params["10_conv4"]["w"],
            state.params["10_conv4"]["w"].detach().permute(2, 3, 1, 0).numpy())


@pytest.mark.parametrize("rank", [0, 1])
def test_the_ef_stack_crosses_packages_row_by_rank(scratch, rank):
    """``.ef/<leaf>`` is ``[n, ...]`` in the reference's layout: the JAX
    package's stack loads as row ``rank`` on rank ``rank``, and the
    port's per-rank residuals stack into the reference's template."""
    jm, tm = _alexnet()
    jstate = j_init_state(jm, jax.random.PRNGKey(0))
    r = np.random.RandomState(5)
    jef = jax.tree_util.tree_map(
        lambda p: jnp.asarray(r.randn(2, *p.shape).astype(np.float32)), jstate.params)
    jstate = jstate._replace(ef=jef)
    path = jckpt.save_checkpoint(str(scratch / "jax"), jstate, 0)
    template, _ = _random_port_state(tm, ef_ranks=1)
    layouts = tm.param_layouts(template.params)
    state = bridge.state_from_flat(tckpt.load_checkpoint(path), template, layouts,
                                   rank=rank, world=2)
    want = bridge.tree_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a)[rank], jef),
                                layouts=layouts)
    _assert_port_equal(state.ef, want, template.ef)

    # the port's two ranks -> the reference's stacked template
    pstate, efs = _random_port_state(tm, seed=9, ef_ranks=2)
    path = tckpt.save_checkpoint(str(scratch / "port"),
                                 bridge.state_to_flat(pstate, layouts, ef_ranks=efs), 0)
    restored, _ = jckpt.load_checkpoint(path, jstate)
    for a, i in zip(jax.tree_util.tree_leaves(restored.ef), range(16)):
        lay = tree_leaves(layouts)[i]
        rows = [bridge._leaf_to_jax(tree_leaves(e)[i], lay) for e in efs]
        np.testing.assert_array_equal(np.asarray(a), np.stack(rows))
    loaded = bridge.state_from_flat(tckpt.load_checkpoint(path), template, layouts,
                                    rank=rank, world=2)
    _assert_port_equal(loaded.ef, efs[rank], template.ef)


def test_the_integrity_manifest_is_the_references(scratch):
    jm, tm = _alexnet()
    state, _ = _random_port_state(tm)
    flat = bridge.state_to_flat(state, tm.param_layouts(state.params))
    flat[tckpt.TORCH_RNG_KEY] = np.arange(32, dtype=np.uint8).reshape(2, 16)
    ref = jckpt._with_integrity(dict(flat))
    assert tckpt.integrity_manifest(flat) == json.loads(str(ref["__integrity__"]))
    # and the files: the same arrays, the same embedded manifest
    tpath = tckpt.save_checkpoint(str(scratch / "t"), flat, 1, extra_meta={"a": 1})
    jpath = jckpt.save_checkpoint(str(scratch / "j"), flat, 1, extra_meta={"a": 1})
    with np.load(tpath) as t, np.load(jpath) as j:
        assert json.loads(str(t["__integrity__"])) == json.loads(str(j["__integrity__"]))
    assert tckpt.read_checkpoint_meta(tpath) == jckpt.read_checkpoint_meta(jpath) == {"a": 1}
    assert tckpt.checkpoint_step(tpath) == 1 and tckpt.checkpoint_step(None) == -1


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_a_damaged_file_fails_verify_and_discovery_walks_back(scratch, damage):
    flat = {".w": np.arange(4096, dtype=np.float32), ".step": np.array(3, np.int32)}
    for step in (1, 2, 3):
        tckpt.save_checkpoint(str(scratch), dict(flat, **{".step": np.array(step, np.int32)}),
                              step)
    newest = str(scratch / "ckpt_3.npz")
    raw = bytearray(open(newest, "rb").read())
    if damage == "truncate":
        raw = raw[:len(raw) // 2]
    else:  # one bit inside the stored .w array: the zip member's bytes
        at = raw.index(np.arange(4096, dtype=np.float32)[1000:1004].tobytes())
        raw[at] ^= 0x01
    open(newest, "wb").write(bytes(raw))
    for verify in (tckpt.verify_checkpoint, jckpt.verify_checkpoint):
        assert not verify(newest)
        assert verify(str(scratch / "ckpt_2.npz"))
    assert tckpt.latest_checkpoint(str(scratch)) == newest
    assert tckpt.latest_checkpoint(str(scratch), verify=True) == str(scratch / "ckpt_2.npz")
    assert jckpt.latest_checkpoint(str(scratch), verify=True) == str(scratch / "ckpt_2.npz")
    open(str(scratch / "ckpt_9.npz"), "wb").close()  # zero bytes: absent
    assert tckpt.latest_checkpoint(str(scratch)) == newest
    assert tckpt.latest_checkpoint(str(scratch / "none"), verify=True) is None


def test_keep_prunes_to_the_newest(scratch):
    flat = {".step": np.array(0, np.int32)}
    for step in (1, 2, 3, 4, 10):
        tckpt.save_checkpoint(str(scratch), flat, step, keep=2)
    assert sorted(os.listdir(scratch)) == ["ckpt_10.npz", "ckpt_4.npz"]
    tckpt.save_checkpoint(str(scratch), flat, 11, keep=0)  # 0 keeps every file
    assert len(os.listdir(scratch)) == 3


@pytest.mark.parametrize("fault", ["missing", "shape", "ef_world", "ef_missing"])
def test_a_mismatched_file_raises_naming_the_key(scratch, fault):
    _, tm = _alexnet()
    template, efs = _random_port_state(tm, ef_ranks=2)
    layouts = tm.param_layouts(template.params)
    flat = bridge.state_to_flat(template, layouts, ef_ranks=efs)
    key, world = ".params/10_conv4/w", 2
    if fault == "missing":
        del flat[key]
        with pytest.raises(KeyError, match="10_conv4/w"):
            bridge.state_from_flat(flat, template, layouts, rank=0, world=world)
    elif fault == "shape":
        # a square kernel's transpose keeps its shape; another kernel's doesn't
        flat[key] = flat[".params/12_conv5/w"]
        with pytest.raises(ValueError, match="10_conv4/w"):
            bridge.state_from_flat(flat, template, layouts, rank=0, world=world)
    elif fault == "ef_world":
        with pytest.raises(ValueError, match=r"\.ef/.*2 ranks; this run has 4"):
            bridge.state_from_flat(flat, template, layouts, rank=0, world=4)
        # a one-rank run keeps no residuals: a two-rank stack is refused too
        with pytest.raises(ValueError, match="this run has 1"):
            bridge.state_from_flat(flat, template._replace(ef=()), layouts)
    else:
        with pytest.raises(KeyError, match=r"\.ef/00_conv1/b"):
            bridge.state_from_flat(bridge.state_to_flat(template._replace(ef=()), layouts),
                                   template, layouts, rank=1, world=2)
    with pytest.raises(ValueError, match="every rank's"):
        bridge.state_entries(template, layouts)


def test_async_checkpointer_writes_the_sync_bits_in_step_order(scratch):
    _, tm = _lm()
    w = tckpt.AsyncCheckpointer()
    paths = []
    try:
        for step in (1, 2, 3):
            state, efs = _random_port_state(tm, seed=step, ef_ranks=2)
            layouts = tm.param_layouts(state.params)
            entries = bridge.state_entries(state, layouts, efs)
            entries[tckpt.TORCH_RNG_KEY] = np.full((2, 16), step, np.uint8)
            w.save(str(scratch / "async"), entries, step, keep=5)
            # the writer never reads live tensors: scribble over them now
            with torch.no_grad():
                for t in tree_leaves((state, efs)):
                    t.fill_(float("nan") if t.is_floating_point() else -1)
            ref, ref_efs = _random_port_state(tm, seed=step, ef_ranks=2)
            flat = bridge.state_to_flat(ref, layouts, ef_ranks=ref_efs)
            flat[tckpt.TORCH_RNG_KEY] = np.full((2, 16), step, np.uint8)
            paths.append(tckpt.save_checkpoint(str(scratch / "sync"), flat, step, keep=5))
        w.wait()
    finally:
        w.close()
    assert [r["step"] for r in w.records] == [1, 2, 3]
    assert all(r["writer_ms"] > 0 and r["loop_ms"] >= 0 and r["bytes"] > 0 for r in w.records)
    for rec, spath in zip(w.records, paths):
        with np.load(rec["path"]) as a, np.load(spath) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
            assert rec["digest"] == tckpt.manifest_digest(json.loads(str(b["__integrity__"])))


def test_async_checkpointer_surfaces_writer_errors(scratch, monkeypatch):
    entries = {".step": torch.tensor(1, dtype=torch.int32)}
    # a path under a regular file can never be written: not transient
    (scratch / "file").write_text("x")
    w = tckpt.AsyncCheckpointer()
    w.save(str(scratch / "file" / "ckpt"), entries, 1)
    with pytest.raises(OSError) as e:
        w.wait()
    assert e.value.errno in (errno.ENOTDIR, errno.EEXIST)
    # a full disk fails the attempt only: counted, logged, chain intact
    real = tckpt._atomic_savez

    def full(directory, path, flat):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(tckpt, "_atomic_savez", full)
    w.save(str(scratch / "ok"), entries, 2)
    w.wait()
    assert w.storage_failures == 1 and w.last_storage_error.errno == errno.ENOSPC
    monkeypatch.setattr(tckpt, "_atomic_savez", real)
    w.save(str(scratch / "ok"), entries, 3)
    w.close()
    assert os.listdir(scratch / "ok") == ["ckpt_3.npz"]
    assert [r["step"] for r in w.records] == [3]
