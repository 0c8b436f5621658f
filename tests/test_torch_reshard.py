"""Elastic resume (``utils/checkpoint.load_resharded``) against the
reference's, on the CPU with the small AlexNet of
``tests/test_torch_resume.py`` and gloo ranks: the same files go through
both packages' ``load_resharded`` onto another world. BSP 2 -> 1 and
2 -> 4 (``global`` params, ``reset`` residuals), EASGD 2 -> 4
(``worker_consensus``), GoSGD 2 -> 4 (``worker_uniform`` shares). The
``global``, ``reset`` and ``uniform`` leaves match exactly, the consensus
means within rtol 1e-6. Then ``--elastic-lr-scale linear``: a resume of
the 2-worker EASGD file on 1 rank runs at half the base LR, and its
checkpoint carries the anchor ``base_world`` 2 on."""

import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import torch

from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch.launch.session import launch_training
from theanompi_tpu_torch.utils import checkpoint as tckpt

from test_torch_ckpt_sharded import flatten, nested

SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
BSP_DATA = {"n_train": 12, "n_val": 4}
RULE_DATA = {"n_train": 16, "n_val": 8}  # 2 workers' batches of 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _common(data):
    return dict(device="cpu", fused_update=True, dataset="synthetic", dataset_kwargs=data,
                n_epochs=1, recipe_overrides=dict(compute_dtype="float32", **SMALL),
                max_steps=2, print_freq=0)


@pytest.fixture(scope="module")
def files():
    """``{rule: checkpoint path}`` of 2-rank runs of 2 steps: BSP int8:ef
    as a sharded set, EASGD as one file, GoSGD int8:ef as one file."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="tmpi-reshard-"))
    env = pytest.MonkeyPatch()
    env.setenv("OMP_NUM_THREADS", "1")  # the rank processes' intra-op threads
    try:
        out = {}
        for rule, data, kw in (
                ("bsp", BSP_DATA, dict(strategy="psum", wire_codec="int8:ef", ckpt_sharded=True)),
                ("easgd", RULE_DATA, dict(avg_freq=1)),
                ("gosgd", RULE_DATA, dict(wire_codec="int8:ef", p_push=1.0))):
            d = root / rule
            launch_training(rule, 2, "alexnet", "AlexNet", ckpt_dir=str(d), **_common(data), **kw)
            out[rule] = tckpt.latest_checkpoint(str(d), verify=True)
        out["root"] = root
        yield out
    finally:
        env.undo()
        shutil.rmtree(root, ignore_errors=True)


def _target(path, world: int, stacked: tuple, dropped: tuple = ()) -> dict:
    """The entries of the same rule on ``world`` ranks: each leaf under a
    ``stacked`` prefix with ``world`` rows, those under ``dropped`` gone."""
    flat = tckpt.load_checkpoint(path)
    out = {}
    for k, v in flat.items():
        if k.startswith("__") or k.startswith(dropped):
            continue
        shape = (world, *v.shape[1:]) if k.startswith(stacked) else v.shape
        out[k] = (shape, v.dtype)
    return out


def _both(path, target, world):
    ours, info = tckpt.load_resharded(path, target, {"shape": [world], "axes": ["data"]})
    template = nested({k: np.zeros(s, d) for k, (s, d) in target.items()})
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    ref, _, ref_info = jckpt.load_resharded(path, template, mesh)
    assert info["resharded"] and ref_info["resharded"]
    assert (info["from_world"], info["to_world"]) == (ref_info["from_world"],
                                                      ref_info["to_world"]) == (2, world)
    return ours, flatten(ref)


@pytest.mark.parametrize("world", [1, 4])
def test_bsp_reshards_as_the_reference_does(files, world):
    dropped = (".ef",) if world == 1 else ()  # one rank keeps no residuals
    target = _target(files["bsp"], world, (".ef",), dropped)
    ours, ref = _both(files["bsp"], target, world)
    assert sorted(ref) == sorted(target)
    saved = tckpt.load_checkpoint(files["bsp"])
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
        if k.startswith(".ef"):
            assert not v.any()  # reset
        else:
            np.testing.assert_array_equal(v, saved[k], err_msg=k)  # global


def test_easgd_reshards_its_workers_by_consensus(files):
    target = _target(files["easgd"], 4, (".workers", ".ef"))
    ours, ref = _both(files["easgd"], target, 4)
    saved = tckpt.load_checkpoint(files["easgd"])
    for k, v in ref.items():
        if k.startswith(".workers") and np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(ours[k], v, rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(v[3], saved[k].mean(axis=0), rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours[".workers/.step"].tolist() == [2] * 4


def test_gosgd_restarts_its_shares_uniform(files):
    target = _target(files["gosgd"], 4, (".workers", ".alpha", ".ef"))
    ours, ref = _both(files["gosgd"], target, 4)
    np.testing.assert_array_equal(ours[".alpha"], ref[".alpha"])
    assert ours[".alpha"].tolist() == [0.25] * 4 and not ours[".ef"].any()
    for k, v in ref.items():
        if np.issubdtype(v.dtype, np.floating) and k.startswith(".workers"):
            np.testing.assert_allclose(ours[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_linear_lr_scale_and_its_anchor(files, tmp_path):
    lrs = {}
    for scale in ("none", "linear"):
        d = tmp_path / scale
        shutil.copytree(os.path.dirname(files["easgd"]), d / "ckpt")
        kw = {**_common(RULE_DATA), "max_steps": 3}
        s = launch_training("easgd", 1, "alexnet", "AlexNet", ckpt_dir=str(d / "ckpt"),
                            resume=True, elastic=True, elastic_lr_scale=scale,
                            save_dir=str(d / "logs"), avg_freq=1, **kw)
        assert s["resumed_from_step"] == 2 and s["resharded_from_world"] == 2
        rows = [json.loads(line) for line in open(d / "logs" / "alexnet_easgd.jsonl")]
        lrs[scale] = [r["lr"] for r in rows if r["kind"] == "train"]
        manifest = tckpt.read_topology_manifest(s["checkpoints"][-1]["path"])
        # the anchor rides on: a later resume still scales against 2
        assert manifest["elastic"]["base_world"] == 2
        assert manifest["mesh"] == {"shape": [1], "axes": ["data"]}
    assert lrs["linear"] == [lr * 1 / 2 for lr in lrs["none"]]
