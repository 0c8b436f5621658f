"""The input feed's step side against the reference: the normalized input
(``train.make_input_transform``) bit for bit against the reference's
``input_transform``; AlexNet's train step on uint8 batches following the
reference's trajectory at ``tests/test_torch_train.py``'s tolerances
(losses rtol 1e-5; params and velocities atol 1e-6 + rtol 1e-4 after 3
steps, fp32 compute, dropout off); the 10-view eval step's metrics; and
the CLI end to end on the CPU with ``--dataset imagenet_synthetic`` and
over ImageNet shards with 10-crop validation."""

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

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.train import init_train_state as j_init_state
from theanompi_tpu.train import make_eval_step as j_eval_step
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.data.imagenet import write_shards
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import make_eval_step as t_eval_step
from theanompi_tpu_torch.train import make_input_transform
from theanompi_tpu_torch.train import make_train_step as t_train_step
from theanompi_tpu_torch.train import view_mean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
SIDE = 67
SCALE = float(np.float32(1.0 / 58.0))


def _means():
    r = np.random.RandomState(11)
    return {"scalar": np.float32(127.5), "channel": (r.rand(3) * 255).astype(np.float32),
            "plane": (r.rand(SIDE, SIDE, 3) * 255).astype(np.float32)}


def _reference_transform(spec):
    """The reference's closure (theanompi_tpu/launch/worker.py:611-616)."""
    mean_c = jnp.asarray(spec["mean"], jnp.float32)
    scale_c = jnp.float32(spec["scale"])

    def input_transform(x):
        return (x.astype(jnp.float32) - mean_c) * scale_c

    return input_transform


def _u8(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, SIDE, SIDE, 3)).astype(np.uint8)


@pytest.mark.parametrize("mean", ["scalar", "channel", "plane"])
def test_normalized_input_is_the_references_bit_for_bit(mean):
    spec = {"mean": _means()[mean], "scale": SCALE}
    x = _u8(8, 0)
    got = make_input_transform(spec, "cpu")(torch.from_numpy(x))
    want = np.asarray(jax.jit(_reference_transform(spec))(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert make_input_transform(None, "cpu") is None


class JAlexNetNoDropout(JAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, jnn.Dropout):
                layer.rate = 0.0
        return net


class TAlexNetNoDropout(TAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, tnn.Dropout):
                layer.rate = 0.0
        return net


def _models():
    small = dict(input_shape=(SIDE, SIDE, 3), num_classes=10, batch_size=BATCH)
    jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(compute_dtype=jnp.float32, **small))
    tm = TAlexNetNoDropout(TAlexNet.default_recipe().replace(compute_dtype=torch.float32, **small))
    return jm, tm


def _states(jm, tm):
    jstate = j_init_state(jm, jax.random.PRNGKey(0))
    tstate = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    tstate = TrainState(
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)), {},
        bridge.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state)),
        tstate.step)
    return jstate, tstate


@pytest.mark.parametrize("fused,mean", [(True, "scalar"), (False, "channel"), (True, "plane")])
def test_uint8_steps_match_reference_trajectory(fused, mean):
    spec = {"mean": _means()[mean], "scale": SCALE}
    jm, tm = _models()
    jstate, tstate = _states(jm, tm)
    jstep = jax.jit(j_train_step(jm, fused_update=fused, input_transform=_reference_transform(spec)))
    tstep = t_train_step(tm, fused_update=fused, input_transform=make_input_transform(spec, "cpu"))
    r = np.random.RandomState(1)
    for i in range(3):
        x, y = _u8(BATCH, 10 + i), r.randint(0, 10, BATCH).astype(np.int32)
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        tstate, tmet = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y), None)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
    tp = bridge.params_to_jax(tstate.params)
    tv = bridge.opt_state_to_jax(tstate.opt_state)
    for got, ref in ((tp, jstate.params), (tv, jstate.opt_state)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("views", [1, 10])
def test_eval_step_views_match_reference(views):
    spec = {"mean": _means()["channel"], "scale": SCALE}
    jm, tm = _models()
    jstate, tstate = _states(jm, tm)
    x = _u8(BATCH * views, 3)
    y = np.random.RandomState(4).randint(0, 10, BATCH).astype(np.int32)
    jm_ = jax.jit(j_eval_step(jm, input_transform=_reference_transform(spec), views=views))(
        jstate, jnp.asarray(x), jnp.asarray(y))
    tm_ = t_eval_step(tm, input_transform=make_input_transform(spec, "cpu"), views=views)(
        tstate, torch.from_numpy(x), torch.from_numpy(y))
    assert set(tm_) == set(jm_) == {"loss", "error", "top5_error"}
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5)
    for k in ("error", "top5_error"):
        assert float(tm_[k]) == float(jm_[k]), k


def test_view_mean_averages_view_major_rows():
    logits = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(20, 3)
    got = view_mean(logits, 10)
    want = logits.reshape(2, 10, 3).double().mean(1).float()
    assert got.shape == (2, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert view_mean(logits.bfloat16(), 10).dtype == torch.bfloat16


def _cli(*extra):
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "alexnet", "AlexNet",
           "--fused-update", "--device", "cpu", "--max-steps", "2", "--batch-size", "4",
           "--print-freq", "1", "--recipe-arg", f"input_shape=[{SIDE},{SIDE},3]", *extra]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _check_summary(summary, dataset, views):
    assert summary["steps"] == 2 and summary["device_steps"] == 2
    assert summary["device"] == "cpu" and summary["dataset"] == dataset
    assert summary["device_normalize"] is True and summary["eval_views"] == views
    assert len(summary["losses"]) == 2 and all(math.isfinite(v) for v in summary["losses"])
    assert summary["nonfinite_steps"] == 0
    assert set(summary["val"]) == {"loss", "error", "top5_error"}
    assert all(math.isfinite(v) for v in summary["val"].values())
    calls = summary["native_calls_per_rank"][0]
    assert calls["tmpi_gather_rows"] >= 2
    return calls


def test_cli_imagenet_synthetic_end_to_end_on_cpu():
    summary = _cli("--dataset", "imagenet_synthetic", "--recipe-arg", "num_classes=10",
                   "--dataset-arg", "n_train=8", "--dataset-arg", "n_val=4")
    _check_summary(summary, "imagenet_synthetic", 1)


def test_cli_imagenet_shards_ten_crop_end_to_end_on_cpu(tmp_path):
    r = np.random.RandomState(0)
    write_shards(str(tmp_path), "train", r.randint(0, 256, (16, 80, 80, 3)).astype(np.uint8),
                 r.randint(0, 1000, 16), shard_size=8)
    write_shards(str(tmp_path), "val", r.randint(0, 256, (4, 80, 80, 3)).astype(np.uint8),
                 r.randint(0, 1000, 4), shard_size=4)
    summary = _cli("--dataset", "imagenet", "--dataset-arg", f"root={tmp_path}",
                   "--dataset-arg", f"crop={SIDE}", "--dataset-arg", "val_crops=10")
    calls = _check_summary(summary, "imagenet", 10)
    assert calls["tmpi_crop_mirror_u8"] >= 2


def test_cli_refuses_synthetic_with_another_dataset():
    from theanompi_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["BSP", "1", "alexnet", "AlexNet", "--synthetic", "--dataset", "imagenet",
                  "--device", "cpu"])
