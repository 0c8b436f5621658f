"""The port's training slice as a whole against the JAX reference:
AlexNet (the real class) trained a few steps by both packages' train
steps from the same weights on the same batches, the init
distributions, the schedule's epoch unit, and the CLI end to end on the
CPU.

Trajectory tolerance (fp32 compute, dropout off): per-step losses rtol
1e-5; params and velocities after 3 steps atol 1e-6 + rtol 1e-4. The
convolutions and matmuls sum in different orders in XLA and in
PyTorch's CPU kernels (a few fp32 ulps per layer), and three steps of
momentum SGD carry those differences forward.
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

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.train import init_train_state as j_init_state
from theanompi_tpu.train import make_schedule_fn as j_schedule_fn
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import make_schedule_fn as t_schedule_fn
from theanompi_tpu_torch.train import make_train_step as t_train_step
from theanompi_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4


class JAlexNetNoDropout(JAlexNet):
    """The reference AlexNet with every Dropout rate set to 0 (its masks
    come from JAX's rbg PRNG and can never match the port's)."""

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
    small = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=BATCH)
    jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(compute_dtype=jnp.float32, **small))
    tm = TAlexNetNoDropout(TAlexNet.default_recipe().replace(compute_dtype=torch.float32, **small))
    return jm, tm


def _batches(n):
    r = np.random.RandomState(0)
    return [(r.randn(BATCH, 67, 67, 3).astype(np.float32),
             r.randint(0, 10, BATCH).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("fused,accum", [(True, 1), (False, 1), (True, 2)])
def test_alexnet_steps_match_reference(fused, accum):
    jm, tm = _models()
    jstate = j_init_state(jm, jax.random.PRNGKey(0))
    # the port starts from the reference's weights and optimizer state
    tstate = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    tstate = TrainState(
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)),
        {},
        bridge.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state)),
        tstate.step,
    )
    jstep = jax.jit(j_train_step(jm, fused_update=fused, accum_steps=accum))
    tstep = t_train_step(tm, fused_update=fused, accum_steps=accum)
    for i, (x, y) in enumerate(_batches(3)):
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        tstate, tmet = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y), None)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
    assert int(tstate.step) == int(jstate.step) == 3
    tp = bridge.params_to_jax(tstate.params)
    tv = bridge.opt_state_to_jax(tstate.opt_state)
    for got, ref in ((tp, jstate.params), (tv, jstate.opt_state)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_init_distributions_and_leaves_match_the_recipe():
    model = TAlexNet()  # full width: 227x227x3, 1000 classes
    params, _ = model.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.eval_shape(JAlexNet().init, jax.random.PRNGKey(0))[0]
    leaves = tree_leaves(params)
    assert len(leaves) == 16
    assert sum(p.numel() for p in leaves) == 60_965_224
    got = bridge.params_to_jax({k: {n: t.detach() for n, t in v.items()} for k, v in params.items()})
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jshapes)):
        assert a.shape == b.shape and a.dtype == np.float32
    w_std = {"00_conv1": 0.01, "04_conv2": 0.01, "08_conv3": 0.01, "10_conv4": 0.01,
             "12_conv5": 0.01, "16_fc6": 0.005, "19_fc7": 0.005, "22_fc8": 0.01}
    b_val = {"00_conv1": 0.0, "04_conv2": 1.0, "08_conv3": 0.0, "10_conv4": 1.0,
             "12_conv5": 1.0, "16_fc6": 1.0, "19_fc7": 1.0, "22_fc8": 0.0}
    assert sorted(params) == sorted(w_std)
    for name, std in w_std.items():
        w = params[name]["w"].detach()
        # >= 34,848 draws per leaf: the sample std is within ~0.4% (1 sigma)
        assert abs(w.std().item() / std - 1) < 0.03, name
        assert abs(w.mean().item()) < 0.05 * std, name
        assert torch.all(params[name]["b"] == b_val[name]), name
        assert params[name]["w"].requires_grad


def test_schedule_epoch_unit_matches_reference():
    jm, tm = JAlexNet(), TAlexNet()
    js, ts = j_schedule_fn(jm, steps_per_epoch=10), t_schedule_fn(tm, steps_per_epoch=10)
    for step in (0, 299, 300, 499, 500, 649, 650, 1000):
        np.testing.assert_allclose(float(ts(torch.tensor(step, dtype=torch.int32))),
                                   float(js(jnp.int32(step))), rtol=1e-7)


def test_cli_end_to_end_on_cpu():
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "alexnet", "AlexNet",
           "--synthetic", "--fused-update", "--device", "cpu", "--max-steps", "2",
           "--batch-size", "4", "--print-freq", "1",
           "--recipe-arg", "input_shape=[67,67,3]", "--recipe-arg", "num_classes=10",
           "--dataset-arg", "n_train=8", "--dataset-arg", "n_val=4"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["device_steps"] == 2
    assert summary["device"] == "cpu" and summary["fused_update"] is True
    assert len(summary["losses"]) == 2 and all(math.isfinite(v) for v in summary["losses"])
    assert summary["nonfinite_steps"] == 0
    assert set(summary["val"]) == {"loss", "error", "top5_error"}
    for key in ("epochs", "images_per_sec", "train_loop_s"):
        assert key in summary
