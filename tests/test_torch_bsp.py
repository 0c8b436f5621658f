"""Multi-rank BSP of the port (``parallel/bsp.py`` through
``launch/session.py``) on the CPU, as gloo ranks in separate processes.

1. Four ranks of the 67x67 AlexNet (fp32, dropout off) train 3 steps
   from the reference's weights on a global batch of 8 (2 rows a rank)
   and are held against the JAX package's 4-device ``BSPEngine`` on the
   same batches, at the trajectory tolerances of
   ``tests/test_torch_train.py``: losses rtol 1e-5; params and
   velocities atol 1e-6 + rtol 1e-4 (XLA and PyTorch sum the
   convolutions in different orders). Every rank ends with the same
   params, bit for bit.
2. int8 with error feedback keeps the training where fp32 takes it: the
   port's TinyCNN over 4 ranks, 24 steps, within the reference's band
   (``tests/test_codec.py``: ``|loss - fp32| < 0.08 fp32 + 0.02``, and
   well below chance).
3. The CLI, ``BSP 2 ... --device cpu``, end to end.
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
from jax.sharding import Mesh

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.parallel.bsp import BSPEngine as JBSPEngine
from theanompi_tpu_torch.launch.session import launch_training, spawn_ranks

import torch_rank_fns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
GLOBAL_BATCH = 8


class JAlexNetNoDropout(JAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, jnn.Dropout):
                layer.rate = 0.0
        return net


def _batches(n):
    r = np.random.RandomState(0)
    return [(r.randn(GLOBAL_BATCH, 67, 67, 3).astype(np.float32),
             r.randint(0, 10, GLOBAL_BATCH).astype(np.int32)) for _ in range(n)]


def test_four_rank_bsp_matches_the_reference_engine(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(
        input_shape=(67, 67, 3), num_classes=10, batch_size=GLOBAL_BATCH,
        compute_dtype=jnp.float32))
    engine = JBSPEngine(jm, Mesh(np.array(jax.devices()[:N_RANKS]), ("data",)),
                        strategy="psum", fused_update=True)
    jstate = engine.init_state(jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    vel0 = jax.tree_util.tree_map(np.asarray, jstate.opt_state)
    batches = _batches(3)
    ranks = spawn_ranks(torch_rank_fns.bsp_rank, N_RANKS,
                        (params0, vel0, batches, "psum"),
                        device="cpu", timeout=240)
    jlosses = []
    for x, y in batches:
        jstate, m = engine.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(1))
        jlosses.append(float(m["loss"]))
    for rank, res in enumerate(ranks):
        assert res["step"] == 3
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, err_msg=f"rank {rank}")
        for got, ref in ((res["params"], jstate.params), (res["vel"], jstate.opt_state)):
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
        # replicas stay identical, bit for bit
        for a, b in zip(jax.tree_util.tree_leaves(res["params"]),
                        jax.tree_util.tree_leaves(ranks[0]["params"])):
            np.testing.assert_array_equal(a, b)


def _tiny_val_loss(**kw):
    s = launch_training(
        "bsp", N_RANKS, "torch_rank_fns", "TinyCNN", device="cpu",
        dataset="synthetic",
        dataset_kwargs={"n_train": 64, "n_val": 64, "image_shape": (16, 16, 3)},
        n_epochs=100, max_steps=24, print_freq=0, seed=11, **kw)
    assert s["steps"] == 24 and s["devices"] == N_RANKS
    return s


def test_int8_error_feedback_tracks_the_fp32_run(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dense = _tiny_val_loss()["val"]["loss"]
    s = _tiny_val_loss(wire_codec="int8:ef")
    assert s["wire_codec"] == "int8:ef"
    loss = s["val"]["loss"]
    assert loss < 0.85 * np.log(10), loss
    assert abs(loss - dense) < 0.08 * dense + 0.02, (loss, dense)


def test_cli_two_ranks_on_cpu():
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "2", "alexnet", "AlexNet",
           "--synthetic", "--fused-update", "--device", "cpu", "--max-steps", "2",
           "--batch-size", "4", "--print-freq", "1", "--strategy", "ring_int8",
           "--recipe-arg", "input_shape=[67,67,3]", "--recipe-arg", "num_classes=10",
           "--dataset-arg", "n_train=8", "--dataset-arg", "n_val=4"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["device_steps"] == 2
    assert summary["devices"] == 2 and summary["strategy"] == "ring_int8"
    assert len(summary["losses"]) == 2 and all(math.isfinite(v) for v in summary["losses"])
    assert set(summary["val"]) == {"loss", "error", "top5_error"}
    # the CPU path runs the plain versions: no kernel launched on any rank
    assert len(summary["kernel_launches_per_rank"]) == 2
    assert all(v == 0 for counts in summary["kernel_launches_per_rank"] for v in counts.values())
    # rank 0 alone prints the per-step log (the recorder's console line)
    lines = out.stdout.splitlines()
    assert sum(line.startswith("[rank 0] step 2 loss=") for line in lines) == 1
    assert not any(line.startswith("[rank 1] step") for line in lines)
