"""Gradient accumulation (``--accum-steps``) through the port's engine,
training loop and CLI, on the CPU.

1. ``BSPEngine(accum_steps=2)`` against the reference's
   ``make_train_step(accum_steps=2)`` over 3 steps from the same weights
   and batches (fp32, dropout off), at ``tests/test_torch_train.py``'s
   tolerance: losses rtol 1e-5; params and velocities atol 1e-6 + rtol
   1e-4 (the two packages' convolutions sum in different orders).
2. ``run_training(accum_steps=2)`` runs the engine's accumulating step:
   its final state equals, bit for bit, a loop of
   ``BSPEngine(accum_steps=2).train_step`` over the dataset's batches,
   and differs from the run without accumulation; grouped steps
   (``steps_per_dispatch``) accumulate too.
3. The CLI hands ``--accum-steps`` and ``--steps-per-dispatch`` to the
   training loop, and a CLI run on the CPU reports them; a batch that
   does not divide into the microbatches is refused.
"""

import json
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
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge, cli
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.data import get_dataset
from theanompi_tpu_torch.launch import worker
from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.parallel.bsp import BSPEngine
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.tree import digest as _digest
from theanompi_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=BATCH)
DATA = {"n_train": 12, "n_val": 4}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: runs held bit for bit against each other take
    no order of a parallel reduction from the machine's load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_engine_accumulation_matches_the_reference(fused):
    jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(compute_dtype=jnp.float32, **SMALL))
    tm = TAlexNetNoDropout(TAlexNet.default_recipe().replace(compute_dtype=torch.float32,
                                                             **SMALL))
    engine = BSPEngine(tm, 1, "cpu", fused_update=fused, accum_steps=2)
    assert engine.accum_steps == 2
    jstate = j_init_state(jm, jax.random.PRNGKey(0))
    tstate = engine.init_state(torch.Generator().manual_seed(0))
    tstate = TrainState(
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)), {},
        bridge.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state)),
        tstate.step)
    jstep = jax.jit(j_train_step(jm, fused_update=fused, accum_steps=2))
    r = np.random.RandomState(0)
    for i in range(3):
        x = r.randn(BATCH, 67, 67, 3).astype(np.float32)
        y = r.randint(0, 10, BATCH).astype(np.int32)
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        tstate, tmet = engine.train_step(tstate, torch.from_numpy(x), torch.from_numpy(y), None)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
    assert engine.get_step(tstate) == int(jstate.step) == 3
    for got, ref in ((bridge.params_to_jax(tstate.params), jstate.params),
                     (bridge.opt_state_to_jax(tstate.opt_state), jstate.opt_state)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def _train(accum_steps, steps_per_dispatch=1, max_steps=3):
    return run_training(model_cls=TAlexNet, device="cpu", fused_update=True,
                        dataset="synthetic", dataset_kwargs=DATA, n_epochs=1,
                        recipe_overrides=dict(compute_dtype=torch.float32, **SMALL),
                        max_steps=max_steps, print_freq=0, accum_steps=accum_steps,
                        steps_per_dispatch=steps_per_dispatch)


def _engine_loop(accum_steps, steps):
    """What run_training does on one rank, written out: the same
    dataset, initial weights, dropout generator and batches."""
    model = TAlexNet(TAlexNet.default_recipe().replace(compute_dtype=torch.float32, **SMALL))
    data = get_dataset("synthetic", image_shape=SMALL["input_shape"], n_classes=10, **DATA)
    engine = BSPEngine(model, 1, "cpu", steps_per_epoch=data.n_train_batches(BATCH),
                       fused_update=True, accum_steps=accum_steps)
    state = engine.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for _, (x, y) in zip(range(steps), data.train_epoch(0, BATCH, seed=0, rows=slice(0, BATCH))):
        state, _ = engine.train_step(state, torch.as_tensor(x), torch.as_tensor(y), gen)
    return _digest(tree_leaves((state.params, state.opt_state)))


def test_run_training_steps_through_the_accumulating_engine():
    two = _train(2)
    assert two["accum_steps"] == 2 and two["steps"] == 3
    assert two["replica_digest_per_rank"] == [_engine_loop(2, 3)]
    assert two["replica_digest_per_rank"] != _train(1)["replica_digest_per_rank"]
    grouped = _train(2, steps_per_dispatch=2)
    assert grouped["steps_per_dispatch"] == 2 and grouped["accum_steps"] == 2
    assert grouped["losses"] == two["losses"]
    assert grouped["replica_digest_per_rank"] == two["replica_digest_per_rank"]


def test_a_batch_that_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="accum_steps=3"):
        _train(3)


def test_cli_hands_the_flags_to_the_training_loop(monkeypatch, capsys):
    seen = {}

    def fake_run_training(**kwargs):
        seen.update(kwargs)
        return {"steps": 0}

    monkeypatch.setattr(worker, "run_training", fake_run_training)
    assert cli.main(["BSP", "1", "alexnet", "AlexNet", "--synthetic", "--device", "cpu",
                     "--accum-steps", "2", "--steps-per-dispatch", "3"]) == 0
    assert seen["accum_steps"] == 2 and seen["steps_per_dispatch"] == 3
    seen.clear()
    assert cli.main(["BSP", "1", "alexnet", "AlexNet", "--synthetic", "--device", "cpu"]) == 0
    assert seen["accum_steps"] == 1 and seen["steps_per_dispatch"] == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"steps": 0}


def test_cli_run_on_the_cpu_reports_both_flags():
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "alexnet", "AlexNet",
           "--synthetic", "--fused-update", "--device", "cpu", "--max-steps", "3",
           "--batch-size", "4", "--print-freq", "0", "--accum-steps", "2",
           "--steps-per-dispatch", "2",
           "--recipe-arg", "input_shape=[67,67,3]", "--recipe-arg", "num_classes=10",
           "--dataset-arg", "n_train=12", "--dataset-arg", "n_val=4"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["accum_steps"] == 2 and summary["steps_per_dispatch"] == 2
    assert summary["steps"] == summary["device_steps"] == 3 and len(summary["losses"]) == 3
    assert summary["captured"] is False and summary["graph"] is None
