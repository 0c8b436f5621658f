"""Checkpoint and resume through ``launch/worker.py::run_training`` and
the CLI, on the CPU.

1. k steps, then a resume to 2k, equal one uninterrupted run of 2k bit
   for bit: the per-step losses and the final checkpoint's every entry
   (params, velocities, step, each rank's dropout generator state), with
   dropout on, from a mid-epoch and from an epoch-boundary checkpoint,
   with the async writer and with synchronous saves; the state the
   resumed run loads has the digest the writer recorded. The same over
   2 gloo ranks with psum + int8:ef, residuals included.
2. Across packages, both ways: the JAX package writes at step k and the
   port resumes to 2k, and the reverse. Dropout is off there (its bits
   cannot match JAX's), and the continued run is held to the writer's
   uninterrupted run at ``tests/test_torch_train.py``'s tolerance:
   losses rtol 1e-5; params and velocities atol 1e-6 + rtol 1e-4.
3. The CLI flags end to end, a fresh start from an empty directory, the
   crash save, and a failed write that raises.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu import nn as jnn
from theanompi_tpu.launch.worker import run_training as j_run_training
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.utils.checkpoint import verify_checkpoint as j_verify
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.launch.session import launch_training, spawn_ranks
from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.parallel.bsp import BSPEngine
from theanompi_tpu_torch.utils import checkpoint as tckpt

import torch_rank_fns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
# 12 images of a batch of 4: 3 steps an epoch
DATA = {"n_train": 12, "n_val": 4}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: runs held bit for bit against each other then
    take no order of a parallel reduction from the machine's load, and
    this file's long runs hold one core of the CPU the test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


def _port(ckpt_dir, max_steps, model_cls=TAlexNet, **kw):
    return run_training(model_cls=model_cls, device="cpu", fused_update=True,
                        dataset="synthetic", dataset_kwargs=DATA, n_epochs=2,
                        recipe_overrides=dict(compute_dtype=torch.float32, **SMALL),
                        max_steps=max_steps, ckpt_dir=str(ckpt_dir), print_freq=0, **kw)


def _entries(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k not in tckpt.META_KEYS}


def _assert_files_equal(a, b):
    ea, eb = _entries(a), _entries(b)
    assert sorted(ea) == sorted(eb)
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


@pytest.mark.parametrize("k,sync", [(2, False), (3, False), (2, True), (3, True)],
                         ids=["mid-epoch-async", "boundary-async", "mid-epoch-sync",
                              "boundary-sync"])
def test_k_then_resume_to_2k_equals_2k_bit_for_bit(scratch, k, sync):
    """Dropout on (AlexNet's own): the generator state travels in the
    file. k = 2 leaves the checkpoint mid-epoch (the resumed run skips
    the 2 consumed batches), k = 3 at the epoch boundary."""
    kw = {"async_checkpoint": not sync}
    full = _port(scratch / "full", 2 * k, **kw)
    first = _port(scratch / "cut", k, **kw)
    second = _port(scratch / "cut", 2 * k, resume=True, **kw)
    assert full["steps"] == second["steps"] == 2 * k and second["device_steps"] == 2 * k
    assert second["resumed_from_step"] == k and second["resume"]["torch_rng_restored"]
    assert first["losses"] + second["losses"] == full["losses"]
    assert all(c["mode"] == ("sync" if sync else "async") for c in full["checkpoints"])
    # the state the resumed run holds is the state the writer held
    assert second["resume"]["digest"] == first["checkpoints"][-1]["digest"]
    _assert_files_equal(second["checkpoints"][-1]["path"], full["checkpoints"][-1]["path"])
    assert second["checkpoints"][-1]["digest"] == full["checkpoints"][-1]["digest"]
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(str(scratch / "cut"))) == 2 * k


def test_two_gloo_ranks_resume_with_their_residuals(scratch, monkeypatch):
    """psum + int8:ef over 2 ranks: each rank's residuals come back from
    its row of the ``.ef`` stacks, its dropout stream from its row of
    ``__torch_rng__``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def run(d, max_steps, **kw):
        return launch_training(
            "bsp", 2, "alexnet", "AlexNet", device="cpu", fused_update=True,
            strategy="psum", wire_codec="int8:ef", dataset="synthetic", dataset_kwargs=DATA,
            n_epochs=2, recipe_overrides=dict(compute_dtype="float32", **SMALL),
            max_steps=max_steps, ckpt_dir=str(scratch / d), print_freq=0, **kw)

    full = run("full", 4)
    first = run("cut", 2)
    second = run("cut", 4, resume=True)
    assert second["resumed_from_step"] == 2
    assert first["losses"] + second["losses"] == full["losses"]
    assert second["resume"]["digest"] == first["checkpoints"][-1]["digest"]
    for key in ("ef_digest_per_rank", "replica_digest_per_rank"):
        assert second[key] == full[key], key
    assert len(set(full["replica_digest_per_rank"])) == 1
    assert len(set(full["ef_digest_per_rank"])) == 2  # each rank's own residuals
    path = full["checkpoints"][-1]["path"]
    _assert_files_equal(second["checkpoints"][-1]["path"], path)
    ef = _entries(path)
    assert ef[".ef/10_conv4/w"].shape == (2, 3, 3, 192, 384)
    assert ef[tckpt.TORCH_RNG_KEY].shape[0] == 2


@pytest.mark.parametrize("steps", [(4, 4), (4, -1)], ids=["same", "one-rank-found-none"])
def test_ranks_resolving_different_checkpoints_all_raise(steps):
    """Every rank compares every rank's resolved step: a rank that would
    resume alone raises, and so do the others."""
    if steps[0] == steps[1]:
        assert spawn_ranks(torch_rank_fns.resume_step_rank, 2, (steps,), device="cpu",
                           timeout=120) == [list(steps)] * 2
    else:
        with pytest.raises(RuntimeError, match=r"resolved different checkpoint steps \[4, -1\]"):
            spawn_ranks(torch_rank_fns.resume_step_rank, 2, (steps,), device="cpu", timeout=120)


def _jax(ckpt_dir, max_steps, **kw):
    return j_run_training("bsp", JAlexNetNoDropout, devices=1, n_epochs=2, max_steps=max_steps,
                          dataset="synthetic", dataset_kwargs=DATA,
                          recipe_overrides=dict(compute_dtype=jnp.float32, **SMALL),
                          ckpt_dir=str(ckpt_dir), print_freq=0, return_recorder=True, **kw)


def _assert_trajectories_close(losses, ref_losses, path, ref_path):
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got, want = _entries(path), _entries(ref_path)
    state_keys = [k for k in want if k.startswith((".params/", ".opt_state/"))]
    assert len(state_keys) == 32 and set(state_keys) <= set(got)
    for k in state_keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(got[".step"]) == int(want[".step"])


def test_the_port_resumes_a_jax_checkpoint(scratch, capsys):
    ref = _jax(scratch / "jfull", 4)
    _jax(scratch / "x", 2)
    assert tckpt.verify_checkpoint(str(scratch / "x" / "ckpt_2.npz"))
    capsys.readouterr()
    resumed = _port(scratch / "x", 4, model_cls=TAlexNetNoDropout, resume=True)
    assert resumed["resumed_from_step"] == 2
    # a JAX file holds no torch generator state: said once, seeded afresh
    assert "dropout stream starts from the seed" in capsys.readouterr().out
    assert not resumed["resume"]["torch_rng_restored"]
    ref_losses = [r["loss"] for r in ref["recorder"].history["train"]]
    _assert_trajectories_close(resumed["losses"], ref_losses[2:],
                               resumed["checkpoints"][-1]["path"],
                               str(scratch / "jfull" / "ckpt_4.npz"))


def test_the_jax_package_resumes_a_port_checkpoint(scratch):
    ref = _port(scratch / "tfull", 4, model_cls=TAlexNetNoDropout)
    _port(scratch / "x", 2, model_cls=TAlexNetNoDropout)
    assert j_verify(str(scratch / "x" / "ckpt_2.npz"))
    resumed = _jax(scratch / "x", 4, resume=True)
    assert resumed["resumed_from_step"] == 2
    losses = [r["loss"] for r in resumed["recorder"].history["train"]]
    _assert_trajectories_close(losses, ref["losses"][2:], str(scratch / "x" / "ckpt_4.npz"),
                               ref["checkpoints"][-1]["path"])


def test_resume_from_an_empty_directory_starts_fresh(scratch):
    s = _port(scratch / "empty", 2, resume=True)
    assert s["resumed_from_step"] is None and "resume" not in s and s["steps"] == 2
    assert [c["step"] for c in s["checkpoints"]] == [2]


def test_an_exception_saves_the_last_whole_step(scratch, monkeypatch):
    def broken_eval(self, state, images, labels):
        raise RuntimeError("validation failed")

    monkeypatch.setattr(BSPEngine, "eval_step", broken_eval)
    with pytest.raises(RuntimeError, match="validation failed"):
        _port(scratch / "c", 6)
    # epoch 0's 3 steps ran; its boundary save never came, the crash save did
    assert os.listdir(scratch / "c") == ["ckpt_3.npz"]
    assert tckpt.verify_checkpoint(str(scratch / "c" / "ckpt_3.npz"))
    monkeypatch.undo()
    s = _port(scratch / "c", 4, resume=True)
    assert s["resumed_from_step"] == 3 and s["steps"] == 4


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_a_failed_write_raises(scratch, sync):
    (scratch / "file").write_text("not a directory")
    with pytest.raises(OSError):
        _port(scratch / "file" / "ckpt", 1, async_checkpoint=not sync)


def test_cli_checkpoint_and_resume_on_cpu(scratch):
    base = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "alexnet", "AlexNet",
            "--synthetic", "--fused-update", "--device", "cpu", "--batch-size", "4",
            "--recipe-arg", "input_shape=[67,67,3]", "--recipe-arg", "num_classes=10",
            "--dataset-arg", "n_train=12", "--dataset-arg", "n_val=4",
            "--ckpt-dir", str(scratch / "ckpt"), "--save-dir", str(scratch / "logs")]

    def run(*extra):
        out = subprocess.run(base + list(extra), cwd=REPO, capture_output=True, text=True,
                             timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1]), out.stdout

    first, _ = run("--max-steps", "2", "--sync-ckpt")
    assert [c["mode"] for c in first["checkpoints"]] == ["sync"]
    second, stdout = run("--max-steps", "4", "--resume", "--print-freq", "1")
    assert second["resumed_from_step"] == 2 and second["steps"] == 4
    assert [c["mode"] for c in second["checkpoints"]] == ["async", "async"]
    assert f"resumed from {scratch / 'ckpt' / 'ckpt_2.npz'} at step 2" in stdout
    assert sorted(os.listdir(scratch / "ckpt")) == ["ckpt_2.npz", "ckpt_3.npz", "ckpt_4.npz"]
    rows = [json.loads(line) for line in open(scratch / "logs" / "alexnet_bsp.jsonl")]
    assert [r["step"] for r in rows if r["kind"] == "train"] == [1, 2, 3, 4]
    assert [r["epoch"] for r in rows if r["kind"] == "epoch"] == [0, 0, 1]
    assert "[rank 0] step 4 loss=" in stdout
