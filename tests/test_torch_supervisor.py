"""The supervisor of the port (``theanompi_tpu_torch/launch/supervisor.py``)
on the CPU, with the small AlexNet of ``tests/test_torch_resume.py`` (2
steps an epoch here) and gloo ranks:

- a supervised run with an injected crash, and one whose newest file is
  truncated before the crash (the retry walks back past it), end bit for
  bit at the uninterrupted run's final checkpoint;
- retries run out and the supervisor raises; ``ckpt_dir`` is required;
- SIGTERM grace checkpoints, leaves ``resumable.json`` and raises
  ``Preempted``; the next invocation resumes from the marker by itself
  and ends bit for bit at the uninterrupted run's final checkpoint; 2
  gloo ranks stop after the same step and save it together;
- the jittered backoff is deterministic and recorded;
- ``classify_retry_cause`` labels each exception as the reference's;
- 2 gloo ranks without ``--ckpt-sharded`` make no crash save: the retry
  resumes from the newest gathered file and ends bit for bit at the
  uninterrupted run's state; a rank's failure stops peers blocked in a
  collective after ``REPORT_GRACE``, not the save grace;
- 2 gloo ranks under ``--ckpt-sharded``: each rank's crash save completes
  one set and the retry resumes from it, bit for bit; an elastic shrink
  from 2 ranks to 1 reshards the set (params loaded bit for bit, the
  residuals dropped);
- ``enospc`` on the async writer fails that save only; the scrubber
  quarantines a bit-rotted file and leaves the writer's temporary files;
- ``supervisor.jsonl`` and ``metrics.jsonl`` pass the reference's
  ``tools/check_obs_schema.check_file``;
- the CLI end to end.
"""

import errno
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

import torch

from theanompi_tpu.launch import supervisor as jsup
from theanompi_tpu.tools.check_obs_schema import check_file
from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu.utils import faults as jfaults
import torch_rank_fns
from theanompi_tpu_torch.launch import session
from theanompi_tpu_torch.launch.session import launch_training, spawn_ranks
from theanompi_tpu_torch.launch.supervisor import classify_retry_cause, supervise_training
from theanompi_tpu_torch.utils import checkpoint as tckpt
from theanompi_tpu_torch.utils import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
# 8 images of a batch of 4: 2 steps an epoch, 6 steps in 3 epochs
DATA = {"n_train": 8, "n_val": 4}
STEPS = 6


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread (runs held bit for bit against each other
    take no reduction order from the machine's load); rank processes
    inherit OMP_NUM_THREADS."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def scratch():
    d = tempfile.mkdtemp(prefix="tmpi-test-")
    try:
        yield pathlib.Path(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _kw(ckpt_dir, n=1, **kw):
    base = dict(device="cpu", fused_update=True, dataset="synthetic", dataset_kwargs=DATA,
                n_epochs=3, recipe_overrides=dict(compute_dtype="float32", **SMALL),
                max_steps=STEPS, ckpt_dir=str(ckpt_dir), print_freq=0)
    if n > 1:
        base.update(strategy="psum", wire_codec="int8:ef")
    return {**base, **kw}


def _supervised(ckpt_dir, n=1, **kw):
    kw.setdefault("backoff_base", 0.0)
    return supervise_training("bsp", n, "alexnet", "AlexNet", **_kw(ckpt_dir, n, **kw))


def _entries(path):
    return tckpt.load_checkpoint(path)


def _assert_same_state(a, b):
    ea, eb = _entries(a), _entries(b)
    assert sorted(ea) == sorted(eb)
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


@pytest.fixture(scope="module")
def control():
    """The uninterrupted one-rank run's final checkpoint."""
    d = pathlib.Path(tempfile.mkdtemp(prefix="tmpi-control-"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = launch_training("bsp", 1, "alexnet", "AlexNet", **_kw(d / "c"))
        yield s["checkpoints"][-1]["path"]
    finally:
        torch.set_num_threads(n)
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("faults,resumed_from", [
    (["crash@4"], 3),  # the crash save at step 3, mid-epoch
    (["ckpt_truncate@4", "crash@5"], 2),  # ckpt_4 torn, no crash save: walk back to 2
], ids=["crash", "truncated-newest"])
def test_a_supervised_crash_ends_at_the_uninterrupted_state(scratch, control, faults,
                                                             resumed_from):
    obs = scratch / "obs"
    s = _supervised(scratch / "ckpt", max_retries=2, inject_faults=faults, obs_dir=str(obs))
    assert s["retries"] == 1 and s["attempts"] == 2 and s["retry_causes"] == {"crash": 1}
    assert s["resumed_from_step"] == resumed_from and s["steps"] == STEPS
    _assert_same_state(s["checkpoints"][-1]["path"], control)
    (retry,) = [json.loads(line) for line in open(obs / "supervisor.jsonl")]
    assert retry["step"] == resumed_from and retry["cause"] == "crash"
    if resumed_from == 2:
        assert os.listdir(scratch / "ckpt" / "quarantine") == ["ckpt_4.npz"]
    assert s["recovery_ms"] > 0
    for f in ("supervisor.jsonl", "metrics.jsonl"):
        assert check_file(str(obs / f)) == []


def test_retries_run_out_and_the_supervisor_raises(scratch):
    obs = scratch / "obs"
    with pytest.raises(tfaults.InjectedCrash):
        _supervised(scratch / "ckpt", max_retries=1, max_steps=2, obs_dir=str(obs),
                    inject_faults=["crash@1", "crash@2"])
    recs = [json.loads(line) for line in open(obs / "supervisor.jsonl")]
    # the first crash came before any step (the crash save holds step 0, as
    # the reference's does); the second after step 1
    assert [(r["attempt"], r["step"], r["cause"]) for r in recs] == [(1, 0, "crash"),
                                                                   (2, 1, "crash")]
    assert check_file(str(obs / "supervisor.jsonl")) == []
    assert check_file(str(obs / "metrics.jsonl")) == []


def test_max_retries_requires_a_checkpoint_directory():
    with pytest.raises(ValueError, match="requires ckpt_dir"):
        supervise_training("bsp", 1, "alexnet", "AlexNet", max_retries=1, device="cpu")


def test_sigterm_grace_marks_the_run_and_the_next_invocation_resumes(scratch, control):
    kw = dict(max_retries=1, sigterm_grace=30.0, inject_faults=["sigterm@3"],
              fault_ledger=str(scratch / "ledger"), obs_dir=str(scratch / "obs"))
    with pytest.raises(tfaults.Preempted) as e:
        _supervised(scratch / "ckpt", **kw)
    assert e.value.step == 3
    assert tckpt.read_resumable_marker(str(scratch / "ckpt"))["step"] == 3
    assert jckpt.read_resumable_marker(str(scratch / "ckpt"))["step"] == 3
    s = _supervised(scratch / "ckpt", **kw)  # no resume flag
    assert s["preempt_resumes"] == 1 and s["resumed_from_step"] == 3 and s["retries"] == 0
    assert tckpt.read_resumable_marker(str(scratch / "ckpt")) is None
    _assert_same_state(s["checkpoints"][-1]["path"], control)
    recs = [json.loads(line) for line in open(scratch / "obs" / "supervisor.jsonl")]
    assert recs[0]["resumable"] and recs[0]["cause"] == "preempt"
    assert check_file(str(scratch / "obs" / "supervisor.jsonl")) == []


def test_sigterm_on_two_ranks_stops_both_after_the_same_step(scratch):
    """Each rank gets SIGTERM before step 3; they agree at the drain after
    it (one all_reduce), save step 3 together and raise Preempted, which
    reaches the parent as Preempted; the next invocation resumes."""
    kw = dict(max_retries=1, sigterm_grace=30.0, inject_faults=["sigterm@3"],
              fault_ledger=str(scratch / "ledger"), print_freq=1)
    with pytest.raises(tfaults.Preempted) as e:
        _supervised(scratch / "ckpt", 2, **kw)
    assert e.value.step == 3
    assert tckpt.read_resumable_marker(str(scratch / "ckpt"))["step"] == 3
    assert tckpt.verify_checkpoint(str(scratch / "ckpt" / "ckpt_3.npz"))
    s = _supervised(scratch / "ckpt", 2, **kw)
    assert s["preempt_resumes"] == 1 and s["resumed_from_step"] == 3 and s["steps"] == STEPS
    assert len(set(s["replica_digest_per_rank"])) == 1


def test_jittered_backoff_is_deterministic_and_recorded(scratch):
    backoffs = []
    for run in ("a", "b"):
        obs = scratch / f"obs-{run}"
        s = _supervised(scratch / run, max_retries=2, max_steps=2, backoff_base=0.01,
                        retry_jitter=True, obs_dir=str(obs), inject_faults=["crash@1", "crash@2"])
        assert s["retries"] == 2
        backoffs.append([json.loads(line)["backoff_s"] for line in open(obs / "supervisor.jsonl")])
    assert backoffs[0] == backoffs[1]
    first, second = backoffs[0]
    assert 0.01 <= first <= 0.03 and 0.01 <= second <= max(0.01, 3 * first)


@pytest.mark.parametrize("make", [
    lambda p: p.InjectedCrash("x"), lambda p: p.Preempted(3),
    lambda p: p.TopologyChanged("shrink", 3, 1), lambda p: OSError(errno.ENOSPC, "full"),
    lambda p: RuntimeError("x"), lambda p: ValueError("x")],
    ids=["crash", "preempt", "topology", "storage", "runtime", "value"])
def test_retry_causes_are_the_reference_labels(make):
    assert classify_retry_cause(make(tfaults)) == jsup.classify_retry_cause(make(jfaults))


@pytest.fixture(scope="module")
def control2():
    """The uninterrupted 2-rank run (4 steps, gathered files): its final
    checkpoint and its residuals' digests. Its ranks get one thread
    too (the autouse fixture is not yet in force at module scope)."""
    d = pathlib.Path(tempfile.mkdtemp(prefix="tmpi-control2-"))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            s = launch_training("bsp", 2, "alexnet", "AlexNet", **_kw(d / "c", 2, max_steps=4))
        yield s["checkpoints"][-1]["path"], s["ef_digest_per_rank"]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_two_ranks_crash_save_a_sharded_set_and_resume_from_it(scratch, control2):
    s = _supervised(scratch / "ckpt", 2, max_retries=1, ckpt_sharded=True, max_steps=4,
                    inject_faults=["crash@4"])
    assert s["resumed_from_step"] == 3 and s["retries"] == 1
    # the crash saves: one member a rank, a complete set at step 3
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(str(scratch / "ckpt"))) == 4
    assert {f for f in os.listdir(scratch / "ckpt") if f.startswith("ckpt_3.")} == {
        "ckpt_3.proc0of2.npz", "ckpt_3.proc1of2.npz"}
    # the set reassembled equals the gathered control's file
    _assert_same_state(tckpt.latest_checkpoint(str(scratch / "ckpt")), control2[0])
    assert s["ef_digest_per_rank"] == control2[1]


def test_two_ranks_resume_from_a_gathered_file(scratch, control2):
    """Without ``ckpt_sharded`` a save is collective, so no rank makes a
    crash save: the retry resumes from ``ckpt_2.npz``, the newest
    gathered file, and both ranks' launches of the failed attempt are on
    record."""
    s = _supervised(scratch / "ckpt", 2, max_retries=1, max_steps=4, inject_faults=["crash@4"])
    assert s["resumed_from_step"] == 2 and s["retry_causes"] == {"crash": 1}
    assert s["resume"]["torch_rng_restored"]
    (failed,) = s["failed_attempts"]
    assert len(failed["launches_per_rank"]) == 2
    assert sorted(os.listdir(scratch / "ckpt")) == ["ckpt_2.npz", "ckpt_4.npz"]
    _assert_same_state(tckpt.latest_checkpoint(str(scratch / "ckpt")), control2[0])
    assert s["ef_digest_per_rank"] == control2[1]


def test_a_failed_rank_stops_peers_blocked_in_a_collective_without_the_save_grace():
    with pytest.raises(RuntimeError, match="rank 0 fails") as e:
        spawn_ranks(torch_rank_fns.fail_or_block_rank, 2, device="cpu")
    assert time.time() - e.value.t_fail < session.FAIL_GRACE
    assert list(e.value.rank_launches) == [0]


def test_an_elastic_shrink_reshards_two_ranks_onto_one(scratch):
    s = _supervised(scratch / "ckpt", 2, max_retries=1, ckpt_sharded=True, elastic=True,
                    inject_faults=["shrink@4:1"], obs_dir=str(scratch / "obs"))
    assert s["world"] == 1 and s["devices"] == 1 and s["retry_causes"] == {"topology": 1}
    assert s["resumed_from_step"] == 3 and s["resharded_from_world"] == 2
    r = s["reshard"]
    assert r["from_mesh"] == {"shape": [2], "axes": ["data"]} and r["to_world"] == 1
    assert len(r["reset"]) == 16 and all(k.startswith(".ef/") for k in r["reset"])
    # the params the one rank loaded are the set's, bit for bit
    saved = tckpt.load_checkpoint(str(scratch / "ckpt" / "ckpt_3.proc0of2.npz"))
    params = {k: v for k, v in saved.items() if k.startswith(".params/")}
    assert r["params_digest"] == tckpt.manifest_digest(tckpt.integrity_manifest(params))
    assert not s["resume"]["torch_rng_restored"]  # restarted from (seed, rank)
    recs = [json.loads(line) for line in open(scratch / "obs" / "supervisor.jsonl")]
    assert [(r["kind"], r.get("world")) for r in recs] == [
        ("topology", 2), ("retry", 2), ("topology", 1)]
    assert check_file(str(scratch / "obs" / "supervisor.jsonl")) == []


def test_enospc_on_the_async_writer_fails_that_save_only(scratch):
    s = launch_training("bsp", 1, "alexnet", "AlexNet",
                        **_kw(scratch / "ckpt", max_steps=4, inject_faults=["enospc@2"]))
    assert s["ckpt_storage_failures"] == 1 and s["steps"] == 4
    assert [c["step"] for c in s["checkpoints"]] == [4]
    assert sorted(os.listdir(scratch / "ckpt")) == ["ckpt_4.npz"]  # nothing torn left
    assert s["faults_fired"] == ["enospc@2"]


def test_the_scrubber_quarantines_bitrot_and_leaves_temporary_files(scratch):
    d = str(scratch)
    flat = {".params/w": np.arange(4096, dtype=np.float32), ".step": np.asarray(3, np.int32)}
    for step in (1, 2):
        tckpt.save_checkpoint(d, dict(flat, **{".step": np.asarray(step, np.int32)}), step)
    (scratch / "ckpt_3.npz.x.tmp").write_bytes(b"half written")
    hit = tfaults.FaultInjector.bitrot_newest(d)
    assert not tckpt.verify_checkpoint(hit) and not jckpt.verify_checkpoint(hit)
    scrubber = tckpt.CheckpointScrubber(d, interval=3600)
    res = scrubber.scrub_once()
    assert res["checked"] == 2 and res["quarantined"] == ["ckpt_2.npz"]
    assert sorted(os.listdir(d)) == ["ckpt_1.npz", "ckpt_3.npz.x.tmp", "quarantine"]
    assert tckpt.latest_checkpoint(d, verify=True) == jckpt.latest_checkpoint(d, verify=True)
    assert scrubber.scrub_once()["corrupt"] == 0  # memoized: stats only


def test_cli_supervised_crash_end_to_end(scratch):
    argv = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "alexnet", "AlexNet",
            "--synthetic", "--fused-update", "--device", "cpu", "--batch-size", "4",
            "--recipe-arg", "input_shape=[67,67,3]", "--recipe-arg", "num_classes=10",
            "--dataset-arg", "n_train=8", "--dataset-arg", "n_val=4", "--epochs", "2",
            "--max-steps", "4", "--ckpt-dir", str(scratch / "ckpt"), "--print-freq", "0",
            "--max-retries", "1", "--retry-backoff", "0", "--inject-fault", "crash@3",
            "--obs-dir", str(scratch / "obs")]
    out = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    s = json.loads(out.stdout.strip().splitlines()[-1])
    assert s["retries"] == 1 and s["steps"] == 4 and s["resumed_from_step"] == 2
    assert "[supervisor] attempt 1 failed (InjectedCrash" in out.stdout
    assert check_file(str(scratch / "obs" / "supervisor.jsonl")) == []
