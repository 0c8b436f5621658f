"""The benchmark's e2e and scaling modes (``tools/bench.py --mode e2e |
scaling``, the root ``bench.py``'s ``bench_e2e`` and ``bench_scaling``)
and the worker summary's ``host_blocked_frac``, on the CPU at a tiny size.

- e2e (``bench_e2e`` called with its size keywords): AlexNet at 67x67
  from 72x72 uint8 shards, batch 8, 6 steps: the executed-work check
  (``device_steps == steps``, and a forged mismatch raises), one row a
  dispatch depth with the reference's fields, the deepest the headline;
  ``recovery``: exactly one retry; ``--numerics-overhead`` refused; the
  CLI hands its flags to ``bench_e2e`` and prints the row last, and has
  no flags for the run's sizes.
- scaling: the fixed-work probe on 1 and 2 gloo ranks at a total batch
  of 32: identical replica digests, the table's fields, and nothing
  written but the out path (the repo's ``SCALING.json`` untouched); the
  CLI at its fixed batch of 512 on one rank: the last stdout line is the
  JSON object that ``--out`` holds.
- ``host_blocked_frac``: the key and its value in the port's summary and
  in the reference's on the same tiny run, each the reference's formula
  over its own summary's fields (to its 6-place rounding).
"""

import hashlib
import json
import math
import os
import subprocess
import sys

import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu.launch.worker import run_training as j_run_training
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu_torch.launch import worker
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_E2E = dict(device="cpu", steps=6, batch=8, image_size=72, n_train=64, n_val=16,
                recipe_overrides={"input_shape": (67, 67, 3)}, dataset_overrides={"crop": 67})
ROW_FIELDS = {"dispatch_depth", "images_per_sec", "wait_ms", "step_ms", "wait_frac",
              "host_blocked_frac", "mfu", "steps", "device_steps", "kernel_launches",
              "native_calls"}


def _bench(*args, cwd=REPO, timeout=600):
    out = subprocess.run([sys.executable, "-m", "theanompi_tpu_torch.tools.bench", *args],
                         cwd=cwd, capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture
def one_thread():
    # the in-process runs keep to one core, as the CLI's subprocesses do
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_e2e_depth_sweep_rows_and_the_executed_work_check(one_thread):
    r = bench.bench_e2e(dispatch_depths=(1, 2), **TINY_E2E)
    assert r["metric"] == "alexnet_e2e_images_per_sec_cpu" and r["unit"] == "images/sec"
    rows = r["dispatch_sweep"]
    assert [x["dispatch_depth"] for x in rows] == [1, 2]
    for x in rows:
        assert set(x) == ROW_FIELDS
        assert x["steps"] == x["device_steps"] == 6
        assert x["images_per_sec"] > 0 and 0 <= x["wait_frac"] < 1
        assert x["images_per_sec"] == pytest.approx(8 / ((x["step_ms"] + x["wait_ms"]) / 1e3))
        assert 0 <= x["host_blocked_frac"] <= 1 and x["mfu"] is None  # no peak on the CPU
        # the whole feed ran: each train batch gathered and cropped natively
        # (the prefetch thread may have gathered up to 2 batches past the cut)
        assert 6 <= x["native_calls"]["tmpi_gather_rows"] <= 8
        assert x["native_calls"]["tmpi_crop_mirror_u8"] >= 6
    head = rows[-1]
    assert r["value"] == head["images_per_sec"] and r["dispatch_depth"] == 2
    for k in ("wait_ms", "step_ms", "wait_frac", "host_blocked_frac", "mfu"):
        assert r[k] == head[k]
    assert r["batch"] == 8 and r["max_steps"] == 6 and r["steps_averaged"] == 4
    assert r["flops_per_step"] > 0 and r["device_kind"] == "cpu" and r["power_limit_w"] is None
    assert "vs_baseline" not in r and "recovery_overhead_frac" not in r


def test_e2e_recovery_overhead_takes_exactly_one_retry(one_thread):
    r = bench.bench_e2e(recovery=True, **TINY_E2E)
    assert r["recovery_retries"] == 1 and r["recovery_crash_at"] == 3
    assert math.isfinite(r["recovery_overhead_frac"])
    assert r["recovery_clean_s"] > 0 and r["recovery_crash_s"] > 0
    assert [x["dispatch_depth"] for x in r["dispatch_sweep"]] == [1]


def test_e2e_raises_when_the_card_ran_fewer_steps_than_dispatched(monkeypatch):
    real = worker.run_training

    def short(*a, **k):
        s = real(*a, **k)
        s["device_steps"] -= 1
        return s

    monkeypatch.setattr(worker, "run_training", short)
    with pytest.raises(RuntimeError, match="executed 1 steps but the loop dispatched 2"):
        bench.bench_e2e(steps=2, batch=4, device="cpu", image_size=68, n_train=8, n_val=4,
                        recipe_overrides={"input_shape": (67, 67, 3)},
                        dataset_overrides={"crop": 67})


def test_e2e_numerics_overhead_is_refused():
    with pytest.raises(ValueError, match="obs/"):
        bench.bench_e2e(numerics=True, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        bench.main(["--mode", "e2e", "--numerics-overhead", "--device", "cpu"])


def test_e2e_cli_passes_its_flags_and_prints_the_row_last(monkeypatch, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"metric": "alexnet_e2e_images_per_sec_cpu", "value": 1.5, "unit": "images/sec",
                "step_ms": 2.0, "wait_ms": 0.5, "wait_frac": 0.2}

    monkeypatch.setattr(bench, "bench_e2e", fake)
    assert bench.main(["--mode", "e2e", "--dispatch-depths", "1,2", "--recovery-overhead",
                       "--steps", "6", "--device", "cpu"]) == 0
    assert seen == {"steps": 6, "dispatch_depths": (1, 2), "numerics": False,
                    "recovery": True, "device": "cpu"}
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["value"] == 1.5
    # the run's sizes are fixed: the CLI has no flags for them
    for flag in ("--batch", "--image-size", "--n-train", "--n-val", "--dataset-arg"):
        with pytest.raises(SystemExit):
            bench.build_parser().parse_args(["--mode", "e2e", flag, "1"])


def test_compute_stays_the_default_mode():
    args = bench.build_parser().parse_args([])
    assert args.mode == "compute" and args.model == "alexnet" and args.steps is None


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest() if os.path.exists(path) else None


def test_scaling_on_one_and_two_gloo_ranks(tmp_path, monkeypatch):
    scaling_json = os.path.join(REPO, "SCALING.json")
    before = _sha(scaling_json)
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "scaling.json"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    r = bench.bench_scaling((1, 2), steps=2, batch=32, device="cpu", out_path=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(r))
    assert os.listdir(work) == []  # nothing written but --out
    assert _sha(scaling_json) == before
    assert r["metric"] == "cifar10_cnn_bsp_fixed_work_efficiency_cpu"
    assert r["batch"] == 32 and r["steps"] == 2 and r["trials"] == 3 and r["hier"] == []
    rows = r["table"]
    assert [x["n_devices"] for x in rows] == [1, 2]
    for x in rows:
        assert x["backend"] == "gloo" and x["strategy"] == "psum" and x["slices"] == 1
        assert x["images_per_sec"] > 0 and x["params"] > 0
        digests = x["replica_digest_per_rank"]
        assert len(digests) == x["n_devices"] and len(set(digests)) == 1
        assert x["efficiency"] == pytest.approx(x["images_per_sec"] / rows[0]["images_per_sec"])
    assert rows[0]["efficiency"] == 1.0 and r["value"] == rows[1]["efficiency"]


def test_host_blocked_frac_matches_the_references_summary():
    small = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
    data = {"n_train": 12, "n_val": 4}
    j = j_run_training("bsp", JAlexNet, devices=1, n_epochs=1, max_steps=3, dataset="synthetic",
                       dataset_kwargs=data, print_freq=0,
                       recipe_overrides=dict(compute_dtype=jnp.float32, **small))
    t = worker.run_training(model_cls=TAlexNet, device="cpu", n_epochs=1, max_steps=3,
                            dataset="synthetic", dataset_kwargs=data, print_freq=0,
                            dispatch_depth=1,
                            recipe_overrides=dict(compute_dtype=torch.float32, **small))
    for s in (j, t):
        assert "host_blocked_frac" in s and 0 <= s["host_blocked_frac"] <= 1
        assert s["host_blocked_frac"] == round(s["host_blocked_frac"], 6)
        want = round(min(1.0, s["host_blocked_s"] / s["train_loop_s"]), 6)
        assert s["host_blocked_frac"] == pytest.approx(want, abs=2e-6)
    # the port's formula gives the reference's own value from its fields
    assert worker.host_blocked_frac(j["host_blocked_s"], j["train_loop_s"]) == pytest.approx(
        j["host_blocked_frac"], abs=2e-6)
    assert worker.host_blocked_frac(1.0, 0.0) is None
    assert worker.host_blocked_frac(3.0, 2.0) == 1.0
    assert worker.host_blocked_frac(1.0, 3.0) == 0.333333


def test_scaling_cli_prints_what_it_writes_to_out(tmp_path):
    scaling_json = os.path.join(REPO, "SCALING.json")
    before = _sha(scaling_json)
    work = tmp_path / "cwd"
    work.mkdir()
    out = tmp_path / "scaling.json"
    r = _bench("--mode", "scaling", "--device", "cpu", "--ns", "1", "--steps", "1",
               "--out", str(out), cwd=str(work))
    assert json.loads(out.read_text()) == r
    assert os.listdir(work) == [] and _sha(scaling_json) == before
    assert r["batch"] == 512 and r["steps"] == 1 and r["value"] == 1.0
    assert [x["n_devices"] for x in r["table"]] == [1]
