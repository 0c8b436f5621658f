"""Benchmarks of the port, in three modes (``--mode``):

- ``compute`` (the default): the train step's throughput with the batch
  resident on the card, the input pipeline left out;
- ``e2e``: AlexNet trained end to end through ``run_training`` from
  uint8 shards on disk (``bench_e2e``);
- ``scaling``: a fixed-work probe over n ranks (``bench_scaling``).

    python -m theanompi_tpu_torch.tools.bench --model alexnet --fused-update
    python -m theanompi_tpu_torch.tools.bench --model googlenet --fused-update --pool-kernel
    python -m theanompi_tpu_torch.tools.bench --model lm_136m
    python -m theanompi_tpu_torch.tools.bench --model wrn|resnet50|vgg16 --fused-update
        [--steps 20] [--trials 5] [--eager] [--seed 0] [--recipe-arg K=V ...]
        [--device cpu]

The counterpart of the root ``bench.py``'s compute mode
(``bench_compute``): one batch made from ``--seed`` (float32 images and
int labels; token windows for the LM) stays on the card, and
``train.make_multi_step(step, steps, stacked=False)`` runs ``--steps``
train steps over it a call. On the card the steps replay one captured
CUDA graph of the step; ``--eager`` runs them as eager steps instead
(the same step, no graph), the baseline the graph is held against.

One eager step first counts the step's FLOPs (``utils/flops.py``: ATen's
matmuls and convolutions; the flash kernels' products are not counted).
Then a warm-up call (on the card: the first step eagerly, the capture,
the replays), then ``--trials`` timed calls, each between CUDA events
(the host clock on the CPU): the median and the spread ``(max - min) /
median`` are reported, with the host's time to enqueue a call. State is
threaded through every call, so the step counter must advance by
``steps x (warm-up + trials)``, or the run raises. The physics guard
raises when the measured rate beats 100% of the card's data-sheet peak.

The models and their batches are the port's recipes: AlexNet at 128
(227x227x3, 1000 classes, bf16 compute), GoogLeNet at the repo's
single-card batch 512 (224x224x3, bf16), TransformerLM_136M at 8 windows
of 1024 tokens (bf16, Adam), WRN-28-10 at config #1's 128 (32x32x3, 10
classes, fp32, Nesterov), ResNet-50 at 256 and VGG16 at 128 (224x224x3,
1000 classes, bf16; the batches of ``models/zoo.py::zoo_entry``). The
last stdout line is one JSON object: ``metric`` (``{model}_{dataset}_bsp_images_per_sec_1chip``; ``_cpu`` in
place of ``_1chip`` on the CPU), ``value``, ``unit``, ``tokens_per_sec``
for the LM, ``mfu``, ``timing``, ``captured``, ``device_kind`` and
``power_limit_w`` (``nvidia-smi``; ``null`` where it cannot be read).
Runs on the card unless ``--device cpu`` is given.

    python -m theanompi_tpu_torch.tools.bench --mode e2e [--steps 48]
        [--dispatch-depths 1,2] [--recovery-overhead] [--device cpu]

The counterpart of the root ``bench.py``'s ``bench_e2e``: uint8 shards
from ``np.random.RandomState(0)`` (256x256x3; ``max(2048, 8 x batch)``
train rows in shards of 1024, 256 val rows) in a temporary directory,
then ``launch/worker.py::run_training`` of AlexNet under BSP on the
``imagenet`` dataset at the recipe's batch of 128, ``--fused-update``,
up to ``--steps`` steps, once for
each depth of ``--dispatch-depths`` over the same shards: the whole feed
(mmap gather, crop and mirror, the prefetch thread, the copy to the
card), then the step. Each run must have executed every step it
dispatched (``device_steps == steps``), or the mode raises. A row:
``images_per_sec = batch / (step + wait)`` over the last ``max(4,
steps // 2)`` steps (the recorder's CUDA-event step time and the loop's
wait for the loader), ``wait_frac``, the loop's ``host_blocked_frac``
and ``mfu`` (one step's FLOPs counted as the compute mode counts them,
over the mean step time). The deepest run is the headline, every run a
row of ``dispatch_sweep``. ``--recovery-overhead`` also times one clean
checkpointed run against one under ``launch/supervisor.py``'s
``supervise_training`` with a crash injected at ``max(2, steps // 2)``,
one retry and no backoff, and reports ``recovery_overhead_frac``; it
raises unless exactly one retry happened. ``--numerics-overhead`` needs
``obs/``'s sentinels, not ported yet, and is refused. ``metric`` is
``alexnet_e2e_images_per_sec_1chip`` (``_cpu`` on the CPU). The
function's keyword arguments (``batch``, ``image_size``, ``n_train``,
``n_val`` and the overrides) shrink the run for a test on the CPU.

    python -m theanompi_tpu_torch.tools.bench --mode scaling [--ns 1,2,4]
        [--steps 96] [--out PATH] [--device cpu]

The counterpart of the root ``bench.py``'s ``bench_scaling``: the
fixed-work probe, ``Cifar10_model`` at a total batch of 512 whatever n,
inputs from ``RandomState(0)``, the best of 3 trials of ``--steps``
steps after one warm-up step (default 96 on the card, where a step
takes 6-11 ms and a trial of the reference's 4 steps is shorter than
the spread between trials; 4 on the CPU), run over n ranks spawned by
``launch/session.py`` for each n of ``--ns``: NCCL when each rank has a
card of its own, gloo when ranks share card 0 or run on the CPU. At
each even n >= 4 that the machine has cards for (the two smallest),
flat ``psum`` against ``hier`` over 2 slices. Each probe checks its step
counter (warm-up + 3 trials) and that every rank's replica digest is
the same. The table holds ``images_per_sec`` and ``efficiency = t(1) /
t(n)`` for each n; the result goes to stdout and, with ``--out``, to
that file only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from theanompi_tpu_torch import native
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.launch.session import resolve_model
from theanompi_tpu_torch.models import MODEL_REGISTRY
from theanompi_tpu_torch.models.contract import as_dtype
from theanompi_tpu_torch.ops.kernels import launch_counts
from theanompi_tpu_torch.parallel.bsp import BSPEngine
from theanompi_tpu_torch.train import make_multi_step
from theanompi_tpu_torch.tree import tree_leaves
from theanompi_tpu_torch.utils.flops import CostModel, count_step_flops, peak_flops

# bench name -> (MODEL_REGISTRY name, batch)
MODELS = {
    "alexnet": ("alexnet", 128),
    "googlenet": ("googlenet", 512),
    "lm_136m": ("transformer_lm_136m", 8),
    "wrn": ("wrn", 128),
    "resnet50": ("resnet50", 256),
    "vgg16": ("vgg16", 128),
}


def power_limit_w(device: torch.device):
    """The card's power limit in watts from ``nvidia-smi``; ``None`` on the
    CPU or when it cannot be read."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(device.index)], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def timing_stats(times) -> dict:
    """``{k, median_s, spread_frac}``: the spread is ``(max - min) /
    median``, the run-to-run band around the quoted median."""
    med = float(np.median(times))
    return {"k": len(times), "median_s": med,
            "spread_frac": (max(times) - min(times)) / med if med else None}


def resident_batch(model, batch: int, seed: int, device):
    """``(x, y)`` on ``device`` from ``seed``: float32 NHWC images and int
    labels, or for an LM token windows that are their own labels."""
    r = model.recipe
    rng = np.random.RandomState(seed)
    if getattr(model, "is_lm", False):
        x = torch.from_numpy(rng.randint(0, r.num_classes, (batch, *r.input_shape))
                             .astype(np.int32)).to(device)
        return x, x
    x = torch.from_numpy(rng.randn(batch, *r.input_shape).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, r.num_classes, batch).astype(np.int32)).to(device)
    return x, y


def bench_compute(model_name: str = "alexnet", steps: int = 20, trials: int = 5,
                  fused_update: bool = False, pool_kernel: bool = False, eager: bool = False,
                  seed: int = 0, device=None, recipe_overrides=None) -> dict:
    """The benchmark (module docstring) -> its result dict."""
    device = resolve_device(device)
    if model_name not in MODELS:
        raise ValueError(f"unknown bench model {model_name!r}; available: {sorted(MODELS)}")
    if steps < 1 or trials < 1:
        raise ValueError(f"steps ({steps}) and trials ({trials}) must be >= 1")
    zoo, default_batch = MODELS[model_name]
    model_cls = resolve_model(zoo, MODEL_REGISTRY[zoo][1])
    recipe = model_cls.default_recipe().replace(
        **{"batch_size": default_batch, **(recipe_overrides or {})})
    model = model_cls(recipe, pool_kernel=pool_kernel)
    batch = recipe.batch_size
    engine = BSPEngine(model, 1, device, fused_update=fused_update)
    state = engine.init_state(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x, y = resident_batch(model, batch, seed, device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    (state, _), flops = count_step_flops(engine.train_step, state, x, y, gen)
    runner = make_multi_step(engine.train_step, steps, stacked=False, device=device,
                             capture=not eager)
    start = engine.get_step(state)
    state, metrics = runner(state, x, y, gen)  # warm-up (on the card: the capture)
    sync()
    times, host = [], []
    for _ in range(trials):
        if cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        h0 = time.perf_counter()
        state, metrics = runner(state, x, y, gen)
        host.append(time.perf_counter() - h0)
        if cuda:
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
        else:
            times.append(time.perf_counter() - h0)
    got, want = engine.get_step(state), start + steps * (trials + 1)
    if got != want:
        raise RuntimeError(f"bench_compute: the step counter reads {got}, expected {want}: "
                           "the measured steps did not all run")
    losses = metrics["loss"].tolist()
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"bench_compute: non-finite loss in the last call: {losses}")
    timing = timing_stats(times)
    med = timing["median_s"]
    step_s = med / steps
    cost = CostModel(flops, peak_flops(device, as_dtype(recipe.compute_dtype)))
    floor = cost.min_step_seconds()
    if floor is not None and step_s < floor:
        raise RuntimeError(
            f"bench_compute: {step_s * 1e3:.4f} ms a step is under the {floor * 1e3:.4f} ms "
            f"that {flops:.4g} FLOPs take at 100% of the card's peak: the timing is broken")
    img_s = steps * batch / med
    tag = "1chip" if cuda else "cpu"
    result = {
        "metric": f"{model_name}_{recipe.dataset}_bsp_images_per_sec_{tag}",
        "value": img_s,
        "unit": "images/sec",
        "mfu": cost.mfu(step_s),
        "timing": timing,
        "captured": runner.graph is not None,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit_w": power_limit_w(device),
        "batch": batch,
        "steps": steps,
        "step_ms": step_s * 1e3,
        "host_ms_per_step": float(np.median(host)) / steps * 1e3,
        "flops_per_step": flops,
        "peak_flops_per_sec": cost.peak_flops_per_sec,
        "fused_update": bool(fused_update),
        "pool_kernel": bool(pool_kernel),
        "last_losses": losses,
    }
    if runner.graph is not None:
        result["graph"] = {"captures": runner.graph.captures, "replays": runner.graph.replays}
    if getattr(model, "is_lm", False):
        result["unit"] = "sequences/sec"
        result["seq_len"] = recipe.input_shape[0]
        result["tokens_per_sec"] = img_s * recipe.input_shape[0]
        result["mfu_note"] = ("ATen's matmuls over the bf16 peak; the flash kernels' "
                              "attention products are not counted")
    return result

# ---------------------------------------------------------------------------
# e2e mode
# ---------------------------------------------------------------------------


def step_flops(model, batch: int, device, fused_update: bool = True, seed: int = 0) -> float:
    """One train step's FLOPs at ``batch``, counted as the compute mode
    counts them (one eager step on a resident float32 batch)."""
    engine = BSPEngine(model, 1, device, fused_update=fused_update)
    state = engine.init_state(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x, y = resident_batch(model, batch, seed, device)
    _, flops = count_step_flops(engine.train_step, state, x, y, gen)
    return flops


def bench_e2e(steps: int = 48, batch: int = 0, dispatch_depths=(1,), numerics: bool = False,
              recovery: bool = False, device=None, image_size: int = 256,
              n_train: int = 0, n_val: int = 256, recipe_overrides=None,
              dataset_overrides=None) -> dict:
    """The e2e benchmark (module docstring) -> its result dict."""
    if numerics:
        raise ValueError(
            "--numerics-overhead times the numerics sentinels of obs/, which the port has not "
            "ported yet (ROADMAP.md queue 1 item 5, observability and tooling)")
    from theanompi_tpu_torch.data.imagenet import write_shards
    from theanompi_tpu_torch.launch.supervisor import supervise_training
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.alex_net import AlexNet

    device = resolve_device(device)
    depths = tuple(int(k) for k in dispatch_depths)
    if steps < 1 or not depths or min(depths) < 1:
        raise ValueError(f"steps ({steps}) and every dispatch depth ({depths}) must be >= 1")
    recipe = AlexNet.default_recipe().replace(
        **{"batch_size": batch or 128, **(recipe_overrides or {})})
    batch = recipe.batch_size
    n_train = n_train or max(2048, 8 * batch)
    cuda = device.type == "cuda"
    flops = step_flops(AlexNet(recipe), batch, device)
    cost = CostModel(flops, peak_flops(device, as_dtype(recipe.compute_dtype)))
    rng = np.random.RandomState(0)
    rows = []
    with tempfile.TemporaryDirectory(prefix="tmpi_bench_") as d:
        shape = (image_size, image_size, 3)
        write_shards(d, "train", rng.randint(0, 256, (n_train, *shape), dtype=np.uint8),
                     rng.randint(0, 1000, n_train).astype(np.int64), shard_size=1024)
        write_shards(d, "val", rng.randint(0, 256, (n_val, *shape), dtype=np.uint8),
                     rng.randint(0, 1000, n_val).astype(np.int64), shard_size=256)
        common = dict(device=device, fused_update=True, dataset="imagenet",
                      dataset_kwargs={"root": d, **(dataset_overrides or {})},
                      recipe_overrides={**(recipe_overrides or {}), "batch_size": batch},
                      n_epochs=max(1, steps // (n_train // batch)), max_steps=steps,
                      print_freq=0)
        last_n = max(4, steps // 2)
        for depth in depths:
            launches0, native0 = launch_counts(), dict(native.LOADER.calls)
            summary = run_training("bsp", AlexNet, dispatch_depth=depth, return_recorder=True,
                                   **common)
            # executed-work check: the card's step counter against the loop's dispatches
            if summary["device_steps"] != summary["steps"]:
                raise RuntimeError(
                    f"bench_e2e: the card executed {summary['device_steps']} steps but the "
                    f"loop dispatched {summary['steps']}")
            rec = summary["recorder"]
            step_t, wait_t = rec.mean_time("step", last_n), rec.mean_time("wait", last_n)
            rows.append({
                "dispatch_depth": depth,
                "images_per_sec": batch / (step_t + wait_t) if step_t + wait_t else 0.0,
                "wait_ms": 1e3 * wait_t,
                "step_ms": 1e3 * step_t,
                "wait_frac": wait_t / (step_t + wait_t) if step_t else None,
                "host_blocked_frac": summary["host_blocked_frac"],
                "mfu": cost.mfu(step_t),
                "steps": summary["steps"],
                "device_steps": summary["device_steps"],
                # this run's own kernel launches and native calls
                "kernel_launches": {k: v - launches0.get(k, 0)
                                    for k, v in launch_counts().items()},
                "native_calls": {k: v - native0.get(k, 0)
                                 for k, v in native.LOADER.calls.items()},
            })
        recovery_overhead = None
        if recovery:
            # the headline depth with checkpoints: one clean run against one
            # that crashes mid-run and is resumed by the supervisor
            kw = dict(common, dispatch_depth=max(depths))
            t0 = time.perf_counter()
            run_training("bsp", AlexNet, ckpt_dir=os.path.join(d, "ck_clean"), **kw)
            t_clean = time.perf_counter() - t0
            crash_at = max(2, steps // 2)
            t0 = time.perf_counter()
            crashed = supervise_training("bsp", 1, "alexnet", "AlexNet",
                                         ckpt_dir=os.path.join(d, "ck_crash"), max_retries=1,
                                         backoff_base=0.0, inject_faults=[f"crash@{crash_at}"],
                                         **kw)
            t_crash = time.perf_counter() - t0
            if crashed["retries"] != 1:
                raise RuntimeError(f"recovery bench: expected exactly 1 retry, got "
                                   f"{crashed['retries']}")
            recovery_overhead = (t_crash - t_clean) / t_clean if t_clean > 0 else None
    head = max(rows, key=lambda r: r["dispatch_depth"])  # the deepest is the headline
    result = {
        "metric": f"alexnet_e2e_images_per_sec_{'1chip' if cuda else 'cpu'}",
        "value": head["images_per_sec"],
        "unit": "images/sec",
        **{k: head[k] for k in ("wait_ms", "step_ms", "wait_frac", "host_blocked_frac", "mfu",
                                "dispatch_depth")},
        "batch": batch,
        "max_steps": steps,
        "steps_averaged": last_n,
        "image_size": image_size,
        "n_train": n_train,
        "flops_per_step": flops,
        "peak_flops_per_sec": cost.peak_flops_per_sec,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit_w": power_limit_w(device),
        "dispatch_sweep": rows,
    }
    if recovery_overhead is not None:
        result.update(recovery_overhead_frac=recovery_overhead, recovery_clean_s=t_clean,
                      recovery_crash_s=t_crash, recovery_crash_at=crash_at,
                      recovery_retries=crashed["retries"])
    return result


# ---------------------------------------------------------------------------
# scaling mode
# ---------------------------------------------------------------------------

SCALING_TRIALS = 3


def scaling_probe_rank(rank: int, n: int, device, steps: int, batch: int, n_slices: int,
                       strategy: str) -> dict:
    """One rank of the fixed-work probe (module docstring): its rows of
    the fixed batch, a warm-up step, the best of ``SCALING_TRIALS``
    trials of ``steps`` steps; returns the rank's time, step count and
    replica digest."""
    from theanompi_tpu_torch.models.cifar10 import Cifar10_model
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice, rank_generator

    device = torch.device(device)
    model = Cifar10_model(Cifar10_model.default_recipe().replace(batch_size=batch))
    engine = BSPEngine(model, n, device, strategy=strategy,
                       n_slices=n_slices if n_slices > 1 else None)
    state = engine.init_state(torch.Generator().manual_seed(0))
    n_par = sum(int(p.numel()) for p in tree_leaves(engine.replica(state).params))
    r = np.random.RandomState(0)
    x = r.randn(batch, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, batch).astype(np.int32)
    rows = host_local_batch_slice(batch, rank, n)
    x = torch.from_numpy(x[rows]).to(device)
    y = torch.from_numpy(y[rows]).to(device)
    gen = rank_generator(1, rank, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, _ = engine.train_step(state, x, y, gen)
    sync()
    best = None
    for _ in range(SCALING_TRIALS):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = engine.train_step(state, x, y, gen)
        sync()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return {"rank": rank, "best_s": best, "step": engine.get_step(state), "params": n_par,
            "loss": float(metrics["loss"]), **engine.rank_summary(state)}


def run_scaling_probe(n: int, steps: int, batch: int = 512, n_slices: int = 1,
                      strategy: str = "psum", device=None) -> dict:
    """The probe over ``n`` ranks spawned by ``launch/session.py``; raises
    unless every rank ran warm-up + trials' steps and holds the same
    replica. Returns the row: the slowest rank's best time a trial."""
    from theanompi_tpu_torch.launch.session import spawn_ranks

    device = resolve_device(device)
    if device.type == "cuda" and n <= torch.cuda.device_count():
        rank_device, backend = None, "nccl"  # a card a rank
    elif device.type == "cuda":
        rank_device, backend = f"cuda:{device.index or 0}", "gloo"  # ranks share a card
    else:
        rank_device, backend = "cpu", "gloo"
    out = spawn_ranks(scaling_probe_rank, n, (steps, batch, n_slices, strategy),
                      device=rank_device, backend=backend, timeout=1800)
    want = 1 + SCALING_TRIALS * steps
    if any(o["step"] != want for o in out):
        raise RuntimeError(f"scaling probe n={n}: step counters {[o['step'] for o in out]}, "
                           f"expected {want}")
    digests = [o["replica_digest"] for o in out]
    if len(set(digests)) != 1:
        raise RuntimeError(f"scaling probe n={n}: the replicas differ: {digests}")
    best = max(o["best_s"] for o in out)
    return {"n_devices": n, "backend": backend, "slices": n_slices, "strategy": strategy,
            "images_per_sec": steps * batch / best, "step_ms": 1e3 * best / steps,
            "params": out[0]["params"], "losses": [o["loss"] for o in out],
            "replica_digest_per_rank": digests}


def bench_scaling(ns=(1, 2, 4, 8), steps: int = 4, batch: int = 512, device=None,
                  out_path=None) -> dict:
    """The scaling benchmark (module docstring) -> its result dict,
    written to ``out_path`` when given (and nowhere else)."""
    device = resolve_device(device)
    ns = tuple(int(n) for n in ns)
    if not ns or min(ns) < 1 or steps < 1:
        raise ValueError(f"ns ({ns}) and steps ({steps}) must be >= 1")
    rows = [run_scaling_probe(n, steps, batch, device=device) for n in ns]
    cards = torch.cuda.device_count() if device.type == "cuda" else max(ns)
    hier_rows = []
    for n in sorted({n for n in ns if n >= 4 and n % 2 == 0 and n <= cards})[:2]:
        for strategy in ("psum", "hier"):
            hier_rows.append(run_scaling_probe(n, steps, batch, n_slices=2, strategy=strategy,
                                               device=device))
    base = rows[0]
    for r in rows:
        r["efficiency"] = r["images_per_sec"] / base["images_per_sec"]  # t(n0)/t(n), work fixed
    cuda = device.type == "cuda"
    result = {
        "metric": ("cifar10_cnn_bsp_fixed_work_efficiency_"
                   f"{f'{torch.cuda.device_count()}chip' if cuda else 'cpu'}"),
        "value": rows[-1]["efficiency"],
        "unit": f"t(n={base['n_devices']})/t(n) at a fixed total batch of {batch}",
        "base_n": base["n_devices"],
        "headline_n": rows[-1]["n_devices"],
        "batch": batch,
        "steps": steps,
        "trials": SCALING_TRIALS,
        "table": rows,
        "hier": hier_rows,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit_w": power_limit_w(device),
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m theanompi_tpu_torch.tools.bench",
                                description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--mode", choices=["compute", "e2e", "scaling"], default="compute")
    p.add_argument("--model", default="alexnet", choices=sorted(MODELS),
                   help="compute mode: the model")
    p.add_argument("--steps", type=int, default=None,
                   help="compute: steps a timed call (20); e2e: the run's steps (48); "
                        "scaling: steps a trial (96 on the card, 4 on the CPU)")
    p.add_argument("--trials", type=int, default=5, help="compute mode: timed calls")
    p.add_argument("--fused-update", action="store_true", help="compute mode")
    p.add_argument("--pool-kernel", action="store_true", help="compute mode")
    p.add_argument("--eager", action="store_true",
                   help="compute mode: run the steps eagerly, no graph")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recipe-arg", action="append", default=[], metavar="K=V",
                   help="compute mode: recipe override (repeatable, JSON values), "
                        "e.g. batch_size=4")
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    p.add_argument("--dispatch-depth", type=int, default=1,
                   help="e2e mode: the dispatch depth of the one run")
    p.add_argument("--dispatch-depths", default=None,
                   help="e2e mode: a comma-separated sweep of depths over the same shards "
                        "(the deepest is the headline)")
    p.add_argument("--recovery-overhead", action="store_true",
                   help="e2e mode: also time a clean run against a crashed and resumed one")
    p.add_argument("--numerics-overhead", action="store_true",
                   help="e2e mode: needs obs/ (not ported yet); refused")
    p.add_argument("--ns", default=None,
                   help="scaling mode: comma-separated rank counts (default 1,2,4,8)")
    p.add_argument("--out", default=None, help="scaling mode: also write the result here")
    return p


def main(argv=None) -> int:
    from theanompi_tpu_torch.cli import _parse_kv

    args = build_parser().parse_args(argv)
    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in _parse_kv(args.recipe_arg, "--recipe-arg").items()}
    if args.mode == "e2e":
        depths = (tuple(int(k) for k in args.dispatch_depths.split(","))
                  if args.dispatch_depths else (args.dispatch_depth,))
        result = bench_e2e(steps=args.steps or 48, dispatch_depths=depths,
                           numerics=args.numerics_overhead, recovery=args.recovery_overhead,
                           device=args.device)
        print(f"{result['metric']}: {result['value']:.1f} {result['unit']}, step "
              f"{result['step_ms']:.3f} ms, wait {result['wait_ms']:.3f} ms, wait_frac "
              f"{result['wait_frac']}", flush=True)
    elif args.mode == "scaling":
        ns = tuple(int(n) for n in args.ns.split(",")) if args.ns else (1, 2, 4, 8)
        steps = args.steps or (96 if resolve_device(args.device).type == "cuda" else 4)
        result = bench_scaling(ns, steps=steps, device=args.device, out_path=args.out)
        for r in result["table"] + result["hier"]:
            print(f"n {r['n_devices']} {r['backend']} {r['strategy']} x{r['slices']}: "
                  f"{r['images_per_sec']:.1f} img/s, {r['step_ms']:.3f} ms a step"
                  + (f", efficiency {r['efficiency']:.4f}" if "efficiency" in r else ""),
                  flush=True)
    else:
        result = bench_compute(args.model, steps=args.steps or 20, trials=args.trials,
                               fused_update=args.fused_update, pool_kernel=args.pool_kernel,
                               eager=args.eager, seed=args.seed, device=args.device,
                               recipe_overrides=overrides)
        print(f"{result['metric']}: {result['value']:.1f} {result['unit']}, "
              f"{result['step_ms']:.3f} ms a step (median of {result['timing']['k']} calls of "
              f"{result['steps']}), host {result['host_ms_per_step']:.4f} ms a step, "
              f"captured {result['captured']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
