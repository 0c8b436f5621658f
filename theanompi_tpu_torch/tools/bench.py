"""Compute-mode benchmark of the port: the train step's throughput with
the batch resident on the card, the input pipeline left out.

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
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.launch.session import resolve_model
from theanompi_tpu_torch.models import MODEL_REGISTRY
from theanompi_tpu_torch.models.contract import as_dtype
from theanompi_tpu_torch.parallel.bsp import BSPEngine
from theanompi_tpu_torch.train import make_multi_step
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m theanompi_tpu_torch.tools.bench",
                                description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--model", default="alexnet", choices=sorted(MODELS))
    p.add_argument("--steps", type=int, default=20, help="train steps a timed call")
    p.add_argument("--trials", type=int, default=5, help="timed calls")
    p.add_argument("--fused-update", action="store_true")
    p.add_argument("--pool-kernel", action="store_true")
    p.add_argument("--eager", action="store_true", help="run the steps eagerly: no graph")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recipe-arg", action="append", default=[], metavar="K=V",
                   help="recipe override (repeatable, JSON values), e.g. batch_size=4")
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    return p


def main(argv=None) -> int:
    from theanompi_tpu_torch.cli import _parse_kv

    args = build_parser().parse_args(argv)
    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in _parse_kv(args.recipe_arg, "--recipe-arg").items()}
    result = bench_compute(args.model, steps=args.steps, trials=args.trials,
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
