"""Where a full-width training step's time goes on the card.

    python -m theanompi_tpu_torch.tools.profile_step [--model alexnet|lm|googlenet]
        [--no-pool-kernel] [--steps 10] [--out PATH]

Builds a one-card training path as the training loop does: AlexNet's
recipe (``BSPEngine`` with ``--fused-update``, batch 128, 227x227x3,
1000 classes, bf16 compute), with ``--model lm`` TransformerLM_136M's
(batch 8 windows of 1024 tokens, 32k vocab, bf16 compute, Adam, the
flash kernels), or with ``--model googlenet`` full-width GoogLeNet's at
the repo's single-card batch 512 (224x224x3, 1000 classes, bf16 compute,
``--fused-update``, the inception pools on the pool kernels unless
``--no-pool-kernel``), and measures, on the card:

- ``device_step_ms``: one training step with the batch already on the
  card (CUDA events over ``--steps`` steps, after warm-up) — the step
  without the host input pipeline;
- ``busy_ms_per_step`` / ``idle_share``: the device's kernel time per step
  under ``torch.profiler`` (kernels on one stream do not overlap, so their
  sum is the busy time) against the step's wall time;
- ``kernels``: device time per kernel name per step, largest first, with
  the fused optimizer kernel's share;
- ``heads_major_ms_per_step`` (LM): the copies of q, k and v into the
  flash kernels' heads-major layout, three a layer, timed alone;
- ``h2d_ms``: the pinned, non-blocking copy of one input batch;
- ``categories``: the same device time summed by kind of kernel
  (flash attention, the pool kernels, convolution/GEMM, cuDNN layout
  transforms, dtype casts and copies, elementwise, pooling, reductions,
  the fused optimizer update, other);
- ``host_batch_ms``: the host-side gather + pin of one batch from the
  synthetic dataset in steady state (the first batch, which allocates,
  left out) — the work the training loop's prefetch thread overlaps
  (for the LM, token windows of the model's shape from a 64-symbol
  chain: the gather does not depend on the vocabulary).

The last stdout line is the JSON summary (also written to ``--out``).
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from theanompi_tpu_torch.data import Synthetic_data
from theanompi_tpu_torch.data.lm import LMSynthetic_data
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.googlenet import GoogLeNet
from theanompi_tpu_torch.models.lm import TransformerLM_136M
from theanompi_tpu_torch.parallel.bsp import BSPEngine


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# kernel name fragments -> category, first match wins
CATEGORIES = (
    ("flash_attention", ("flash_fwd_kernel", "flash_fwd_sm90_kernel", "flash_dq_kernel",
                         "flash_dq_sm90_kernel", "flash_dkv_kernel", "flash_dkv_sm90_kernel")),
    ("pool_kernel", ("maxpool_fwd_tile_kernel", "maxpool_bwd_tile_kernel")),
    ("fused_update", ("fused_update_multi_kernel", "momentum_kernel", "sgd_kernel")),
    ("layout_transform", ("tensorTransform", "nhwcSlice", "nchwToNhwc", "nhwcToNchw")),
    ("copy_cast", ("direct_copy",)),
    ("conv_gemm", ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "nvjet")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def _category(name: str) -> str:
    for cat, frags in CATEGORIES:
        if any(f in name for f in frags):
            return cat
    return "other"


# GoogLeNet's single-card batch (the reference's zoo row, models/zoo.py)
GOOGLENET_BATCH = 512


def profile(steps: int = 10, warmup: int = 3, top: int = 15, host_batches: int = 6,
            model_name: str = "alexnet", pool_kernel: bool = True) -> dict:
    device = resolve_device(None)
    lm = model_name == "lm"
    if lm:
        model = TransformerLM_136M()
    elif model_name == "googlenet":
        model = GoogLeNet(GoogLeNet.default_recipe().replace(batch_size=GOOGLENET_BATCH),
                          pool_kernel=pool_kernel)
    else:
        model = AlexNet()
    r = model.recipe
    batch = r.batch_size
    # Adam (the LM's rule) has no fused form
    engine = BSPEngine(model, 1, device, steps_per_epoch=10_000, fused_update=not lm)
    state = engine.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    if lm:
        x = torch.randint(0, r.num_classes, (batch, *r.input_shape), generator=gen,
                          device=device, dtype=torch.int32)
        y = x
    else:
        x = torch.randn(batch, *r.input_shape, generator=gen, device=device)
        y = torch.randint(0, r.num_classes, (batch,), generator=gen, device=device)

    box = {"state": state}

    def step():
        box["state"], _ = engine.train_step(box["state"], x, y, gen)

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    device_step_ms = _events_ms(step, steps)
    peak_bytes = torch.cuda.max_memory_allocated(device)

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    per_kernel = sorted(((e.key, _device_us(e) / 1e3 / steps, e.count // steps) for e in kernels),
                        key=lambda r: -r[1])
    fused_ms = sum(ms for name, ms, _ in per_kernel if _category(name) == "fused_update")
    categories: dict = {}
    for name, ms, _ in per_kernel:
        cat = _category(name)
        categories[cat] = categories.get(cat, 0.0) + ms

    heads_major_ms = None
    if lm:
        # the flash path's copies of q, k and v into heads-major [B*H, T, D],
        # three a layer, timed alone
        from theanompi_tpu_torch.models.contract import as_dtype
        from theanompi_tpu_torch.ops.flash_attention import _heads_major

        t = torch.randn(batch, r.input_shape[0], r.n_heads, r.d_model // r.n_heads,
                        generator=gen, device=device).to(as_dtype(r.compute_dtype))
        heads_major_ms = _events_ms(lambda: [_heads_major(t) for _ in range(3)], 20) * r.n_layers
        del t

    host_x = torch.empty(x.shape, dtype=x.dtype).pin_memory()
    h2d_ms = _events_ms(lambda: x.copy_(host_x, non_blocking=True), 10)

    if lm:
        data = LMSynthetic_data(seq_len=r.input_shape[0], vocab=64,
                                n_train=host_batches * batch, n_val=0)
    else:
        data = Synthetic_data(n_train=host_batches * batch, n_val=0,
                              image_shape=r.input_shape, n_classes=r.num_classes)
    times = []
    it = data.train_epoch(0, batch)
    while True:
        t0 = time.perf_counter()
        try:
            xb, _ = next(it)
        except StopIteration:
            break
        torch.from_numpy(np.ascontiguousarray(xb)).pin_memory()
        times.append((time.perf_counter() - t0) * 1e3)
    host_batch_ms = sum(times[1:]) / max(1, len(times) - 1)

    return {
        "device": torch.cuda.get_device_name(device),
        "model": model.name,
        "pool_kernel": bool(getattr(model, "pool_kernel", False)),
        "batch": batch,
        "steps": steps,
        "device_step_ms": device_step_ms,
        "device_images_per_sec": batch / (device_step_ms / 1e3),
        "profiled_wall_ms_per_step": wall_ms,
        "busy_ms_per_step": busy_ms if kernels else None,
        "idle_share": (1 - busy_ms / wall_ms) if kernels else None,
        "fused_update_ms_per_step": fused_ms if kernels else None,
        "fused_update_share": fused_ms / busy_ms if kernels and busy_ms else None,
        "flash_ms_per_step": categories.get("flash_attention") if kernels else None,
        "pool_kernel_ms_per_step": categories.get("pool_kernel") if kernels else None,
        "heads_major_ms_per_step": heads_major_ms,
        "peak_memory_bytes": peak_bytes,
        "categories": categories if kernels else None,
        "kernels": [{"name": n[:120], "ms_per_step": ms, "launches_per_step": c}
                    for n, ms, c in per_kernel[:top]],
        "h2d_ms": h2d_ms,
        "host_batch_ms": host_batch_ms,
        "host_batch_ms_each": times,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["alexnet", "lm", "googlenet"], default="alexnet",
                   help="AlexNet (fused update), TransformerLM_136M (Adam, flash kernels) or "
                        "GoogLeNet (fused update, pool kernels)")
    p.add_argument("--no-pool-kernel", action="store_true",
                   help="GoogLeNet's inception pools on F.max_pool2d instead of the pool kernels")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None, help="also write the JSON summary here")
    args = p.parse_args(argv)
    result = profile(steps=args.steps, model_name=args.model,
                     pool_kernel=not args.no_pool_kernel)
    for k in result["kernels"]:
        print(f"{k['ms_per_step']:9.4f} ms  x{k['launches_per_step']:<4d} {k['name']}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
