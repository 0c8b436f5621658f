"""Where a full-width training step's time goes on the card.

    python -m theanompi_tpu_torch.tools.profile_step
        [--model alexnet|lm|googlenet|wrn|resnet50|vgg16]
        [--no-pool-kernel] [--dataset synthetic|imagenet_synthetic|imagenet]
        [--root SHARD_DIR] [--steps 10] [--out PATH]

Builds a one-card training path as the training loop does: AlexNet's
recipe (``BSPEngine`` with ``--fused-update``, batch 128, 227x227x3,
1000 classes, bf16 compute), with ``--model lm`` TransformerLM_136M's
(batch 8 windows of 1024 tokens, 32k vocab, bf16 compute, Adam, the
flash kernels), or with ``--model googlenet`` full-width GoogLeNet's at
the repo's single-card batch 512 (224x224x3, 1000 classes, bf16 compute,
``--fused-update``, the inception pools on the pool kernels unless
``--no-pool-kernel``), or with ``--model wrn|resnet50|vgg16`` the zoo's
WRN-28-10 at config #1's batch 128 (32x32x3, 10 classes, fp32, Nesterov),
ResNet-50 at 256 or VGG16 at 128 (224x224x3, 1000 classes, bf16), all
``--fused-update``, and measures, on the card:

- ``device_step_ms``: one training step with the batch already on the
  card (CUDA events over ``--steps`` steps, after warm-up) — the step
  without the host input pipeline; with a uint8 ``--dataset`` the batch
  is uint8 and the step normalizes it on the card;
- ``busy_ms_per_step`` / ``idle_share``: the device's kernel time per step
  under ``torch.profiler`` (kernels on one stream do not overlap, so their
  sum is the busy time) against the step's wall time;
- ``kernels``: device time per kernel name per step, largest first, with
  the fused optimizer kernel's share;
- ``pad_ms_per_step``: the device time of ``aten::constant_pad_nd`` (the
  ``F.pad`` copies of SAME convolutions with asymmetric padding and of
  padded max pools) per step, and ``pad_calls_per_step``;
- ``heads_major_ms_per_step`` (LM): the copies of q, k and v into the
  flash kernels' heads-major layout, three a layer, timed alone;
- ``h2d_ms``: the pinned, non-blocking copy of one input batch;
- ``categories``: the same device time summed by kind of kernel
  (flash attention, the pool kernels, convolution/GEMM (cuDNN's FFT
  convolutions included), cuDNN layout
  transforms, dtype casts and copies, elementwise, pooling, reductions,
  the fused optimizer update, other);
- ``feed``: the host side of one train batch of ``--dataset`` as the
  training loop's prefetch thread makes it (``feed_times``: written
  into pinned memory), medians over ``host_batches`` batches (the first,
  which allocates, left out): ``gather_ms`` (the dataset's ``next()``
  less its crop: the row gather, native for uint8, and its draws),
  ``crop_ms`` (the native crop + mirror; 0 where there is none),
  ``pin_ms`` (making the pinned tensors: near 0 for a batch written into
  pinned memory, a copy otherwise), ``host_batch_ms`` (their sum, the
  prefetch thread's work a batch) and ``h2d_ms`` (the non-blocking copy
  of the pinned batch to the card, CUDA events), beside
  ``device_step_ms``; ``feed_fresh``: the same written into fresh arrays
  and then copied into pinned memory (the reference's order). ``synthetic`` is
  the float32 ``Synthetic_data``, ``imagenet_synthetic`` uint8 pixels,
  ``imagenet`` the ``.npy`` shards under ``--root`` (default: 256x256
  shards written to a temporary directory). For the LM: token windows
  of the model's shape from a 64-symbol chain (the gather does not
  depend on the vocabulary). ``host_batch_ms`` and
  ``host_batch_ms_each`` repeat the feed's figures.

The last stdout line is the JSON summary (also written to ``--out``).
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

import numpy as np
import torch

from theanompi_tpu_torch import native
from theanompi_tpu_torch.data import get_dataset
from theanompi_tpu_torch.data.imagenet import write_shards
from theanompi_tpu_torch.data.lm import LMSynthetic_data
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.data.loader import host_tensors, pinned_array
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.googlenet import GoogLeNet
from theanompi_tpu_torch.models.lm import TransformerLM_136M
from theanompi_tpu_torch.launch.session import resolve_model
from theanompi_tpu_torch.models import MODEL_REGISTRY
from theanompi_tpu_torch.parallel.bsp import BSPEngine
from theanompi_tpu_torch.tools.bench import MODELS
from theanompi_tpu_torch.train import make_input_transform


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt, own: bool = True) -> float:
    """An event's device time; ``own=False``: with that of the ops it calls."""
    prefix = "self_" if own else ""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
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
    ("conv_gemm", ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "nvjet",
                   "fft", "pointwise_mult_and_sum_complex")),
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
# the zoo's models, built as the benchmark builds them (tools/bench.py)
ZOO_MODELS = ("wrn", "resnet50", "vgg16")
# the side of the ImageNet shards' images (the reference's 256x256 file-batches)
SHARD_SIDE = 256
CROP_FUNCTIONS = ("tmpi_crop_mirror_u8", "tmpi_crop_mirror_normalize")


def temp_shards(directory: str, n_train: int, n_val: int, n_classes: int = 1000,
                side: int = SHARD_SIDE, seed: int = 0, shard_size: int = 1024) -> str:
    """Random uint8 ``side`` x ``side`` x 3 ImageNet shards (and labels)
    written under ``directory`` by ``write_shards``, drawn from ``seed``
    a shard at a time; returns ``directory``."""
    r = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        imgs = np.empty((n, side, side, 3), np.uint8)
        for i in range(0, n, shard_size):
            k = min(shard_size, n - i)
            imgs[i:i + k] = r.randint(0, 256, size=(k, side, side, 3))
        write_shards(directory, split, imgs, r.randint(0, n_classes, n), shard_size=shard_size)
    return directory


def feed_dataset(name: str, recipe, n_train: int, n_val: int = 0, root: str = None):
    """The dataset ``name`` at ``recipe``'s shapes, as the training loop
    builds it: ``synthetic`` (float32), ``imagenet_synthetic`` (uint8) or
    ``imagenet`` over the shards under ``root``."""
    if name == "synthetic":
        return get_dataset(name, n_train=n_train, n_val=n_val,
                           image_shape=tuple(recipe.input_shape), n_classes=recipe.num_classes)
    if name == "imagenet_synthetic":
        return get_dataset(name, n_train=n_train, n_val=n_val, crop=recipe.input_shape[0],
                           n_classes=recipe.num_classes)
    if name == "imagenet":
        return get_dataset(name, root=root, crop=recipe.input_shape[0])
    raise ValueError(f"no feed figures for dataset {name!r}")


def feed_times(data, batch: int, device, n_batches: int, into_pinned: bool = True) -> dict:
    """The host side of ``n_batches`` train batches of ``data`` (after one
    more that is left out), each made as the training loop's prefetch
    thread makes it, with ``device``'s copy of it: per batch and as
    medians, gather / crop / pin / host batch / H2D ms (see the module
    docstring). ``into_pinned``: the dataset's native calls write each
    batch into pinned memory, as the loop does on the card (every
    fixed-width dtype: uint8 and float32 images, int32 windows); False:
    into fresh arrays, then copied into pinned memory (the reference's
    order).
    ``written_into_pinned`` says which happened. On a CPU ``device``
    nothing is pinned and H2D is None (not measured)."""
    pin = device.type == "cuda"
    it = data.train_epoch(0, batch, out=pinned_array if pin and into_pinned else None)
    each = {k: [] for k in ("gather_ms", "crop_ms", "pin_ms", "host_batch_ms", "h2d_ms")}
    x_dev = y_dev = None
    for i in range(n_batches + 1):
        crop0 = sum(native.LOADER.seconds[f] for f in CROP_FUNCTIONS)
        t0 = time.perf_counter()
        x, y = next(it)
        t1 = time.perf_counter()
        xt, yt = host_tensors((x, y), pin=pin)
        t2 = time.perf_counter()
        crop_ms = (sum(native.LOADER.seconds[f] for f in CROP_FUNCTIONS) - crop0) * 1e3
        h2d_ms = None  # a copy to the card: only where there is one
        if device.type == "cuda":
            if x_dev is None:
                x_dev = torch.empty(xt.shape, dtype=xt.dtype, device=device)
                y_dev = torch.empty(yt.shape, dtype=yt.dtype, device=device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x_dev.copy_(xt, non_blocking=True)
            y_dev.copy_(yt, non_blocking=True)
            end.record()
            end.synchronize()
            h2d_ms = start.elapsed_time(end)
        if i == 0:  # the first batch allocates
            continue
        each["gather_ms"].append((t1 - t0) * 1e3 - crop_ms)
        each["crop_ms"].append(crop_ms)
        each["pin_ms"].append((t2 - t1) * 1e3)
        each["host_batch_ms"].append((t2 - t0) * 1e3)
        each["h2d_ms"].append(h2d_ms)
    return {
        # the batch went to the card as written, with no pin copy
        "written_into_pinned": pin and xt.data_ptr() == x.ctypes.data,
        "dataset": data.name, "batch": batch, "dtype": str(x.dtype),
        "batch_bytes": int(x.nbytes), "batches": n_batches,
        "native_threads": native.default_threads(),
        **{k: statistics.median(v) if None not in v else None for k, v in each.items()},
        "each": each,
    }


def profile(steps: int = 10, warmup: int = 3, top: int = 15, host_batches: int = 11,
            model_name: str = "alexnet", pool_kernel: bool = True,
            dataset: str = "synthetic", root: str = None) -> dict:
    device = resolve_device(None)
    lm = model_name == "lm"
    if lm:
        model = TransformerLM_136M()
    elif model_name == "googlenet":
        model = GoogLeNet(GoogLeNet.default_recipe().replace(batch_size=GOOGLENET_BATCH),
                          pool_kernel=pool_kernel)
    elif model_name in ZOO_MODELS:
        zoo, batch = MODELS[model_name]
        cls = resolve_model(zoo, MODEL_REGISTRY[zoo][1])
        model = cls(cls.default_recipe().replace(batch_size=batch))
    else:
        model = AlexNet()
    r = model.recipe
    batch = r.batch_size
    n_host = (host_batches + 1) * batch
    with tempfile.TemporaryDirectory() as tmp:
        if lm:
            data = LMSynthetic_data(seq_len=r.input_shape[0], vocab=64, n_train=n_host, n_val=0)
        else:
            if dataset == "imagenet" and root is None:
                root = temp_shards(tmp, n_host, 0)
            data = feed_dataset(dataset, r, n_host, root=root)
        feed = feed_times(data, batch, device, host_batches)
        feed_fresh = feed_times(data, batch, device, host_batches, into_pinned=False)
    spec = getattr(data, "device_transform", None)
    del data
    # Adam (the LM's rule) has no fused form
    engine = BSPEngine(model, 1, device, steps_per_epoch=10_000, fused_update=not lm,
                       input_transform=make_input_transform(spec, device))
    state = engine.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    if lm:
        x = torch.randint(0, r.num_classes, (batch, *r.input_shape), generator=gen,
                          device=device, dtype=torch.int32)
        y = x
    elif spec is not None:  # uint8 pixels, normalized in the step
        x = torch.randint(0, 256, (batch, *r.input_shape), generator=gen, device=device,
                          dtype=torch.uint8)
        y = torch.randint(0, r.num_classes, (batch,), generator=gen, device=device)
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
    pads = [e for e in prof.key_averages() if e.key == "aten::constant_pad_nd"]
    pad_ms = sum(_device_us(e, own=False) for e in pads) / 1e3 / steps
    pad_calls = sum(e.count for e in pads) // steps
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
        "pad_ms_per_step": pad_ms if kernels else None,
        "pad_calls_per_step": pad_calls,
        "heads_major_ms_per_step": heads_major_ms,
        "peak_memory_bytes": peak_bytes,
        "categories": categories if kernels else None,
        "kernels": [{"name": n[:120], "ms_per_step": ms, "launches_per_step": c}
                    for n, ms, c in per_kernel[:top]],
        "dataset": dataset if not lm else "lm_synthetic",
        "feed": feed,
        "feed_fresh": feed_fresh,
        "h2d_ms": feed["h2d_ms"],
        "host_batch_ms": feed["host_batch_ms"],
        "host_batch_ms_each": feed["each"]["host_batch_ms"],
        "host_over_device_step": feed["host_batch_ms"] / device_step_ms,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["alexnet", "lm", "googlenet", *ZOO_MODELS],
                   default="alexnet",
                   help="AlexNet (fused update), TransformerLM_136M (Adam, flash kernels), "
                        "GoogLeNet (fused update, pool kernels), or WRN-28-10, ResNet-50 or "
                        "VGG16 (fused update)")
    p.add_argument("--no-pool-kernel", action="store_true",
                   help="GoogLeNet's inception pools on F.max_pool2d instead of the pool kernels")
    p.add_argument("--dataset", choices=["synthetic", "imagenet_synthetic", "imagenet"],
                   default="synthetic",
                   help="the feed whose host figures are measured: float32 synthetic, uint8 "
                        "imagenet_synthetic, or uint8 imagenet shards (CNNs only)")
    p.add_argument("--root", default=None,
                   help="--dataset imagenet: the shard directory (default: random 256x256 "
                        "shards in a temporary directory)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None, help="also write the JSON summary here")
    args = p.parse_args(argv)
    if args.model == "lm" and args.dataset != "synthetic":
        p.error("--dataset applies to the CNNs; the LM is fed token windows")
    result = profile(steps=args.steps, model_name=args.model,
                     pool_kernel=not args.no_pool_kernel, dataset=args.dataset,
                     root=args.root)
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
