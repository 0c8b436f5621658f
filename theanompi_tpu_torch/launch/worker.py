"""The training loop: epochs, validation, summary.

Port of ``theanompi_tpu/launch/worker.py::run_training`` for rule
``bsp``, with the reference's dataset/recipe checks, the epoch loop with
``max_steps``, a validation pass per epoch, ``print_freq`` logging, and
a summary dict whose keys match the reference's where they exist
(``steps``, ``epochs``, ``val``, ``images_per_sec``, ``train_loop_s``).
For an LM (``model.is_lm``) ``--synthetic`` means the ``lm_synthetic``
token dataset, a batch row is one token window, and ``images_per_sec``
counts sequences.
Checkpoints and resume (``ckpt_dir``, ``resume``): after validation at
each epoch end, and after a ``max_steps`` cut, every rank gathers its
error-feedback residuals and dropout generator state to rank 0, which
writes ``ckpt_<step>.npz`` in the reference's format
(``utils/checkpoint.py``; ``bridge.state_entries``), on the writer
thread of an ``AsyncCheckpointer`` unless ``async_checkpoint=False``.
``resume=True`` loads the newest verified checkpoint on every rank (all
ranks must resolve the same step), restores each rank's residual row and
generator, and starts at epoch ``step // steps_per_epoch``, skipping the
batches of a mid-epoch checkpoint that the restored steps consumed, so
the data and dropout streams continue bit for bit. ``max_steps`` counts
from step 0 of the run's timeline. An exception in a one-rank run saves
the last whole step first (the crash save). The JAX package reads these
files and the port reads the JAX package's; a JAX file carries no torch
generator state, so the dropout stream then starts from the seed.
The recorder (``utils/recorder.py``; files on rank 0 under
``save_dir``) gets one ``train`` row a step from the loop's drains,
``val`` and ``epoch`` rows, and prints the reference's console lines.
The supervisor and elastic resume come in later slices.

Ranks. With ``devices=n > 1`` this function runs in each of n rank
processes of one process group (``launch/session.py`` spawns them). As
in the reference, ``recipe.batch_size`` is the GLOBAL batch: every rank
walks the same shuffled global batches and gathers only its rows
``[r·B/n, (r+1)·B/n)``; its dropout stream is seeded from ``(seed,
rank)``. Rank 0 prints; every rank returns the summary, which carries
each rank's step time and kernel launch counts and, with several ranks,
a digest of each rank's params and optimizer state (equal on every rank
when the replicas agree) and of its error-feedback residuals.

Hot loop. A ``PrefetchLoader`` thread (``tmpi-prefetch``, pinned to
``TMPI_LOADER_CPUS`` when set) gathers each host batch (uint8 datasets
through the native gather and crop, ``native/``) into pinned memory
(``data/loader.py::pinned_array``; a batch made elsewhere is copied
there); the loop copies it to the card with ``non_blocking=True`` and
dispatches the step, which never waits on the device. A dataset with a ``device_transform``
ships uint8 batches, and the step computes ``(x - mean) * scale`` on the
card (``train.make_input_transform``); one with ``val_views > 1`` ships
that many view-major rows per validation image, whose logits the eval
step averages. The host reads losses back only every ``print_freq``
steps and at epoch ends. Step time comes from CUDA events recorded after
every step (``time.perf_counter`` on the CPU, where ops are
synchronous); the first ``WARMUP_STEPS`` steps of a run are left out of
the steady-state figures, as they are from ``feed_wait_ms``, the host
time the loop spent waiting for the loader a step (near 0 when the card,
not the feed, paces the run).

Groups (``steps_per_dispatch = k > 1``, the reference's fused dispatch):
the loop takes up to k batches of one epoch at a time, the last group of
a run trimmed to land on ``max_steps``, and runs them through
``BSPEngine.fused_train_step``: on the card each step replays one
captured CUDA graph of the step (``graphs.py``), its batch copied from
pinned memory into the graph's input buffer; on the CPU the steps run
eagerly. Each step keeps its recorder row, its CUDA-event interval and
its wait, and saves fall where the per-step loop's do (epoch ends, the
``max_steps`` cut), since no group crosses them. A group enqueues
without waiting for the card, so the drains every ``print_freq`` steps
are what bound how far the host runs ahead.
"""

from __future__ import annotations

import hashlib
import itertools
import math
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch import bridge, native
from theanompi_tpu_torch.data import get_dataset
from theanompi_tpu_torch.data.loader import PrefetchLoader, host_tensors, pinned_array
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.ops.kernels import launch_counts
from theanompi_tpu_torch.parallel.bsp import BSPEngine, check_fused_ranks
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.distributed import agree_on_step, all_gather_objects, gather_tree
from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice, rank_generator
from theanompi_tpu_torch.train import make_input_transform
from theanompi_tpu_torch.tree import tree_leaves
from theanompi_tpu_torch.utils.checkpoint import (
    TORCH_RNG_KEY,
    AsyncCheckpointer,
    checkpoint_step,
    integrity_manifest,
    latest_checkpoint,
    load_checkpoint,
    manifest_digest,
    save_checkpoint,
    to_numpy,
)
from theanompi_tpu_torch.utils.recorder import Recorder

# summary["losses"] keeps the most recent per-step losses
LOSS_HISTORY = 1000
# host batches the prefetch thread may hold ready (19.8 MB each for
# AlexNet's uint8 ImageNet batch, 79 MB for its float32 synthetic one)
PREFETCH_DEPTH = 2
# first steps of a run left out of the steady-state step time (cuDNN
# set-up, the kernel library's first load)
WARMUP_STEPS = 2


def _digest(tensors) -> str:
    """SHA-256 (hex, 16 digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


class _StepClock:
    """Marks after each step: CUDA events on the card, host time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def intervals_ms(self, marks) -> list:
        """Milliseconds between consecutive marks (syncs on the last)."""
        if len(marks) < 2:
            return []
        if self.cuda:
            marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]




def _checkpoint_entries(state, layouts, step_gen, devices: int, rank: int):
    """The entries of a checkpoint of ``state`` on rank 0 (None on the
    others): the state in the reference's layout, every rank's residuals
    as ``.ef`` stacks and every rank's dropout generator state as
    ``__torch_rng__`` (``[n, L]`` uint8). Collective: every rank calls it,
    on the training thread."""
    ef_ranks = gather_tree(state.ef, devices) if tree_leaves(state.ef) else None
    gens = all_gather_objects(step_gen.get_state().numpy(), devices)
    if rank != 0:
        return None
    entries = bridge.state_entries(state, layouts, ef_ranks)
    entries[TORCH_RNG_KEY] = np.stack(gens)
    return entries


def run_training(
    rule: str = "bsp",
    model_cls: type = None,
    devices: int = 1,
    *,
    device=None,
    fused_update: bool = False,
    pool_kernel: bool = False,
    strategy: str = "psum",
    wire_codec: str = "none",
    n_epochs: Optional[int] = None,
    max_steps: Optional[int] = None,
    dataset: Optional[str] = None,
    dataset_kwargs: Optional[dict] = None,
    recipe_overrides: Optional[dict] = None,
    seed: int = 0,
    save_dir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    async_checkpoint: bool = True,
    resume: bool = False,
    print_freq: int = 40,
    steps_per_dispatch: int = 1,
    accum_steps: int = 1,
) -> dict:
    """Train ``model_cls`` under a sync rule; returns a summary dict.

    ``device``: ``None`` runs on the current CUDA device and raises when
    there is none; ``"cpu"`` runs on the CPU because it was asked for.
    ``devices``: how many ranks (cards) the rule spans; more than one
    needs this process to be a rank of a process group of that size.
    ``strategy`` / ``wire_codec``: the gradient exchange
    (``parallel/strategies.py``, ``parallel/codec.py``). ``pool_kernel``:
    the model routes its 3x3/stride-1 max pools to the pool kernels
    (``ops/pool.py``; a model with no such pool refuses). ``save_dir``:
    the recorder's JSONL log and pickled history. ``ckpt_dir``,
    ``async_checkpoint``, ``resume``: checkpoints (module docstring).
    ``steps_per_dispatch``: steps a group (module docstring; several
    ranks on the card are refused, ``bsp.check_fused_ranks``).
    ``accum_steps``: microbatches a step, their gradients averaged
    before the one update (each rank's batch must divide by it)."""
    device = resolve_device(device)
    k = int(steps_per_dispatch)
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    if int(accum_steps) < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    check_fused_ranks(devices, k, device)
    if model_cls is None:
        raise ValueError("model_cls is required")
    rule = rule.lower()
    if rule != "bsp":
        raise ValueError(f"rule {rule!r} is not ported yet; available: bsp")

    recipe = model_cls.default_recipe()
    if recipe_overrides:
        recipe = recipe.replace(**recipe_overrides)
    model: Model = model_cls(recipe, pool_kernel=pool_kernel)

    dataset = dataset or recipe.dataset
    if dataset == "synthetic" and getattr(model, "is_lm", False):
        # `--synthetic` on an LM means synthetic TOKENS, not float images
        dataset = "lm_synthetic"
    dataset_kwargs = dict(dataset_kwargs or {})
    if dataset in ("synthetic", "imagenet_synthetic"):
        # synthetic stand-ins default to the MODEL's shapes
        if dataset == "synthetic":
            dataset_kwargs.setdefault("image_shape", tuple(recipe.input_shape))
        else:
            dataset_kwargs.setdefault("crop", recipe.input_shape[0])
        dataset_kwargs.setdefault("n_classes", recipe.num_classes)
    elif dataset in ("lm_synthetic", "lm_text"):
        # token datasets default to the MODEL's sequence length / vocab
        dataset_kwargs.setdefault("seq_len", recipe.input_shape[0])
        if dataset == "lm_synthetic":
            dataset_kwargs.setdefault("vocab", recipe.num_classes)
    batch = recipe.batch_size
    if (batch // max(1, devices)) % int(accum_steps):
        raise ValueError(f"each rank's batch ({batch} / {devices} ranks) must divide into "
                         f"accum_steps={accum_steps} microbatches")

    data = get_dataset(dataset, **dataset_kwargs)
    if tuple(data.image_shape) != tuple(recipe.input_shape):
        raise ValueError(
            f"dataset {dataset!r} yields images {tuple(data.image_shape)} but "
            f"model {model_cls.__name__} expects {tuple(recipe.input_shape)}; "
            "pass --dataset-arg values matching the recipe (or override "
            "recipe.input_shape)"
        )
    if data.n_classes != recipe.num_classes:
        raise ValueError(
            f"dataset {dataset!r} has {data.n_classes} classes but model head "
            f"expects {recipe.num_classes} (override recipe.num_classes or the "
            "dataset's n_classes)"
        )
    steps_per_epoch = data.n_train_batches(batch)
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset has {data.n_train} train examples < the batch {batch} "
            "(= recipe.batch_size)"
        )
    n_epochs = n_epochs if n_epochs is not None else recipe.n_epochs
    vbatch = recipe.val_batch_size or batch
    if data.n_val and vbatch > data.n_val:
        raise ValueError(
            f"val batch {vbatch} exceeds the dataset's {data.n_val} val "
            "examples — validation would silently run zero batches "
            "(set recipe val_batch_size or enlarge the val split)"
        )

    # uint8 batches normalized on the card, multi-view validation: the
    # dataset's opt-ins (reference worker.py:604-616)
    input_transform = make_input_transform(getattr(data, "device_transform", None), device)
    eval_views = int(getattr(data, "val_views", 1))
    engine = BSPEngine(model, devices, device, steps_per_epoch=steps_per_epoch,
                       fused_update=fused_update, strategy=strategy, wire_codec=wire_codec,
                       input_transform=input_transform, eval_views=eval_views,
                       accum_steps=accum_steps)
    rank = dist.get_rank() if devices > 1 else 0
    shard = host_local_batch_slice(batch, rank, devices)
    vshard = host_local_batch_slice(vbatch, rank, devices)
    state = engine.init_state(torch.Generator().manual_seed(seed))
    layouts = model.param_layouts(state.params)
    # dropout masks: an explicit generator per rank on its card (the
    # global RNG is never touched)
    step_gen = (rank_generator(seed + 1, rank, device) if devices > 1
                else torch.Generator(device=device).manual_seed(seed + 1))
    pin = device.type == "cuda"
    clock = _StepClock(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    summary: dict = {"epochs": [], "rule": rule, "model": model.name,
                     "device": str(device), "fused_update": bool(fused_update),
                     "pool_kernel": bool(pool_kernel),
                     "batch_size": batch, "devices": devices, "strategy": strategy,
                     "wire_codec": get_codec(wire_codec).spec, "dataset": dataset,
                     "device_normalize": input_transform is not None, "eval_views": eval_views,
                     "steps_per_dispatch": k, "accum_steps": engine.accum_steps,
                     "resumed_from_step": None}

    start_epoch = 0
    if resume and ckpt_dir:
        t0 = time.perf_counter()
        # verify=True walks back past a corrupt or truncated newest file
        path = latest_checkpoint(ckpt_dir, verify=True)
        verify_ms = (time.perf_counter() - t0) * 1e3
        if devices > 1:
            agree_on_step(checkpoint_step(path), devices)
        if path:
            t0 = time.perf_counter()
            flat = load_checkpoint(path)
            state = bridge.state_from_flat(flat, state, layouts, rank=rank, world=devices)
            saved = flat.get(TORCH_RNG_KEY)
            own = step_gen.get_state()
            rng_restored = saved is not None and saved.shape == (devices, own.numel())
            if rng_restored:
                step_gen.set_state(torch.from_numpy(saved[rank].copy()))
            elif rank == 0:
                print(f"[rank 0] {path} holds no dropout generator state of this run "
                      f"({'none' if saved is None else f'shape {saved.shape}'}; this run's "
                      f"{devices} x {own.numel()} bytes): the dropout stream starts from the "
                      "seed, as a fresh run's does", flush=True)
            sync()
            load_ms = (time.perf_counter() - t0) * 1e3
            step0 = engine.get_step(state)
            start_epoch = step0 // steps_per_epoch
            summary["resumed_from_step"] = step0
            # what the resumed run holds, digested as a save would write
            # it: equal to the digest the writer recorded at that step
            entries = _checkpoint_entries(state, layouts, step_gen, devices, rank)
            if rank == 0:
                if not rng_restored:
                    entries.pop(TORCH_RNG_KEY)
                digest = manifest_digest(integrity_manifest(
                    {k: to_numpy(v) for k, v in entries.items()}))
                summary["resume"] = {"path": path, "step": step0, "verify_ms": verify_ms,
                                     "load_ms": load_ms, "digest": digest,
                                     "torch_rng_restored": rng_restored}
                print(f"resumed from {path} at step {step0}", flush=True)

    def place(batch):
        return host_tensors(batch, pin)

    def to_device(t):
        return t.to(device, non_blocking=True)

    rec = Recorder(rank=rank, print_freq=print_freq if rank == 0 else 0,
                   save_dir=save_dir if rank == 0 else None, run_name=f"{model.name}_{rule}")
    writer = AsyncCheckpointer() if (ckpt_dir and async_checkpoint and rank == 0) else None
    saves: list = []  # rank 0's sync saves; the writer keeps its own records

    def save(state, step: int, sync_write: bool = False) -> None:
        """Collective: every rank gathers, rank 0 writes (on the writer
        thread unless there is none or ``sync_write``)."""
        t0 = time.perf_counter()
        entries = _checkpoint_entries(state, layouts, step_gen, devices, rank)
        if rank != 0:
            return
        if writer is not None and not sync_write:
            writer.save(ckpt_dir, entries, step)
            return
        flat = {k: to_numpy(v) for k, v in entries.items()}
        info = {"step": step, "gather_ms": (time.perf_counter() - t0) * 1e3}
        info["path"] = save_checkpoint(ckpt_dir, flat, step, info=info)
        info["loop_ms"] = (time.perf_counter() - t0) * 1e3
        saves.append(info)

    losses: deque = deque(maxlen=LOSS_HISTORY)
    nonfinite = 0
    intervals: list = []  # steady-state step ms, all epochs
    waits: list = []  # host ms waiting for the loader, a step, all epochs
    epoch_step_ms: list = []  # each epoch's steady-state mean
    seen_intervals = 0
    train_loop_s = 0.0
    step_count = summary["resumed_from_step"] or 0
    last_ckpt_step = step_count if summary["resumed_from_step"] is not None else -1
    # a mid-epoch checkpoint: the batches its steps consumed are skipped
    skip_batches = step_count % steps_per_epoch
    torn = False  # True while a step may be half applied (in-place update)

    def drain(pending: list, marks: list, epoch_ivals: list):
        """Read the pending steps' metrics back in one copy, and record a
        row per step with its time from the step events."""
        nonlocal nonfinite
        if not pending:
            return
        keys = sorted(pending[0][1])
        vals = torch.stack([torch.stack([torch.as_tensor(m[k]).float().reshape(()) for k in keys])
                            for _, m, _ in pending]).cpu().tolist()
        ivals = clock.intervals_ms(marks[-(len(pending) + 1):])
        for (step, _, wait_ms), row, ms in zip(pending, vals, ivals):
            metrics = dict(zip(keys, row))
            nonfinite += not math.isfinite(metrics["loss"])
            losses.append(metrics["loss"])
            rec.note_time("wait", wait_ms / 1e3)
            rec.note_time("step", ms / 1e3)
            rec.train_metrics(step, metrics, n_images=batch)
        epoch_ivals += ivals
        pending.clear()

    try:
        for epoch in range(start_epoch, n_epochs):
            if max_steps and step_count >= max_steps:
                break
            rec.start_epoch()
            t_loop0 = time.perf_counter()
            marks = [clock.mark()]
            pending: list = []
            epoch_ivals: list = []
            epoch_waits: list = []
            epoch_steps = 0
            # on the card, the native loader writes each batch into pinned memory
            source = data.train_epoch(epoch, batch, seed=seed, rows=shard,
                                      out=pinned_array if pin else None)
            if skip_batches:
                source = itertools.islice(source, skip_batches, None)
                skip_batches = 0
            with PrefetchLoader(source, place, depth=PREFETCH_DEPTH) as batches:
                while True:
                    # a group of up to k batches, never past max_steps
                    # and never across an epoch
                    want = min(k, max_steps - step_count) if max_steps else k
                    group = []
                    while len(group) < want:
                        t_wait = time.perf_counter()
                        try:
                            x, y = next(batches)
                        except StopIteration:
                            break
                        group.append((x, y, (time.perf_counter() - t_wait) * 1e3))
                    if not group:
                        break
                    torn = True
                    if k == 1:
                        x, y, _ = group[0]
                        state, metrics = engine.train_step(state, to_device(x), to_device(y),
                                                           step_gen)
                        marks.append(clock.mark())
                        rows = [metrics]
                    else:
                        state, metrics = engine.fused_train_step(
                            state, [g[0] for g in group], [g[1] for g in group], step_gen,
                            after_step=lambda: marks.append(clock.mark()))
                        rows = [{key: v[i] for key, v in metrics.items()}
                                for i in range(len(group))]
                    torn = False
                    first = step_count
                    for (_, _, wait_ms), row in zip(group, rows):
                        step_count += 1
                        epoch_steps += 1
                        epoch_waits.append(wait_ms)
                        pending.append((step_count, row, wait_ms))
                    if print_freq and step_count // print_freq > first // print_freq:
                        drain(pending, marks, epoch_ivals)
                    if len(group) < want or (max_steps and step_count >= max_steps):
                        break
            drain(pending, marks, epoch_ivals)
            rec.end_epoch(epoch, n_images=epoch_steps * batch)
            skip = max(0, WARMUP_STEPS - seen_intervals)
            seen_intervals += len(epoch_ivals)
            steady = epoch_ivals[skip:]
            intervals += steady
            epoch_step_ms.append(sum(steady) / len(steady) if steady else None)
            # the wait before a step falls in that step's interval
            waits += epoch_waits[skip:]
            train_loop_s += time.perf_counter() - t_loop0

            val_sum, n_val = None, 0
            for vx, vy in data.val_epoch(vbatch, rows=vshard):
                vx, vy = place((vx, vy))
                vm = engine.eval_step(state, to_device(vx), to_device(vy))
                val_sum = vm if val_sum is None else {k: val_sum[k] + vm[k] for k in vm}
                n_val += 1
            if n_val:
                summary["val"] = {k: float(v) / n_val for k, v in val_sum.items()}
                rec.val_metrics(epoch, summary["val"])
            if ckpt_dir:
                rec.start("checkpoint")
                save(state, step_count)
                rec.end("checkpoint")
                last_ckpt_step = step_count
            rec.save()
            summary["epochs"].append(epoch)
    except Exception:
        # the crash save: the newest whole step must not be lost. A save
        # is collective, so it runs only where no other rank can be left
        # waiting in it.
        if ckpt_dir and step_count > last_ckpt_step:
            if devices > 1:
                print(f"[rank {rank}] no crash checkpoint: a save is collective and the "
                      "other ranks may never reach it", flush=True)
            elif torn:
                print(f"[rank {rank}] no crash checkpoint: the exception came inside a step, "
                      "whose in-place update may be half applied", flush=True)
            else:
                try:
                    if writer is not None:
                        writer.wait()
                    save(state, step_count, sync_write=True)
                    print(f"[rank {rank}] crash checkpoint saved at step {step_count}", flush=True)
                except Exception as e:  # noqa: BLE001 — must not mask the training error
                    print(f"crash checkpoint failed during error unwinding (suppressed): {e!r}",
                          flush=True)
        raise
    finally:
        try:
            if writer is not None:
                # a failed background write raises here, but never in
                # place of a training exception already propagating
                if sys.exc_info()[0] is not None:
                    try:
                        writer.close()
                    except Exception as e:  # noqa: BLE001
                        print(f"checkpoint writer failed during error unwinding "
                              f"(suppressed): {e!r}", flush=True)
                else:
                    writer.close()
        finally:
            rec.close()

    summary["steps"] = step_count
    summary["device_steps"] = engine.get_step(state)
    summary["train_loop_s"] = round(train_loop_s, 6)
    recent = intervals[-50:]
    step_ms = sum(recent) / len(recent) if recent else None
    summary["step_ms"] = step_ms
    summary["steady_steps"] = len(intervals)
    summary["epoch_step_ms"] = epoch_step_ms
    graph = engine.graph
    summary["captured"] = graph is not None and graph.replays > 0
    summary["graph"] = ({"captures": graph.captures, "replays": graph.replays}
                        if graph is not None else None)
    if ckpt_dir and rank == 0:
        summary["checkpoints"] = sorted(
            [dict(r, mode="sync") for r in saves]
            + [dict(r, mode="async") for r in (writer.records if writer else [])],
            key=lambda r: r["step"])
        if writer is not None:
            summary["ckpt_storage_failures"] = writer.storage_failures
    recent_waits = waits[-50:]
    own = {"step_ms": step_ms, "kernel_launches": launch_counts(),
           "feed_wait_ms": sum(recent_waits) / len(recent_waits) if recent_waits else None,
           "native_calls": dict(native.LOADER.calls)}
    # what each rank holds at the end: the replicas must agree bit for
    # bit (and a run with its steps grouped must equal one without)
    own["replica_digest"] = _digest(tree_leaves((state.params, state.opt_state)))
    per_rank = [own]
    if devices > 1:
        # the error-feedback residuals are each rank's own
        own["ef_digest"] = _digest(tree_leaves(state.ef))
        own["ef_norm"] = float(sum(torch.sum(e.double() ** 2) for e in tree_leaves(state.ef))) ** 0.5
        per_rank = [None] * devices
        dist.all_gather_object(per_rank, own)
    for key in per_rank[0]:
        summary[f"{key}_per_rank"] = [r[key] for r in per_rank]
    # a BSP step ends when its slowest rank's does
    slowest = max((t for t in summary["step_ms_per_rank"] if t), default=None)
    summary["images_per_sec"] = batch / (slowest / 1e3) if slowest else 0.0
    summary["losses"] = list(losses)
    summary["nonfinite_steps"] = nonfinite
    return summary
