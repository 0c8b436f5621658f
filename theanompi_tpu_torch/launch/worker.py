"""The training loop: epochs, validation, summary.

Port of ``theanompi_tpu/launch/worker.py::run_training`` for rule
``bsp`` on one device, with the reference's dataset/recipe checks, the
epoch loop with ``max_steps``, a validation pass per epoch,
``print_freq`` logging, and a summary dict whose keys match the
reference's where they exist (``steps``, ``epochs``, ``val``,
``images_per_sec``, ``train_loop_s``). Observability, checkpointing,
the supervisor and elastic resume come in later slices.

Hot loop. A background thread (``tmpi-prefetch``) gathers each host
batch and pins it; the loop copies it to the card with
``non_blocking=True`` and dispatches the step, which never waits on the
device. The host reads losses back only every ``print_freq`` steps and
at epoch ends. Step time comes from CUDA events recorded after every
step (``time.perf_counter`` on the CPU, where ops are synchronous); the
first ``WARMUP_STEPS`` steps of a run are left out of the steady-state
figures.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from theanompi_tpu_torch.data import get_dataset
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.parallel.bsp import BSPEngine

# summary["losses"] keeps the most recent per-step losses
LOSS_HISTORY = 1000
# host batches the prefetch thread may hold ready (each 79 MB at AlexNet's shape)
PREFETCH_DEPTH = 2
# first steps of a run left out of the steady-state step time (cuDNN
# set-up, the kernel library's first load)
WARMUP_STEPS = 2


class _Prefetcher:
    """Runs ``source`` (an iterator of numpy (x, y) batches) on a named
    thread, turning each batch into (pinned, when ``pin``) CPU tensors,
    at most ``depth`` batches ahead. A context manager: leaving it stops
    and joins the thread."""

    _DONE = object()

    def __init__(self, source, depth: int, pin: bool):
        self._source = source
        self._pin = pin
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="tmpi-prefetch", daemon=True)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for x, y in self._source:
                xt = torch.from_numpy(np.ascontiguousarray(x))
                yt = torch.from_numpy(np.ascontiguousarray(y))
                if self._pin:
                    xt, yt = xt.pin_memory(), yt.pin_memory()
                if not self._put((xt, yt)):
                    return
            self._put(self._DONE)
        except BaseException as e:  # re-raised in the consuming thread
            self._put(e)

    def __enter__(self):
        self._thread.start()
        return self

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __exit__(self, *exc):
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30)
        return False


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


def run_training(
    rule: str = "bsp",
    model_cls: type = None,
    devices: int = 1,
    *,
    device=None,
    fused_update: bool = False,
    n_epochs: Optional[int] = None,
    max_steps: Optional[int] = None,
    dataset: Optional[str] = None,
    dataset_kwargs: Optional[dict] = None,
    recipe_overrides: Optional[dict] = None,
    seed: int = 0,
    print_freq: int = 40,
) -> dict:
    """Train ``model_cls`` under a sync rule; returns a summary dict.

    ``device``: ``None`` runs on the current CUDA device and raises when
    there is none; ``"cpu"`` runs on the CPU because it was asked for.
    ``devices``: how many cards the rule spans; this slice runs 1 and
    refuses any other count (``BSPEngine``)."""
    device = resolve_device(device)
    if model_cls is None:
        raise ValueError("model_cls is required")
    rule = rule.lower()
    if rule != "bsp":
        raise ValueError(f"rule {rule!r} is not ported yet; available: bsp")

    recipe = model_cls.default_recipe()
    if recipe_overrides:
        recipe = recipe.replace(**recipe_overrides)
    model: Model = model_cls(recipe)

    dataset = dataset or recipe.dataset
    dataset_kwargs = dict(dataset_kwargs or {})
    if dataset == "synthetic":
        # synthetic stand-in defaults to the MODEL's shapes
        dataset_kwargs.setdefault("image_shape", tuple(recipe.input_shape))
        dataset_kwargs.setdefault("n_classes", recipe.num_classes)
    batch = recipe.batch_size

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

    engine = BSPEngine(model, devices, device, steps_per_epoch=steps_per_epoch,
                       fused_update=fused_update)
    state = engine.init_state(torch.Generator().manual_seed(seed))
    # dropout masks: an explicit generator on the card (the global RNG
    # is never touched)
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)
    pin = device.type == "cuda"
    clock = _StepClock(device)

    def to_device(t):
        return t.to(device, non_blocking=True)

    summary: dict = {"epochs": [], "rule": rule, "model": model.name,
                     "device": str(device), "fused_update": bool(fused_update),
                     "batch_size": batch}
    losses: deque = deque(maxlen=LOSS_HISTORY)
    nonfinite = 0
    intervals: list = []  # steady-state step ms, all epochs
    seen_intervals = 0
    train_loop_s = 0.0
    step_count = 0

    def drain(pending: list, epoch: int):
        nonlocal nonfinite
        if not pending:
            return
        vals = torch.stack(pending).float().cpu().tolist()
        pending.clear()
        nonfinite += sum(1 for v in vals if not math.isfinite(v))
        losses.extend(vals)
        if print_freq:
            print(f"[bsp] epoch {epoch} step {step_count} loss {vals[-1]:.6f}", flush=True)

    for epoch in range(n_epochs):
        t_loop0 = time.perf_counter()
        marks = [clock.mark()]
        pending: list = []
        with _Prefetcher(data.train_epoch(epoch, batch, seed=seed), PREFETCH_DEPTH, pin) as batches:
            for x, y in batches:
                state, metrics = engine.train_step(state, to_device(x), to_device(y), step_gen)
                step_count += 1
                marks.append(clock.mark())
                pending.append(metrics["loss"])
                if print_freq and step_count % print_freq == 0:
                    drain(pending, epoch)
                if max_steps and step_count >= max_steps:
                    break
        drain(pending, epoch)
        ivals = clock.intervals_ms(marks)
        skip = max(0, WARMUP_STEPS - seen_intervals)
        seen_intervals += len(ivals)
        intervals += ivals[skip:]
        train_loop_s += time.perf_counter() - t_loop0

        val_sum, n_val = None, 0
        for vx, vy in data.val_epoch(vbatch):
            vm = engine.eval_step(state, to_device(torch.from_numpy(vx)),
                                  to_device(torch.from_numpy(vy)))
            val_sum = vm if val_sum is None else {k: val_sum[k] + vm[k] for k in vm}
            n_val += 1
        if n_val:
            summary["val"] = {k: float(v) / n_val for k, v in val_sum.items()}
            print(f"[bsp] epoch {epoch} val {summary['val']}", flush=True)
        summary["epochs"].append(epoch)
        if max_steps and step_count >= max_steps:
            break

    summary["steps"] = step_count
    summary["device_steps"] = engine.get_step(state)
    summary["train_loop_s"] = round(train_loop_s, 6)
    recent = intervals[-50:]
    step_ms = sum(recent) / len(recent) if recent else None
    summary["step_ms"] = step_ms
    summary["steady_steps"] = len(intervals)
    summary["images_per_sec"] = batch / (step_ms / 1e3) if step_ms else 0.0
    summary["losses"] = list(losses)
    summary["nonfinite_steps"] = nonfinite
    return summary
