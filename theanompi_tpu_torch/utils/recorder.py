"""Recorder: timing brackets, train/val/epoch metric history, the JSONL
log and the pickled history.

Port of ``theanompi_tpu/utils/recorder.py`` (itself Theano-MPI's
``lib/recorder.py``): ``start``/``end`` host brackets, ``note_time`` for
a time measured elsewhere, ``train_metrics`` / ``val_metrics`` /
``start_epoch`` / ``end_epoch``, one JSON object a line in
``<save_dir>/<run_name>.jsonl`` (``{"kind": "train" | "val" | "epoch",
...}``, the reference's kinds and keys), the history pickled to
``<run_name>_history.pkl`` (``load_history`` reads it back, as the
reference's does), and the same console lines.

The training loop feeds it from its drains: each step's metrics are read
back with the others of the drain, and its time comes from the CUDA
events the loop already records (``note_time("step", ...)``), so the
recorder adds no host/device synchronisation. Left out of the port until
observability is: TensorBoard, the profiler window, and the metrics
registry and span hooks.
"""

from __future__ import annotations

import json
import os
import pickle
import time
import warnings
from collections import defaultdict
from typing import Optional

import numpy as np


class Recorder:
    def __init__(self, rank: int = 0, print_freq: int = 40, save_dir: Optional[str] = None,
                 run_name: str = "run"):
        self.rank = rank
        self.print_freq = print_freq
        self.save_dir = save_dir
        self.run_name = run_name
        self._t0: dict = {}
        self.timings: dict = defaultdict(list)
        self.history: dict = defaultdict(list)
        self.epoch_start: Optional[float] = None
        self._jsonl = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._jsonl = open(os.path.join(save_dir, f"{run_name}.jsonl"), "a")

    # -- timing brackets -----------------------------------------------------
    def start(self, category: str = "calc") -> None:
        self._t0[category] = time.perf_counter()

    def end(self, category: str = "calc") -> float:
        """Close a host bracket; its seconds. Device work is not waited
        for: time the card with events and ``note_time``. An ``end``
        without its ``start`` warns and returns 0.0."""
        t0 = self._t0.pop(category, None)
        if t0 is None:
            warnings.warn(f"Recorder.end({category!r}) without a matching "
                          f"start({category!r}); returning 0.0", RuntimeWarning, stacklevel=2)
            return 0.0
        return self.note_time(category, time.perf_counter() - t0)

    def note_time(self, category: str, dt: float) -> float:
        """Record a duration (seconds) measured elsewhere."""
        dt = float(dt)
        self.timings[category].append(dt)
        return dt

    # -- metrics -------------------------------------------------------------
    def train_metrics(self, step: int, metrics: dict, n_images: int = 0) -> None:
        rec = {k: float(v) for k, v in metrics.items()}
        rec["step"] = int(step)
        if n_images and self.timings.get("step"):
            rec["images_per_sec"] = n_images / self.timings["step"][-1]
        self.history["train"].append(rec)
        self._emit("train", rec)
        if self.print_freq and len(self.history["train"]) % self.print_freq == 0:
            self._print_train(rec)

    def val_metrics(self, epoch: int, metrics: dict) -> None:
        rec = {k: float(v) for k, v in metrics.items()}
        rec["epoch"] = int(epoch)
        self.history["val"].append(rec)
        self._emit("val", rec)
        msg = f"[rank {self.rank}] epoch {epoch} val: loss={rec.get('loss', float('nan')):.4f}"
        if "error" in rec:
            msg += f" err={rec['error']:.4f}"
        if "top5_error" in rec:
            msg += f" top5_err={rec['top5_error']:.4f}"
        print(msg, flush=True)

    # -- epochs --------------------------------------------------------------
    def start_epoch(self) -> None:
        self.epoch_start = time.perf_counter()

    def end_epoch(self, epoch: int, n_images: int = 0) -> float:
        dt = time.perf_counter() - (self.epoch_start or time.perf_counter())
        rec = {"epoch": int(epoch), "seconds": dt}
        if n_images:
            rec["images_per_sec"] = n_images / dt
        self.history["epoch"].append(rec)
        self._emit("epoch", rec)
        print(f"[rank {self.rank}] epoch {epoch} done in {dt:.1f}s"
              + (f" ({rec['images_per_sec']:.0f} img/s)" if n_images else ""), flush=True)
        return dt

    # -- summaries -----------------------------------------------------------
    def mean_time(self, category: str, last_n: Optional[int] = None) -> float:
        ts = self.timings.get(category, [])
        if not ts:
            return 0.0
        return float(np.mean(ts[-last_n:] if last_n else ts))

    def _print_train(self, rec: dict) -> None:
        parts = [f"step {rec['step']}"]
        for k in ("loss", "error", "lr"):
            if k in rec:
                parts.append(f"{k}={rec[k]:.4f}")
        for cat in ("wait", "step"):
            if self.timings.get(cat):
                parts.append(f"{cat}={1000 * self.mean_time(cat, self.print_freq):.1f}ms")
        if "images_per_sec" in rec:
            parts.append(f"{rec['images_per_sec']:.0f} img/s")
        print(f"[rank {self.rank}] " + " ".join(parts), flush=True)

    def _emit(self, kind: str, rec: dict) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"kind": kind, **rec}) + "\n")
            self._jsonl.flush()

    def save(self, path: Optional[str] = None) -> None:
        """Pickle the history and timings (the reference's offline-plot
        format)."""
        if path is None:
            if not self.save_dir:
                return
            path = os.path.join(self.save_dir, f"{self.run_name}_history.pkl")
        with open(path, "wb") as f:
            pickle.dump({"history": dict(self.history), "timings": dict(self.timings)}, f)

    @staticmethod
    def load_history(path: str) -> dict:
        """Read a pickled history back. Unpickling runs code: read only
        files this program wrote."""
        with open(path, "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
