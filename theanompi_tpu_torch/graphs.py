"""Step fusion on the card: one train step captured as a CUDA graph and
replayed for each step of a group.

The reference fuses k steps into one compiled program
(``theanompi_tpu/train.py::make_multi_step``, a ``lax.scan``): one host
dispatch a group. PyTorch runs a step eagerly, and the host pays for
every op and every kernel wrapper of it, so a step whose kernels are
small waits for its host. ``StepGraph`` captures one step with
``torch.cuda.CUDAGraph`` once and replays it for every step after:
one graph launch a step, whatever the step holds.

First call: the step runs eagerly (the warm-up; it is a real step and
counts as one), on the graph's own stream. It does the first-use work
that must not happen inside a capture: the kernels' nvcc builds, cuBLAS
and cuDNN workspaces and plans, the TMA encoder's lookup, the models'
cached constants. Then one step is captured on the same stream. It reads
static ``x`` / ``y`` buffers, writes every state tensor that the step
replaces (the step counter, Adam's moments, a non-fused optimizer's
velocities, BN statistics, codec residuals) back into the state's own
tensor inside the captured region, and copies the step's metrics into a
static ``[n_metrics]`` fp32 buffer. Params, and the fused update's
velocities, are updated in place by the step itself.

Each later step: the batch into the static buffers
(``non_blocking``), ``replay()``, the metrics buffer into the step's row
of the group's ``[n, n_metrics]`` buffer. All of it goes on the graph's
stream; nothing in a group waits for the device.

What the graph needs held, and how:

- The dropout generator (an explicit CUDA ``torch.Generator``) is
  registered with the graph, which then advances its offset by the
  captured step's whole draw at each replay: a replayed run draws the
  masks an eager run draws.
- ``LaunchCounter``s count on the host, so they move at capture, when no
  kernel runs, and not at replay. The capture's change is taken back and
  added again at every replay, so ``launch_counts()`` stays the count of
  launches that ran.
- The graph holds pointers. Before every replay the batch must have the
  captured shape and dtype and the generator must be the registered
  one, and before a group's first replay the state's leaves must be the
  tensors that were captured (inside a group only the replays touch the
  state, and they keep its tensors). If not (a resume's
  ``bridge.state_from_flat``, a ``TrainState._replace``), the step is
  captured again. A replay never runs over stale pointers.
- The step's own metric tensors live in the graph's pool and the next
  replay overwrites them: callers get only the group's fresh buffer.
- A capture that fails (an op that cannot be captured, a host sync)
  raises ``GraphCaptureError`` naming the port's innermost frame on the
  failing path. There is no eager fallback on the card.
"""

from __future__ import annotations

import os
import traceback
from typing import Callable, Optional

import torch

from theanompi_tpu_torch.ops.kernels import add_launch_counts, launch_counts
from theanompi_tpu_torch.tree import tree_leaves

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


class GraphCaptureError(RuntimeError):
    """The train step could not be captured as a CUDA graph."""


def metric_row(metrics: dict, keys) -> torch.Tensor:
    """The step's metrics as one fp32 vector in ``keys`` order (what the
    training loop's drain reads back)."""
    return torch.stack([torch.as_tensor(metrics[k]).float().reshape(()) for k in keys])


def as_columns(rows: torch.Tensor, keys) -> dict:
    """``{key: rows[:, j]}``: a group's metrics, each stacked over its steps."""
    return {k: rows[:, j] for j, k in enumerate(keys)}


def capture_site(exc: BaseException) -> str:
    """Where ``exc`` was raised: the innermost frame of the port's package
    outside this module (the op the capture could not take), else the
    innermost frame."""
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames if f.filename.startswith(PACKAGE_DIR)
           and os.path.basename(f.filename) != "graphs.py"]
    f = (own or frames or [None])[-1]
    if f is None:
        return "an unknown frame"
    return f"{os.path.relpath(f.filename, os.path.dirname(PACKAGE_DIR))}:{f.lineno} in " \
           f"{f.name} ({(f.line or '').strip()})"


def count_delta(before: dict, after: dict) -> dict:
    """The launch counters that moved between two ``launch_counts()``."""
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def same_leaves(held, leaves) -> bool:
    """Whether ``leaves`` are exactly the tensor objects ``held``, in order."""
    return len(held) == len(leaves) and all(a is b for a, b in zip(held, leaves))


def write_back(old_leaves, new_leaves) -> None:
    """Copy each new state tensor into the old one it replaces (a leaf
    the step updated in place is the same object and is skipped)."""
    if len(old_leaves) != len(new_leaves):
        raise GraphCaptureError(f"the step returned {len(new_leaves)} state leaves for "
                                f"{len(old_leaves)}: the state's structure changed")
    for i, (old, new) in enumerate(zip(old_leaves, new_leaves)):
        if new is old:
            continue
        if new.shape != old.shape or new.dtype != old.dtype:
            raise GraphCaptureError(
                f"state leaf {i}: the step returned {tuple(new.shape)} {new.dtype} for "
                f"{tuple(old.shape)} {old.dtype}; a captured step writes its state in place")
        old.copy_(new)


def eager_steps(step_fn: Callable, state, xs, ys, gen, device, after_step=None):
    """``len(xs)`` eager steps of ``step_fn`` over the batches ``xs[i]``,
    ``ys[i]`` (moved to ``device``) -> ``(state, metrics)``, each metric
    an fp32 vector over the steps. ``after_step()`` runs after each step
    is enqueued."""
    rows, keys = [], None
    for x, y in zip(xs, ys):
        x, y = x.to(device, non_blocking=True), y.to(device, non_blocking=True)
        state, m = step_fn(state, x, y, gen)
        keys = keys or sorted(m)
        rows.append(metric_row(m, keys))
        if after_step is not None:
            after_step()
    return state, as_columns(torch.stack(rows), keys)


class StepGraph:
    """``step_fn`` (``(state, x, y, gen) -> (state, metrics)``) captured
    once as a CUDA graph on ``device`` and replayed (module docstring).
    ``captures`` and ``replays`` count what it did."""

    def __init__(self, step_fn: Callable, device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a CUDA device, not {device}")
        self.step_fn = step_fn
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.keys: Optional[list] = None
        self.captures = 0
        self.replays = 0
        self._leaves: list = []
        self._gen = None
        self._x = self._y = None
        self._metrics: Optional[torch.Tensor] = None
        self._launches: dict = {}

    def run(self, state, xs, ys, gen, after_step=None):
        """``len(xs)`` steps over the batches ``xs[i]``, ``ys[i]`` (host or
        device tensors) -> ``(state, metrics)``, each metric an fp32
        vector over the steps, in a buffer of this call's own. Consecutive
        steps given the same batch object copy it once."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        rows = None
        with torch.cuda.stream(self.stream):
            for i, (x, y) in enumerate(zip(xs, ys)):
                fresh = i == 0 or x is not xs[i - 1] or y is not ys[i - 1]
                state, row = self._step(state, x, y, gen, fresh, i == 0, main)
                if rows is None:
                    rows = torch.empty((len(xs), row.numel()), dtype=torch.float32,
                                       device=self.device)
                rows[i].copy_(row)
                if after_step is not None:
                    after_step()
        main.wait_stream(self.stream)
        rows.record_stream(main)
        return state, as_columns(rows, self.keys)

    def _step(self, state, x, y, gen, fresh: bool, check_state: bool, main):
        if self.keys is None:
            return self._warm_up(state, x, y, gen, main)
        if not self._matches(state, x, y, gen, check_state):
            self._capture(state, x, y, gen)
            fresh = True
        if fresh:
            self._x.copy_(x, non_blocking=True)
            self._y.copy_(y, non_blocking=True)
        self.graph.replay()
        add_launch_counts(self._launches)
        self.replays += 1
        return state, self._metrics

    def _matches(self, state, x, y, gen, check_state: bool) -> bool:
        return (self.graph is not None and gen is self._gen
                and x.shape == self._x.shape and x.dtype == self._x.dtype
                and y.shape == self._y.shape and y.dtype == self._y.dtype
                and (not check_state or same_leaves(self._leaves, tree_leaves(state))))

    def _inputs_like(self, x, y) -> None:
        self._x = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        self._y = torch.empty(y.shape, dtype=y.dtype, device=self.device)

    def _warm_up(self, state, x, y, gen, main):
        """The first step, eagerly on the graph's stream; then the capture."""
        self._inputs_like(x, y)
        self._x.copy_(x, non_blocking=True)
        self._y.copy_(y, non_blocking=True)
        old = {id(t) for t in tree_leaves(state)}
        state, metrics = self.step_fn(state, self._x, self._y, gen)
        self.keys = sorted(metrics)
        row = metric_row(metrics, self.keys)
        for t in tree_leaves(state):
            if id(t) not in old:  # made on this stream, read on the caller's too
                t.record_stream(main)
        self._capture(state, x, y, gen)
        return state, row

    def _capture(self, state, x, y, gen) -> None:
        """Capture one step over ``state`` (which it does not run)."""
        self.graph = None  # the old graph's pool goes back first
        if x.shape != self._x.shape or x.dtype != self._x.dtype or \
                y.shape != self._y.shape or y.dtype != self._y.dtype:
            self._inputs_like(x, y)
        torch.cuda.synchronize(self.device)
        # cached blocks of the eager steps go back to the card: the
        # capture's pool may need them, and nothing may be freed inside it
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        if gen is not None and gen.device.type == "cuda":
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise GraphCaptureError(
                    f"torch {torch.__version__} cannot register a generator with a CUDA "
                    "graph (CUDAGraph.register_generator_state): the dropout masks of a "
                    "replay would not be the eager step's")
            register(gen)
        leaves = tree_leaves(state)
        before = launch_counts()
        # thread_local: the prefetch thread pins host memory while the
        # main thread captures
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            new_state, metrics = self.step_fn(state, self._x, self._y, gen)
            if sorted(metrics) != self.keys:
                raise GraphCaptureError(f"the step's metrics {sorted(metrics)} are not the "
                                        f"warm-up step's {self.keys}")
            with torch.no_grad():
                write_back(leaves, tree_leaves(new_state))
                self._metrics = metric_row(metrics, self.keys)
        except BaseException as e:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated by the failure reported below
            add_launch_counts(count_delta(launch_counts(), before))
            raise GraphCaptureError(
                f"the train step could not be captured as a CUDA graph: {type(e).__name__} "
                f"at {capture_site(e)}: {e}") from e
        graph.capture_end()
        self._launches = count_delta(before, launch_counts())
        add_launch_counts({k: -n for k, n in self._launches.items()})
        self.graph, self._leaves, self._gen = graph, leaves, gen
        self.captures += 1
