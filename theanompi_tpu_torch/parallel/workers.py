"""What the per-worker rules (EASGD, GoSGD) share: the worker layout of
the ranks, the local step, groups of steps, and the clocks that time the
local step apart from the exchange.

The reference runs every worker of ``parallel/easgd.py`` and
``parallel/gosgd.py`` in one SPMD program over a stack ``[n, ...]`` of
their states. Here each rank is a process on its own card and holds its
own worker (params, optimizer state, BN statistics, codec residual);
the stack exists only in the checkpoint (``bridge.worker_entries``).

Worker groups (``group_size = g > 1``, ``parallel/mesh.py::
worker_groups``): ranks ``w·g … w·g+g−1`` are worker ``w``. Inside a
group the local step is BSP: the gradients' mean over the group's
``"data"`` axis (``strategies.psum_mean`` over that process group) and
its BN statistics averaged over it after the step, so a group of g ranks
is one bigger worker. The exchange runs over the ``"worker"`` axis, the
ranks at the same position in every group. With ``g == 1`` the worker
axis is the world.

The local step (``_local_step``) never averages BN statistics across
workers, as ``BSPEngine.train_step`` does across its replicas; its
metrics are averaged over every rank, as the reference's ``pmean`` over
all axes.

Groups of steps (``fused_train_step``, ``--steps-per-dispatch``): the
local steps replay one captured CUDA graph of ``_local_step``
(``graphs.StepGraph``) on the card, or run eagerly on the CPU; each
engine's exchange (EASGD) or gossip round (GoSGD) runs eagerly between
replays, after exactly the steps the per-step loop runs it after, so a
grouped run equals the eager one bit for bit. The training loop must not
call ``exchange()`` around a group.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.graphs import StepGraph, eager_steps
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.parallel.bsp import check_fused_ranks
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.distributed import gather_tree
from theanompi_tpu_torch.parallel.mesh import DATA_AXIS, WORKER_AXIS, bind_axes, worker_groups
from theanompi_tpu_torch.parallel.strategies import mean_across_ranks, psum_mean
from theanompi_tpu_torch.train import (
    TrainState,
    _optimizer_for,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from theanompi_tpu_torch.tree import digest, tree_leaves

# the clocks keep the newest intervals only (two CUDA events each)
CLOCK_DEPTH = 256


class Clock:
    """Marks on the device's timeline: CUDA events recorded in the
    current stream on the card (no sync), host time on the CPU, where ops
    are synchronous. ``add(start, steps)`` closes an interval that
    covered ``steps`` steps; ``intervals_ms`` reads consecutive marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: deque = deque(maxlen=CLOCK_DEPTH)

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

    def add(self, start, steps: int = 1) -> None:
        self.spans.append((start, self.mark(), steps))

    def ms_per_step(self, skip: int = 0) -> list:
        """Milliseconds a step of each interval after the first ``skip``
        (all of them when there are no more). Syncs on the newest."""
        spans = list(self.spans)
        spans = spans[skip:] if len(spans) > skip else spans
        if spans and self.cuda:
            spans[-1][1].synchronize()
            return [a.elapsed_time(b) / k for a, b, k in spans]
        return [(b - a) * 1e3 / k for a, b, k in spans]


class WorkerRuleEngine:
    """The engine protocol of the reference's loop (``init_state`` /
    ``train_step`` / ``fused_train_step`` / ``exchange`` / ``eval_step``
    / ``get_step``) over one worker a rank. Subclasses set ``name``, the
    state, ``_comm_due(step)`` and ``_comm(state)`` (the exchange or the
    gossip round after step ``step``), and the checkpoint's entries.

    ``n_devices`` ranks (one process each, in an initialized process
    group when more than one) in workers of ``group_size``; ``n_slices``
    only validates that no group straddles a slice. One worker turns the
    codec off (no peer, no wire). ``device``, ``steps_per_epoch``,
    ``fused_update``, ``input_transform``, ``eval_views`` and
    ``accum_steps`` are ``BSPEngine``'s."""

    name = "rule"
    exchange_every = 0

    def __init__(self, model: Model, n_devices: int = 1, device=None, steps_per_epoch: int = 1,
                 *, group_size: int = 1, n_slices=None, wire_codec=None,
                 fused_update: bool = False, input_transform=None, eval_views: int = 1,
                 accum_steps: int = 1):
        self.device = resolve_device(device)
        self.model = model
        self.n = int(n_devices)
        if self.n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.n_workers, self.group_size = worker_groups(self.n, group_size, n_slices)
        self.n_slices = int(n_slices or 1)
        self.codec = get_codec(wire_codec)
        if self.n_workers == 1:
            self.codec = get_codec(None)  # no peers, no wire to compress
        self.fused_update = bool(fused_update)
        self.accum_steps = int(accum_steps)
        self.rank = self.worker = 0
        self.data_group = self.worker_group = None
        if self.n > 1:
            if not dist.is_initialized() or dist.get_world_size() != self.n:
                have = dist.get_world_size() if dist.is_initialized() else "no process group"
                raise RuntimeError(
                    f"{self.name.upper()} over {self.n} devices runs one process per rank in a "
                    f"process group of {self.n} ranks ({have} here): launch it through "
                    "theanompi_tpu_torch.launch.session or the CLI")
            axes = bind_axes(self.n, None, self.group_size)
            self.rank = dist.get_rank()
            self.worker = self.rank // self.group_size
            if self.group_size > 1:
                self.data_group = axes[DATA_AXIS][0]
                self.worker_group = axes[WORKER_AXIS][0]
            else:
                self.worker_group = axes[DATA_AXIS][0]  # the world: one worker a rank
        g = self.group_size
        # inside a group the local step is BSP over the group's data axis
        grad_sync = psum_mean(g, model.param_layouts, self.data_group) if g > 1 else None
        self._step = make_train_step(model, steps_per_epoch, accum_steps=self.accum_steps,
                                     fused_update=fused_update, grad_sync=grad_sync,
                                     input_transform=input_transform)
        self._eval = make_eval_step(model, input_transform=input_transform, views=eval_views)
        self.graph = None  # the captured local step, made by the first group on the card
        self.local_clock = Clock(self.device)
        self.comm_clock = Clock(self.device)
        self.comm_rounds = 0  # exchanges or gossip rounds run
        self._count = None  # host step counter of the groups (from the state's on first use)

    # -- the worker --------------------------------------------------------

    def _init_worker(self, gen: torch.Generator) -> TrainState:
        return init_train_state(self.model, gen, self.device,
                                optimizer=_optimizer_for(self.model, self.fused_update))

    def _local_step(self, worker: TrainState, images, labels, gen):
        """One local step of this rank's worker: BN statistics averaged
        within its group, metrics over every rank."""
        worker, metrics = self._step(worker, images, labels, gen)
        if self.n == 1:
            return worker, metrics
        if self.group_size > 1:
            ms = tree_leaves(worker.model_state)
            with torch.no_grad():
                for m, a in zip(ms, mean_across_ranks(ms, self.group_size, self.data_group)):
                    m.copy_(a)
        keys = sorted(metrics)
        return worker, dict(zip(keys, mean_across_ranks([metrics[k] for k in keys], self.n)))

    def _worker_mean(self, tensors: list) -> list:
        """The mean over the workers (one rank of each group)."""
        if self.n_workers == 1:
            return [t.detach().clone() for t in tensors]
        return mean_across_ranks(tensors, self.n_workers, self.worker_group)

    def _eval_on(self, params, model_state, step, images, labels) -> dict:
        metrics = self._eval(TrainState(params, model_state, (), step), images, labels)
        if self.n == 1:
            return metrics
        keys = sorted(metrics)
        return dict(zip(keys, mean_across_ranks([metrics[k] for k in keys], self.n)))

    # -- the engine protocol -------------------------------------------------

    def _comm_due(self, step: int) -> bool:
        raise NotImplementedError

    def _comm(self, state):
        raise NotImplementedError

    def _timed_comm(self, state):
        start = self.comm_clock.mark()
        state = self._comm(state)
        self.comm_clock.add(start)
        self.comm_rounds += 1
        return state

    def _local(self, state, images, labels, gen):
        start = self.local_clock.mark()
        worker, metrics = self._local_step(state.worker, images, labels, gen)
        self.local_clock.add(start)
        if self._count is not None:
            self._count += 1
        return state._replace(worker=worker), metrics

    def fused_train_step(self, state, images, labels, gen, after_step=None):
        """``len(images)`` steps over the batches ``images[i]``,
        ``labels[i]`` in one call -> ``(state, metrics)``, each metric an
        fp32 vector over the group. The local steps replay one captured
        graph on the card (eagerly on the CPU), in runs cut after each
        step whose exchange or round is due, which then runs eagerly."""
        check_fused_ranks(self.n, max(2, len(images)), self.device,
                          dist.get_backend() if self.n > 1 else None)
        if self._count is None:  # a fresh or resumed state: its own counter
            self._count = self.get_step(state)
        cols, i = [], 0
        while i < len(images):
            j = i + 1
            while j < len(images) and not self._comm_due(self._count + j - i):
                j += 1
            start = self.local_clock.mark()
            if self.device.type == "cuda":
                if self.graph is None:
                    self.graph = StepGraph(self._local_step, self.device)
                worker, m = self.graph.run(state.worker, images[i:j], labels[i:j], gen,
                                           after_step)
            else:
                worker, m = eager_steps(self._local_step, state.worker, images[i:j],
                                        labels[i:j], gen, self.device, after_step)
            self.local_clock.add(start, j - i)
            state = state._replace(worker=worker)
            self._count += j - i
            if self._comm_due(self._count):
                state = self._timed_comm(state)
            cols.append(m)
            i = j
        return state, {k: torch.cat([c[k] for c in cols]) for k in cols[0]}

    def get_step(self, state) -> int:
        """The worker's device step counter, read back (a host sync)."""
        return int(state.worker.step.item())

    def timings(self) -> dict:
        """Read from the device's timeline: ``local_step_ms``, the median
        local step (the first 2 left out), and ``comm_ms``, the median
        exchange or round (the first left out), beside ``comm_ms_max``:
        a round to a peer it meets for the first time pays for NCCL's
        connection to it (set up at first use), which the median leaves
        out and the maximum shows."""
        local = self.local_clock.ms_per_step(skip=2)
        comm = self.comm_clock.ms_per_step(skip=1)
        return {"local_step_ms": float(np.median(local)) if local else None,
                "comm_ms": float(np.median(comm)) if comm else None,
                "comm_ms_max": max(comm) if comm else None}

    # -- what the training loop reads (``BSPEngine``'s protocol) ----------------

    def replica(self, state):
        """This rank's replica: its worker."""
        return state.worker

    def summary_fields(self, batch: int) -> dict:
        """The run summary's fields of the rule (``batch``: the global
        batch, ``n_workers`` per-worker batches)."""
        return {"slices": self.n_slices, "n_workers": self.n_workers,
                "group_size": self.group_size, "per_worker_batch": batch // self.n_workers,
                "global_batch": batch}

    def rank_summary(self, state) -> dict:
        """This rank's summary fields: the digest of its worker (each
        worker its own, every rank of a group the same), the clocks'
        readings (``timings``) and the exchanges or rounds run."""
        w = state.worker
        return {"worker_digest": digest(tree_leaves((w.params, w.opt_state))),
                **self.timings(), "comm_rounds": self.comm_rounds}

    # -- the checkpoint ------------------------------------------------------

    def mesh_topology(self) -> dict:
        """The reference's ``mesh_topology`` of this run's mesh:
        ``("data",)`` over the ranks, ``("worker", "data")`` with worker
        groups (``make_worker_group_mesh``)."""
        if self.group_size > 1:
            return {"shape": [self.n_workers, self.group_size], "axes": ["worker", "data"]}
        return {"shape": [self.n], "axes": ["data"]}

    def stack_axes(self) -> list:
        """The mesh axis the worker stacks run over."""
        return ["worker" if self.group_size > 1 else "data"]

    def _own_row(self) -> int:
        """The row of the worker stacks this rank writes in a sharded
        set: its worker's, from the first rank of the group; -1 on the
        group's other ranks."""
        return self.worker if self.rank % self.group_size == 0 else -1

    def _worker_rows(self, tree):
        """Every worker's ``tree`` in worker order on rank 0, in host
        memory (from the first rank of each group, one worker at a
        time), None on the others. Collective."""
        return gather_tree(tree, self.n, ranks=range(0, self.n, self.group_size))
