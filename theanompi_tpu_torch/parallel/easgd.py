"""EASGD: elastic-averaging SGD (port of ``theanompi_tpu/parallel/easgd.py``).

Theano-MPI's EASGD rule: each worker trains locally, and every
``avg_freq`` steps it and a center pull toward each other by ``alpha``
times their difference. The reference runs the synchronous variant of
Zhang, Choromanska & LeCun (2015, Alg. 1), every worker exchanging on
the same step, and so does the port (the original's first-come
first-served asynchrony has no counterpart under either package's
lockstep ranks).

Every rank holds its own worker (``EASGDState.worker``: params,
optimizer state, BN statistics) and the same replicated center
(``center_params``, ``center_model_state``). Local steps are
``train.make_train_step`` with no collective of param size across
workers (``parallel/workers.py``). The exchange, every ``avg_freq``
steps (``exchange``; the loop calls it, or ``fused_train_step`` between
its replays):

1. ``diff = alpha·(w − c)`` on each leaf;
2. ``wire, ef' = codec.compress(diff, ef, layouts)`` (int8: one
   quantize and one dequantize launch over all leaves, the blocks in the
   reference's flat order; ``ef`` is this rank's residual);
3. ``w −= diff``, the exact difference (no wire);
4. ``c += Σ_workers wire``: one fp32 ``all_reduce`` of the packed wire
   over the worker axis;
5. ``center_model_state`` = the workers' mean of their model state.

``alpha`` defaults to ``0.9 / n_workers``, ``avg_freq`` to 8. Validation
runs on the center. Batch semantics: each worker trains on its own full
``recipe.batch_size`` (``launch/worker.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.parallel.strategies import _pack_leaves, _unpack_leaves
from theanompi_tpu_torch.parallel.workers import WorkerRuleEngine
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.tree import digest, tree_leaves, tree_map

Tree = Any


class EASGDState(NamedTuple):
    worker: TrainState  # this rank's worker (the reference's row of its stack)
    center_params: Tree  # replicated: the same on every rank
    center_model_state: Tree  # replicated, refreshed at each exchange
    # this rank's error-feedback residual of the wire (``()`` without one)
    ef: Tree = ()


class EASGDEngine(WorkerRuleEngine):
    """Local steps plus the elastic exchange every ``avg_freq`` steps
    (module docstring). ``alpha``: the elastic rate an exchange (default
    ``0.9 / n_workers``, the paper's beta = 0.9). Other arguments:
    ``WorkerRuleEngine``'s."""

    name = "easgd"

    def __init__(self, model, n_devices: int = 1, device=None, steps_per_epoch: int = 1,
                 avg_freq: int = 8, alpha: Optional[float] = None, **kw):
        super().__init__(model, n_devices, device, steps_per_epoch, **kw)
        self.avg_freq = max(1, int(avg_freq))
        self.alpha = alpha if alpha is not None else 0.9 / self.n_workers
        # the reference multiplies by its weakly typed Python float in f32
        self._a = float(np.float32(self.alpha))

    @property
    def exchange_every(self) -> int:
        return self.avg_freq

    def init_state(self, gen: torch.Generator) -> EASGDState:
        """The worker from ``gen`` (every rank draws the same), the center
        a copy of it, zero residuals when the codec keeps them."""
        worker = self._init_worker(gen)
        self._count = None
        return EASGDState(worker=worker,
                          center_params=tree_map(lambda p: p.detach().clone(), worker.params),
                          center_model_state=tree_map(torch.clone, worker.model_state),
                          ef=self.codec.init_ef(worker.params))

    def train_step(self, state: EASGDState, images, labels, gen):
        """One local step; no collective crosses workers but the metrics'."""
        return self._local(state, images, labels, gen)

    def _comm_due(self, step: int) -> bool:
        return step % self.avg_freq == 0

    def exchange(self, state: EASGDState) -> EASGDState:
        """The elastic exchange (module docstring), timed on the device's
        timeline (``timings()["comm_ms"]``)."""
        return self._timed_comm(state)

    def _comm(self, state: EASGDState) -> EASGDState:
        worker = state.worker
        layouts = self.model.param_layouts(worker.params)
        ws, cs, tags = (tree_leaves(worker.params), tree_leaves(state.center_params),
                        tree_leaves(layouts))
        with torch.no_grad():
            # list ops: a loop's arithmetic over the leaves in far fewer launches
            diff = torch._foreach_sub(ws, cs)
            torch._foreach_mul_(diff, self._a)
            wire, ef = diff, state.ef
            if self.codec.active:
                it = iter(diff)
                wire, ef = self.codec.compress(tree_map(lambda _: next(it), worker.params),
                                               state.ef, layouts)
                wire = tree_leaves(wire)
            torch._foreach_sub_(ws, diff)
            total = _pack_leaves(wire, tags)
            if self.n_workers > 1:
                dist.all_reduce(total, group=self.worker_group)
            torch._foreach_add_(cs, _unpack_leaves(total, cs, tags))
            ms, cms = tree_leaves(worker.model_state), tree_leaves(state.center_model_state)
            if cms:
                torch._foreach_copy_(cms, self._worker_mean(ms))
        return state._replace(ef=ef)

    def eval_step(self, state: EASGDState, images, labels) -> dict:
        """Validation on the center (the reference's server validates it)."""
        return self._eval_on(state.center_params, state.center_model_state, state.worker.step,
                             images, labels)

    def summary_fields(self, batch: int) -> dict:
        return {**super().summary_fields(batch), "avg_freq": self.avg_freq, "alpha": self.alpha}

    def rank_summary(self, state: EASGDState) -> dict:
        """``WorkerRuleEngine``'s, and the digest of the center (one on
        every rank)."""
        return {**super().rank_summary(state), "center_digest": digest(
            tree_leaves((state.center_params, state.center_model_state)))}

    # -- the checkpoint: the reference's EASGDState entries -------------------

    def state_entries(self, state: EASGDState, layouts) -> Optional[dict]:
        """Rank 0: the entries of ``state`` as the reference's checkpoint
        of its ``EASGDState`` holds them (``.workers/…`` stacked over the
        workers, ``.center_params/…``, ``.center_model_state/…``, ``.ef/…``
        stacked); None on the other ranks. Collective."""
        rows = self._worker_rows(state.worker._replace(ef=()))
        ef_rows = self._worker_rows(state.ef) if tree_leaves(state.ef) else None
        if rows is None:
            return None
        entries = bridge.worker_entries(rows, layouts)
        entries.update(bridge.tree_entries(state.center_params, ".center_params", layouts))
        entries.update(bridge.tree_entries(state.center_model_state, ".center_model_state"))
        if ef_rows is not None:
            entries.update(bridge.stacked_entries(ef_rows, ".ef", layouts))
        return entries

    def checkpoint_parts(self, state: EASGDState, layouts) -> list:
        """The entries of :meth:`state_entries` this rank holds, as
        ``(entry, tensor, row, rows)`` (``bridge.state_parts``), with no
        collective: the center replicated, its worker's rows."""
        row, n = self._own_row(), self.n_workers
        parts = bridge.worker_parts(state.worker, layouts, row, n)
        parts += [(k, v, None, 1) for k, v in bridge.tree_entries(
            state.center_params, ".center_params", layouts).items()]
        parts += [(k, v, None, 1) for k, v in bridge.tree_entries(
            state.center_model_state, ".center_model_state").items()]
        if tree_leaves(state.ef):
            parts += [(k, v, row, n)
                      for k, v in bridge.tree_entries(state.ef, ".ef", layouts).items()]
        return parts

    def elastic_spec(self) -> dict:
        """Reshard policies (the reference's ``EASGDEngine.elastic_spec``):
        the center is replicated (``global``); the worker stacks resize by
        ``worker_consensus`` (every new worker from the mean of the saved
        ones, an integer leaf from the first worker: a consensus, not an
        exact resume); the residuals ``reset``."""
        return {"policies": {".workers": {"policy": "worker_consensus"},
                             ".ef": {"policy": "reset"}}}

    def restore(self, flat: dict, template: EASGDState, layouts) -> EASGDState:
        """This rank's state from checkpoint entries: its worker's row of
        each stack, the center; raises naming the entry on a missing key
        or a stack of another worker count."""
        self._count = None
        w, n = self.worker, self.n_workers
        ef = template.ef
        if tree_leaves(ef):
            ef = bridge.stacked_row(flat, ".ef", ef, w, n, layouts)
        return EASGDState(
            worker=bridge.worker_from_flat(flat, template.worker, layouts, w, n),
            center_params=bridge.tree_from_entries(flat, ".center_params",
                                                   template.center_params, layouts),
            center_model_state=bridge.tree_from_entries(flat, ".center_model_state",
                                                        template.center_model_state),
            ef=ef)
