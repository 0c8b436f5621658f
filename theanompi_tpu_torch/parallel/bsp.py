"""BSP data-parallel training engine (port of ``theanompi_tpu/parallel/bsp.py``).

The reference compiles forward, backward, the gradient exchange and the
update into one SPMD program over a ``("data",)`` mesh. Here every rank
is a process on its own card (``launch/session.py`` spawns them), in a
``torch.distributed`` process group: each rank runs forward and backward
on its shard of the global batch, the exchange strategy
(``parallel/strategies.py``, optionally through a wire codec) turns its
gradients into the mean over ranks, and every rank applies the same
update, so the replicas stay identical. Metrics and model state (BN
statistics) are averaged across ranks after the step, as the
reference's ``pmean``.

``n_devices == 1`` keeps the reference's shortcut: no collective and no
codec — the step is exactly ``train.make_train_step`` (the strategy and
codec names are still validated).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.strategies import get_strategy, mean_across_ranks
from theanompi_tpu_torch.train import (
    TrainState,
    _optimizer_for,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from theanompi_tpu_torch.tree import tree_leaves


class BSPEngine:
    """Rule engine over the BSP step: ``init_state`` / ``train_step`` /
    ``eval_step`` / ``get_step``, the engine protocol of the reference's
    training loop.

    ``device``: ``None`` is the current CUDA device and raises when there
    is none; ``"cpu"`` runs on the CPU because it was asked for.
    ``n_devices > 1`` needs this process to be one rank of an initialized
    process group of that many ranks. ``input_transform`` runs on the
    images first in both steps (``train.make_input_transform``);
    ``eval_views`` is the validation batches' views per image."""

    name = "bsp"
    exchange_every = 0  # the allreduce is inside every step

    def __init__(
        self,
        model: Model,
        n_devices: int = 1,
        device=None,
        steps_per_epoch: int = 1,
        fused_update: bool = False,
        strategy: str = "psum",
        wire_codec=None,
        input_transform=None,
        eval_views: int = 1,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.n = int(n_devices)
        self.fused_update = bool(fused_update)
        self.strategy = strategy
        self.codec = get_codec(wire_codec)
        if self.n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if self.n == 1:
            get_strategy(strategy, 1, codec=self.codec,  # validate the names only
                         layouts=model.param_layouts)
            grad_sync = None
        else:
            if not dist.is_initialized() or dist.get_world_size() != self.n:
                have = dist.get_world_size() if dist.is_initialized() else "no process group"
                raise RuntimeError(
                    f"BSP over {self.n} devices runs one process per rank in a "
                    f"process group of {self.n} ranks ({have} here): launch it "
                    "through theanompi_tpu_torch.launch.session or the CLI"
                )
            # the exchange and the codec flatten each leaf in the
            # reference's order, which the model's layout tags decide
            grad_sync = get_strategy(strategy, self.n, codec=self.codec,
                                     layouts=model.param_layouts)
        self._step = make_train_step(model, steps_per_epoch, fused_update=fused_update,
                                     grad_sync=grad_sync, input_transform=input_transform)
        self._eval = make_eval_step(model, input_transform=input_transform, views=eval_views)

    def init_state(self, gen: torch.Generator) -> TrainState:
        """Params from ``gen`` (every rank draws the same, from the same
        seed); with ``n > 1`` and error feedback, this rank's zero
        residuals."""
        state = init_train_state(self.model, gen, self.device,
                                 optimizer=_optimizer_for(self.model, self.fused_update))
        if self.n > 1:
            state = state._replace(ef=self.codec.init_ef(state.params))
        return state

    def train_step(self, state, images, labels, gen):
        state, metrics = self._step(state, images, labels, gen)
        if self.n == 1:
            return state, metrics
        keys = sorted(metrics)
        ms = tree_leaves(state.model_state)
        avg = mean_across_ranks([metrics[k] for k in keys] + ms, self.n)
        with torch.no_grad():
            for m, a in zip(ms, avg[len(keys):]):
                m.copy_(a)
        return state, dict(zip(keys, avg[:len(keys)]))

    def eval_step(self, state, images, labels):
        metrics = self._eval(state, images, labels)
        if self.n == 1:
            return metrics
        keys = sorted(metrics)
        return dict(zip(keys, mean_across_ranks([metrics[k] for k in keys], self.n)))

    def get_step(self, state) -> int:
        """The device step counter, read back (a host sync)."""
        return int(state.step.item())
