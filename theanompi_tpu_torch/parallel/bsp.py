"""BSP data-parallel training engine (port of ``theanompi_tpu/parallel/bsp.py``).

This slice ports the one-device path of the reference's
``make_bsp_train_step`` (``n == 1``): with a single replica there is no
gradient exchange, and the step is exactly ``train.make_train_step``.
More than one device raises: the multi-rank engine (NCCL allreduce with
the int8 block codec) is the next slice on ROADMAP.md.
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.train import (
    TrainState,
    _optimizer_for,
    init_train_state,
    make_eval_step,
    make_train_step,
)


class BSPEngine:
    """Rule engine over the BSP step: ``init_state`` / ``train_step`` /
    ``eval_step`` / ``get_step``, the engine protocol of the reference's
    training loop.

    ``device``: ``None`` is the current CUDA device and raises when there
    is none; ``"cpu"`` runs on the CPU because it was asked for."""

    name = "bsp"
    exchange_every = 0  # the (future) allreduce is inside every step

    def __init__(
        self,
        model: Model,
        n_devices: int = 1,
        device=None,
        steps_per_epoch: int = 1,
        fused_update: bool = False,
    ):
        self.device = resolve_device(device)
        if n_devices != 1:
            raise NotImplementedError(
                f"BSP over {n_devices} devices is not ported yet: the multi-rank "
                "BSP slice (NCCL allreduce + int8 block codec, ROADMAP.md) "
                "brings it; run with 1 device"
            )
        self.model = model
        self.fused_update = bool(fused_update)
        self._step = make_train_step(model, steps_per_epoch, fused_update=fused_update)
        self._eval = make_eval_step(model)

    def init_state(self, gen: torch.Generator) -> TrainState:
        return init_train_state(self.model, gen, self.device,
                                optimizer=_optimizer_for(self.model, self.fused_update))

    def train_step(self, state, images, labels, gen):
        return self._step(state, images, labels, gen)

    def eval_step(self, state, images, labels):
        return self._eval(state, images, labels)

    def get_step(self, state) -> int:
        """The device step counter, read back (a host sync)."""
        return int(state.step.item())
