"""Learning-rate schedules as ``step -> lr`` functions on tensors.

Port of ``theanompi_tpu/ops/lr_schedules.py``. ``step`` is a tensor
(the train state's device-resident step counter, or its epoch
equivalent) or a Python number; the result is a 0-d fp32 tensor on the
step's device. Only elementwise tensor ops with Python-scalar operands
are used, so evaluating a schedule on the card never copies from the
host or syncs with it.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[..., torch.Tensor]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _full_like(s: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(s, float(value), dtype=torch.float32)


def constant(lr: float) -> Schedule:
    def schedule(step):
        return _full_like(_f32(step), lr)

    return schedule


def step_decay(lr: float, boundaries: Sequence[int], factor: float = 0.1) -> Schedule:
    """Piecewise-constant decay: multiply by ``factor`` at each boundary
    (in steps or epochs, the caller's unit)."""
    bounds = [float(b) for b in sorted(boundaries)]

    def schedule(step):
        s = _f32(step)
        n = torch.zeros_like(s)
        for b in bounds:
            n = n + (s >= b).to(torch.float32)
        return _full_like(s, lr) * torch.pow(_full_like(s, factor), n)

    return schedule


def exponential_decay(lr: float, decay: float, every: int = 1) -> Schedule:
    """``lr * decay**(step // every)``."""

    def schedule(step):
        s = _f32(step)
        k = torch.floor(s / float(every))
        return _full_like(s, lr) * torch.pow(_full_like(s, decay), k)

    return schedule


def polynomial_decay(lr: float, total_steps: int, power: float = 1.0,
                     end_lr: float = 0.0) -> Schedule:
    def schedule(step):
        frac = torch.clamp(_f32(step) / float(total_steps), 0.0, 1.0)
        return (lr - end_lr) * torch.pow(1.0 - frac, power) + end_lr

    return schedule


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         end_lr: float = 0.0) -> Schedule:
    """Linear warmup, then cosine decay to ``end_lr``."""

    def schedule(step):
        s = _f32(step)
        warm = lr * s / max(1.0, float(warmup_steps))
        frac = torch.clamp(
            (s - warmup_steps) / max(1.0, float(total_steps - warmup_steps)), 0.0, 1.0
        )
        cos = end_lr + 0.5 * (lr - end_lr) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, cos)

    return schedule


_REGISTRY = {
    "constant": constant,
    "step": step_decay,
    "exp": exponential_decay,
    "poly": polynomial_decay,
    "warmup_cosine": linear_warmup_cosine,
}


def get_schedule(name: str, **kwargs) -> Schedule:
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; available: {sorted(_REGISTRY)}") from None
