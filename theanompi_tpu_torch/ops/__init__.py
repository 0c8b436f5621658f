"""Optimizers, LR schedules and the port's hand-written kernels."""

from theanompi_tpu_torch.ops.lr_schedules import get_schedule  # noqa: F401
from theanompi_tpu_torch.ops.optimizers import (  # noqa: F401
    Optimizer,
    apply_updates,
    get_optimizer,
)
