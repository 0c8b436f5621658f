"""Sync-rule engines (this slice: single-device BSP)."""

from theanompi_tpu_torch.parallel.bsp import BSPEngine  # noqa: F401
