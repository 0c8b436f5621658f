"""Sync-rule engines (BSP over one or more ranks), exchange strategies and wire codecs."""

from theanompi_tpu_torch.parallel.bsp import BSPEngine  # noqa: F401
