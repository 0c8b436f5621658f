"""Layers and initializers (port of ``theanompi_tpu.nn``)."""

from theanompi_tpu_torch.nn import init  # noqa: F401
from theanompi_tpu_torch.nn.layers import (  # noqa: F401
    LRN,
    Activation,
    BatchNorm,
    Conv,
    Dense,
    Dropout,
    Flatten,
    GlobalAvgPool,
    Layer,
    Pool,
    Sequential,
)
