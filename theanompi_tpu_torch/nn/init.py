"""Weight initializers, each a function of an explicit ``torch.Generator``.

Port of ``theanompi_tpu/nn/init.py``. An initializer is
``f(gen, shape, dtype=torch.float32) -> tensor``; it draws on the CPU
from ``gen`` (a CPU generator), so the same seed gives the same weights
whichever device the model then moves to. Draws differ from the
reference's ``jax.random`` streams by construction: parity tests carry
weights across with ``bridge.py`` and check inits by distribution.
"""

from __future__ import annotations

import math

import torch


def constant(value: float):
    def f(gen, shape, dtype=torch.float32):
        del gen
        return torch.full(tuple(shape), float(value), dtype=dtype)

    return f


zeros = constant(0.0)


def gaussian(std: float = 0.01, mean: float = 0.0):
    """Fixed-std normal — the AlexNet/GoogLeNet recipe init."""

    def f(gen, shape, dtype=torch.float32):
        return mean + std * torch.randn(tuple(shape), generator=gen, dtype=dtype)

    return f


def _fans(shape):
    """(fan_in, fan_out) for dense ``(in, out)`` or conv ``HWIO`` shapes
    (the reference's layout — layers pass shapes in that layout)."""
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(math.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


def glorot_uniform(scale: float = 1.0):
    """Glorot/Xavier uniform: U(±sqrt(6/(fan_in+fan_out)))."""

    def f(gen, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        limit = scale * math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(tuple(shape), generator=gen, dtype=dtype)
        return (2.0 * u - 1.0) * limit

    return f


def he_normal(scale: float = 1.0):
    """He/Kaiming normal: N(0, sqrt(2/fan_in))."""

    def f(gen, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        return scale * math.sqrt(2.0 / fan_in) * torch.randn(tuple(shape), generator=gen, dtype=dtype)

    return f
