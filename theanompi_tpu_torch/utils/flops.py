"""A train step's FLOPs and its model FLOPs utilization (the part of
``theanompi_tpu/utils/flops.py`` that the benchmark needs).

The reference reads a compiled program's FLOPs from XLA's cost analysis.
PyTorch has no compiled program, so a step's FLOPs are counted while one
eager step runs, by ``torch.utils.flop_counter.FlopCounterMode``: every
matmul, batched matmul, convolution (forward and its backward) and
attention op that ATen dispatches, as two operations a multiply-add.
Elementwise work, reductions and the optimizer are not counted, as
utilization conventionally leaves them out. Work inside the port's own
kernels is not an ATen op: on the card the flash attention kernels'
products are not counted (on the CPU their plain versions are ATen
matmuls and are), so the LM's ``mfu`` on the card is a lower bound.
Each gradient of a convolution is counted at its forward's cost
(``_conv_backward_flops``): PyTorch's own formula counts a grouped
convolution's weight gradient over every input channel, groups times
its work (AlexNet's conv2, conv4 and conv5).

Peaks come from the card's data sheet (``PEAK_FLOPS``, keyed by
``torch.cuda.get_device_name``): dense, at the full power limit. A card
that is not in the table, and the CPU, have no peak, and then no
``mfu``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

# card name -> peak FLOP/s by the compute dtype of the products: NVIDIA's
# data sheet of the H100 SXM5 80 GB, dense (bf16 / fp16 on the tensor
# cores; fp32 outside them, as the port runs fp32 with TF32 off)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {torch.bfloat16: 989e12, torch.float16: 989e12,
                              torch.float32: 67e12},
}


def peak_flops(device, dtype=torch.bfloat16) -> Optional[float]:
    """The data-sheet peak FLOP/s of ``device`` for products in ``dtype``;
    ``None`` on the CPU and for a card the table does not know."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device), {}).get(dtype)


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **kwargs) -> int:
    """``aten.convolution_backward``: the input and the weight gradient
    each cost the forward's ``2 * N * positions * prod(w_shape)``
    (``w_shape`` holds each group's input channels only)."""
    positions = math.prod((x_shape if transposed else grad_out_shape)[2:])
    forward = 2 * x_shape[0] * positions * math.prod(w_shape)
    return forward * (bool(output_mask[0]) + bool(output_mask[1]))


def count_step_flops(step_fn: Callable, *args):
    """Run ``step_fn(*args)`` once under the FLOP counter -> ``(its
    result, FLOPs)``. The step really runs: a train step advances its
    state."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    with FlopCounterMode(display=False,
                         custom_mapping={aten.convolution_backward: _conv_backward_flops}
                         ) as counter:
        out = step_fn(*args)
    return out, float(counter.get_total_flops())


@dataclass(frozen=True)
class CostModel:
    """One step's counted FLOPs beside the card's peak for them."""

    flops: float
    peak_flops_per_sec: Optional[float] = None

    def mfu(self, step_seconds: Optional[float]) -> Optional[float]:
        """Achieved over peak FLOP/s at a measured step time; ``None``
        without a peak or a time."""
        if not step_seconds or step_seconds <= 0 or not self.peak_flops_per_sec:
            return None
        return self.flops / step_seconds / self.peak_flops_per_sec

    def min_step_seconds(self) -> Optional[float]:
        """The step's time at 100% of the peak: nothing measured can be
        shorter (the benchmark's physics guard)."""
        if not self.peak_flops_per_sec:
            return None
        return self.flops / self.peak_flops_per_sec
