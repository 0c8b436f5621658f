"""int8 absmax quantize/dequantize kernels and the packed int8 wire:
the compressed-exchange building block of ``--wire-codec int8[:ef]`` and
``--strategy ring_int8``.

Port of ``theanompi_tpu/ops/pallas_quant.py``. The kernels are
hand-written CUDA for Hopper (``csrc/quant.cu``); beside each is its
plain PyTorch version with the same arithmetic:

    scale = max(absmax, 1e-30) * fl(1/127)           per row, or per buffer
    q     = clamp(round_half_even(x / scale), -127, 127) as int8, NaN -> 0
    x'    = float(q) * scale

The scale is a reciprocal MULTIPLY and the value a true DIVISION, as XLA
compiles the reference (it rewrites ``amax / 127.0`` into a multiply by
the constant's reciprocal, but ``x / scale`` has no constant divisor):
that is what makes the port bit-identical to the JAX package. A NaN
anywhere in a row gives the row a NaN scale and zero values, as in the
reference, so a diverged gradient is not laundered into finite values.

Layout: the kernels take a flat f32 buffer viewed as ``(rows, 128)``
lanes. ``wire_encode`` / ``wire_decode`` take any length (zero-padded to
a 128 multiple) and pack values and the per-row f32 scales into ONE
int8 message of ``rows + ceil(rows / 32)`` rows: the scale bytes fill the
tail rows little-endian, 32 scales to a row, the rest zero. A message
encoded by one package decodes in the other.

The wrappers take the plain version only for CPU tensors; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from theanompi_tpu_torch.ops.kernels import KernelLibrary, LaunchCounter, max_blocks, stream_handle

LANES = 128
# f32 scales per 128-byte tail row of the packed wire
SCALES_PER_ROW = LANES // 4
_FLOOR = 1e-30
# fl(1/127): exactly representable in f32, so the multiply rounds once
# whatever precision PyTorch carries the Python scalar in
_INV127 = float(np.float32(1.0 / 127.0))

_P = ctypes.c_void_p
_LIB = KernelLibrary(
    "quant.cu",
    {
        # device, x, vals, scales, rows, max_blocks, stream
        "tmpi_quant_block": (ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P),
        # device, vals, scales, out, rows, accumulate, max_blocks, stream
        "tmpi_dequant_block": (ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int, _P),
        # device, x, vals, scale, partial, rows, n_partial, max_blocks, stream
        "tmpi_quant": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, _P),
        # device, vals, scale, out, rows, max_blocks, stream
        "tmpi_dequant": (ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P),
    },
)

QUANT_BLOCK = LaunchCounter("quant_block")
DEQUANT_BLOCK = LaunchCounter("dequant_block")
QUANT = LaunchCounter("quant")
DEQUANT = LaunchCounter("dequant")

# threads per block of the elementwise passes (csrc/quant.cu kThreads)
_THREADS = 256


def build() -> float:
    """Build (or find) and load the kernel library; returns the seconds
    spent compiling (0.0 when it was already built)."""
    _LIB.get()
    return _LIB.build_seconds


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# --------------------------------------------------------------------------


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, _FLOOR) * _INV127


def _quantize_with(x2d: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(x2d / scale), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8)


def quantize_int8_block_plain(x2d: torch.Tensor):
    """``(rows, 128) f32 -> ((rows, 128) int8, (rows, 1) f32 scales)``."""
    scales = _scale_of(torch.amax(torch.abs(x2d), dim=1, keepdim=True))
    return _quantize_with(x2d, scales), scales


def dequantize_int8_block_plain(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return vals.float() * scales


def quantize_int8_plain(x2d: torch.Tensor):
    """``(rows, 128) f32 -> ((rows, 128) int8, (1, 1) f32 scale)``."""
    scale = _scale_of(torch.amax(torch.abs(x2d))).reshape(1, 1)
    return _quantize_with(x2d, scale), scale


def dequantize_int8_plain(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return vals.float() * scale[0, 0]


# --------------------------------------------------------------------------
# wrappers: plain version for CPU tensors, the kernel for CUDA tensors
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, align: int,
           device: torch.device) -> None:
    """One kernel argument: ``dtype``, ``shape``, contiguous, on
    ``device``, its pointer ``align``-byte aligned (the kernels move
    float4 / char4)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name}'s data is not {align}-byte aligned")


def _rows_of(x2d: torch.Tensor) -> int:
    if x2d.dim() != 2 or x2d.shape[1] != LANES or x2d.shape[0] < 1:
        raise ValueError(f"expected a (rows >= 1, {LANES}) buffer, got {tuple(x2d.shape)}")
    return x2d.shape[0]


def _quantize_block_into(x2d, vals, scales) -> None:
    rows, dev = _rows_of(x2d), x2d.device
    _check(x2d, "x", torch.float32, (rows, LANES), 16, dev)
    _check(vals, "vals", torch.int8, (rows, LANES), 4, dev)
    _check(scales, "scales", torch.float32, (rows, 1), 4, dev)
    if dev.type == "cpu":
        v, s = quantize_int8_block_plain(x2d)
        vals.copy_(v)
        scales.copy_(s)
        return
    rc = _LIB.get().tmpi_quant_block(dev.index, x2d.data_ptr(), vals.data_ptr(),
                                     scales.data_ptr(), rows, max_blocks(dev),
                                     stream_handle(dev))
    _LIB.check(rc, "int8 block quantize kernel")
    QUANT_BLOCK.launches += 1


def dequantize_add_int8_block_plain(vals, scales, acc) -> torch.Tensor:
    """``acc + vals * scales`` rounded ONCE, as a fused multiply-add: the
    product of an int8 and an f32 is exact in f64, and so is its sum with
    an f32 unless their exponents lie more than ~22 bits apart, where the
    one rounding to f32 agrees with the fma's too except for a sum within
    2^-53 of an f32 rounding midpoint."""
    return (acc.double() + vals.double() * scales.double()).float()


def _dequantize_block_into(vals, scales, out, accumulate: bool = False) -> None:
    """``out = vals * scales``, or with ``accumulate`` ``out = fma(vals,
    scales, out)`` (the ring's decode-and-add, one pass)."""
    rows, dev = _rows_of(vals), vals.device
    _check(vals, "vals", torch.int8, (rows, LANES), 4, dev)
    _check(scales, "scales", torch.float32, (rows, 1), 4, dev)
    _check(out, "out", torch.float32, (rows, LANES), 16, dev)
    if dev.type == "cpu":
        out.copy_(dequantize_add_int8_block_plain(vals, scales, out) if accumulate
                  else dequantize_int8_block_plain(vals, scales))
        return
    rc = _LIB.get().tmpi_dequant_block(dev.index, vals.data_ptr(), scales.data_ptr(),
                                       out.data_ptr(), rows, int(accumulate),
                                       max_blocks(dev), stream_handle(dev))
    _LIB.check(rc, "int8 block dequantize kernel")
    DEQUANT_BLOCK.launches += 1


def quantize_int8_block(x2d: torch.Tensor):
    """``(rows, 128) f32 -> ((rows, 128) int8, (rows, 1) f32 scales)``
    with one absmax scale per row (128-element block)."""
    rows = _rows_of(x2d)
    if x2d.device.type == "cpu":
        return quantize_int8_block_plain(x2d)
    vals = torch.empty((rows, LANES), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    _quantize_block_into(x2d, vals, scales)
    return vals, scales


def dequantize_int8_block(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_block`."""
    rows = _rows_of(vals)
    if vals.device.type == "cpu":
        return dequantize_int8_block_plain(vals, scales)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=vals.device)
    _dequantize_block_into(vals, scales, out)
    return out


def quantize_int8(x2d: torch.Tensor):
    """``(rows, 128) f32 -> ((rows, 128) int8, (1, 1) f32 scale)`` with a
    single absmax scale for the whole buffer (three passes on the card:
    block maxima, their max and the scale, then the values)."""
    rows, dev = _rows_of(x2d), x2d.device
    if dev.type == "cpu":
        return quantize_int8_plain(x2d)
    _check(x2d, "x", torch.float32, (rows, LANES), 16, dev)
    vals = torch.empty((rows, LANES), dtype=torch.int8, device=dev)
    scale = torch.empty((1, 1), dtype=torch.float32, device=dev)
    n_partial = min(-(-rows * (LANES // 4) // _THREADS), max_blocks(dev))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_quant(dev.index, x2d.data_ptr(), vals.data_ptr(), scale.data_ptr(),
                               partial.data_ptr(), rows, n_partial, max_blocks(dev),
                               stream_handle(dev))
    _LIB.check(rc, "int8 quantize kernel")
    QUANT.launches += 1
    return vals, scale


def dequantize_int8(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`."""
    rows, dev = _rows_of(vals), vals.device
    if dev.type == "cpu":
        return dequantize_int8_plain(vals, scale)
    _check(vals, "vals", torch.int8, (rows, LANES), 4, dev)
    _check(scale, "scale", torch.float32, (1, 1), 4, dev)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_dequant(dev.index, vals.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                 rows, max_blocks(dev), stream_handle(dev))
    _LIB.check(rc, "int8 dequantize kernel")
    DEQUANT.launches += 1
    return out


# --------------------------------------------------------------------------
# packed wire format: values + block scales in ONE int8 message
# --------------------------------------------------------------------------


def pad_rows(flat: torch.Tensor) -> torch.Tensor:
    """Zero-pad a flat f32 vector to a ``(rows, 128)`` lane layout (a
    view when no padding is needed)."""
    flat = flat.reshape(-1)
    pad = -flat.numel() % LANES
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, LANES)


def wire_rows(length: int) -> tuple:
    """``(value_rows, scale_rows)`` of the packed message for a flat
    buffer of ``length`` elements."""
    if length < 1:
        raise ValueError(f"cannot wire-encode a length-{length} buffer")
    rows = -(-length // LANES)
    return rows, -(-rows // SCALES_PER_ROW)


def rows_from_packed(n_rows: int) -> int:
    """Invert ``rows + ceil(rows / 32) == n_rows`` (strictly increasing
    in ``rows``, so the solution is unique)."""
    rows = max(1, (n_rows * SCALES_PER_ROW) // (SCALES_PER_ROW + 1))
    for r in (rows - 1, rows, rows + 1):
        if r >= 1 and r + -(-r // SCALES_PER_ROW) == n_rows:
            return r
    raise ValueError(f"not a packed wire message: {n_rows} rows")


def wire_scales(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """The ``(rows, 1)`` f32 scales stored in ``packed``'s tail rows, as a
    view of its bytes."""
    return packed[rows:].reshape(-1)[: rows * 4].view(torch.float32).view(rows, 1)


def wire_encode(chunk: torch.Tensor) -> torch.Tensor:
    """Flat f32 chunk of any length >= 1 -> one packed int8 message
    ``(rows + ceil(rows / 32), 128)``. On the card the quantize kernel
    writes the values and the scale bytes straight into the message."""
    if chunk.dtype != torch.float32:
        raise TypeError(f"wire_encode takes float32, got {chunk.dtype}")
    rows, srows = wire_rows(chunk.numel())
    x2d = pad_rows(chunk)
    if x2d.is_cuda and x2d.data_ptr() % 16:  # a slice at an odd offset
        x2d = x2d.clone()
    packed = torch.empty((rows + srows, LANES), dtype=torch.int8, device=chunk.device)
    packed[rows:].zero_()
    _quantize_block_into(x2d, packed[:rows], wire_scales(packed, rows))
    return packed


def _message_rows(packed: torch.Tensor, length: Optional[int]) -> int:
    if length is None:
        return rows_from_packed(packed.shape[0])
    rows, srows = wire_rows(length)
    if rows + srows != packed.shape[0]:
        raise ValueError(f"packed message has {packed.shape[0]} rows but length="
                         f"{length} implies {rows + srows}")
    return rows


def wire_decode(packed: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`wire_encode` -> flat f32 of the padded length
    ``rows * 128``, or of ``length`` when given (the zero pad stripped)."""
    rows = _message_rows(packed, length)
    packed = packed.contiguous()
    out = torch.empty((rows, LANES), dtype=torch.float32, device=packed.device)
    _dequantize_block_into(packed[:rows], wire_scales(packed, rows), out)
    flat = out.view(-1)
    return flat if length is None else flat[:length]


def wire_decode_add(packed: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc += wire_decode(packed)`` in place, each element one fused
    multiply-add (``acc``: f32, ``rows * 128`` elements, contiguous). The
    reference's ring adds the decoded segment to its accumulator inside
    one compiled program, where XLA contracts the dequantize multiply and
    the add into an fma; so does this, in one pass on the card."""
    rows = _message_rows(packed, None)
    packed = packed.contiguous()
    _dequantize_block_into(packed[:rows], wire_scales(packed, rows), acc.view(rows, LANES),
                           accumulate=True)
    return acc
