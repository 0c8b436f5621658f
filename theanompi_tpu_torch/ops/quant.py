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

Layout: the kernels view a flat f32 buffer as ``(rows, 128)`` lanes. The
block codec (#3-4) takes a LIST of flat f32 leaves in one launch
(``quantize_int8_block_leaves`` / ``dequantize_int8_block_leaves``): leaf
``i``'s rows, its tail zero-padded as the reference pads it, lie end to
end from row ``row0s[i]`` of one ``(R, 128)`` int8 value buffer and one
``(R, 1)`` f32 scale buffer. The work table (``ops/kernels.py::
work_table``) travels to the kernel as its parameter, split into several
launches only past the kernel-parameter limit. The one-buffer functions
(``quantize_int8_block`` and the wire's) are one-leaf launches of it.
``wire_encode`` / ``wire_decode`` take any length and pack values and the
per-row f32 scales into ONE int8 message of ``rows + ceil(rows / 32)``
rows: the scale bytes fill the tail rows little-endian, 32 scales to a
row, the rest zero. A message encoded by one package decodes in the
other.

The wrappers take the plain version only for CPU tensors; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import array
import ctypes
from typing import Optional

import numpy as np
import torch

from theanompi_tpu_torch.ops.kernels import (
    PARAM_LIMIT,
    TABLE_LEAF_BYTES,
    KernelLibrary,
    LaunchCounter,
    max_blocks,
    pack_rows,
    stream_handle,
    work_table,
)
from theanompi_tpu_torch.ops.kernels import table_capacity as kernel_table_capacity

LANES = 128
# f32 scales per 128-byte tail row of the packed wire
SCALES_PER_ROW = LANES // 4
_FLOOR = 1e-30
# fl(1/127): exactly representable in f32, so the multiply rounds once
# whatever precision PyTorch carries the Python scalar in
_INV127 = float(np.float32(1.0 / 127.0))
_F32, _I8 = torch.float32, torch.int8

_P = ctypes.c_void_p
_LIB = KernelLibrary(
    "quant.cu",
    {
        "tmpi_block_codec_capacity": (),
        # device, op, rows, n_leaves, chunks, chunk_rows, stream
        "tmpi_block_codec_multi": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _P),
        # device, x, vals, scale, scratch, rows, max_blocks, stream
        "tmpi_quant": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P),
        # device, x, vals, scale, partial, rows, n_partial, max_blocks, stream
        "tmpi_quant_three_pass": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, _P),
        # device, vals, scale, out, rows, stream
        "tmpi_dequant": (ctypes.c_int, _P, _P, _P, ctypes.c_int64, _P),
    },
)

QUANT_BLOCK = LaunchCounter("quant_block")
DEQUANT_BLOCK = LaunchCounter("dequant_block")
QUANT = LaunchCounter("quant")
QUANT_THREE_PASS = LaunchCounter("quant_three_pass")
DEQUANT = LaunchCounter("dequant")

# threads per block of the whole-buffer passes (csrc/quant.cu kThreads)
_THREADS = 256

# 128-lane rows a chunk of the block codec's work table (a CTA's unit of work)
CHUNK_ROWS = 64
# the kernel's parameter struct (csrc/quant.cu, struct Table): a 16-byte
# header (leaves, chunks, chunk rows, op as int32), then a
# TABLE_LEAF_BYTES row per leaf (x, vals, scales, n; chunk0 and row0)
TABLE_HEADER_BYTES = 16
_OP_QUANTIZE, _OP_DEQUANTIZE, _OP_DEQUANTIZE_ADD = 0, 1, 2


def table_capacity(param_limit: int = PARAM_LIMIT) -> int:
    """Leaves one launch's work table can hold under ``param_limit``."""
    return kernel_table_capacity(TABLE_HEADER_BYTES, param_limit)


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


def dequantize_add_int8_block_plain(vals, scales, acc) -> torch.Tensor:
    """``acc + vals * scales`` rounded ONCE, as a fused multiply-add: the
    product of an int8 and an f32 is exact in f64, and so is its sum with
    an f32 unless their exponents lie more than ~22 bits apart, where the
    one rounding to f32 agrees with the fma's too except for a sum within
    2^-53 of an f32 rounding midpoint."""
    return (acc.double() + vals.double() * scales.double()).float()


def leaf_rows(lengths) -> tuple:
    """``(row0s, rows)``: each leaf's first 128-lane row when the leaves'
    zero-padded rows lie end to end, and the rows of them all."""
    row0s, rows = [], 0
    for n in lengths:
        row0s.append(rows)
        rows += -(-n // LANES)
    return tuple(row0s), rows


def quantize_int8_block_leaves_plain(xs):
    """Per leaf ``pad_rows`` and :func:`quantize_int8_block_plain`, the
    rows end to end -> ``(vals (R, 128) int8, scales (R, 1) f32, row0s)``."""
    parts = [quantize_int8_block_plain(pad_rows(x)) for x in xs]
    return (torch.cat([v for v, _ in parts]), torch.cat([s for _, s in parts]),
            leaf_rows([x.numel() for x in xs])[0])


def dequantize_int8_block_leaves_plain(vals, scales, outs, row0s, accumulate: bool = False):
    """Per leaf :func:`dequantize_int8_block_plain` (or, with
    ``accumulate``, :func:`dequantize_add_int8_block_plain` into the
    leaf) of its rows from ``row0s[i]`` on, its ``n`` elements written
    into ``outs[i]`` in place -> ``outs``."""
    for out, r0 in zip(outs, row0s, strict=True):
        flat = out.view(-1)
        n = flat.numel()
        r1 = r0 + -(-n // LANES)
        v, s = vals[r0:r1], scales[r0:r1]
        got = (dequantize_add_int8_block_plain(v, s, pad_rows(flat)) if accumulate
               else dequantize_int8_block_plain(v, s))
        flat.copy_(got.reshape(-1)[:n])
    return outs


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
    float4s of f32 and char4s of int8)."""
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


def _device_of(ts, name: str) -> torch.device:
    if not ts:
        raise ValueError(f"no {name} leaves")
    if not isinstance(ts[0], torch.Tensor):
        raise TypeError(f"{name}[0] must be a tensor, got {type(ts[0]).__name__}")
    return ts[0].device


def _leaves(ts, name: str, dev: torch.device) -> tuple:
    """One pass of checks over a leaf list -> ``(pointers, lengths)``:
    each leaf an f32 tensor on ``dev``, contiguous and, on the card,
    16-byte aligned; ``_check`` words a failure, naming the leaf."""
    cuda = dev.type == "cuda"
    ptrs, lengths = [], []
    for i, t in enumerate(ts):
        if not (isinstance(t, torch.Tensor) and t.dtype is _F32 and t.device == dev
                and t.is_contiguous() and not (cuda and t.data_ptr() % 16)):
            _check(t, f"{name}[{i}]", _F32, tuple(getattr(t, "shape", ())), 16, dev)
        ptrs.append(t.data_ptr())
        lengths.append(t.numel())
    return ptrs, lengths


def table_rows(launch, row0s) -> array.array:
    """A launch's work table as the kernel's ``Leaf`` rows, 5 int64 each
    (x, vals, scales, n, chunk0 | row0 << 32); ``row0s`` are the first
    rows of every leaf of the caller's list. The kernel reads them at
    ``rows.buffer_info()[0]``."""
    return pack_rows((*ptrs, n, c0, row0s[i]) for i, ptrs, n, c0 in
                     zip(launch.leaves, launch.ptrs, launch.lengths, launch.chunk0))


def _tables(ptrs, lengths, row0s, vals, scales, capacity, chunk_rows) -> list:
    """The launches over the checked leaves -> ``[(rows, leaves, chunks)]``:
    leaf i's values and scales from row ``row0s[i]`` of ``vals`` /
    ``scales`` on, ``chunk_rows`` rows a chunk, at most ``capacity``
    leaves a launch (default: the built library's)."""
    if capacity is None:
        capacity = _LIB.get().tmpi_block_codec_capacity()
    vp, sp = vals.data_ptr(), scales.data_ptr()
    launches = work_table([(x, vp + r0 * LANES, sp + r0 * 4) for x, r0 in zip(ptrs, row0s)],
                          lengths, [0] * len(ptrs), chunk=chunk_rows * LANES, capacity=capacity)
    return [(table_rows(la, row0s), len(la.leaves), la.chunks) for la in launches]


def _run(op: int, dev: torch.device, tables, counter: LaunchCounter, what: str,
         chunk_rows: int = CHUNK_ROWS, entry=None) -> None:
    """One launch per table through ``entry`` (default: the library's
    ``tmpi_block_codec_multi``), each counted."""
    entry = entry or _LIB.get().tmpi_block_codec_multi
    stream = stream_handle(dev)
    for rows, leaves, chunks in tables:
        _LIB.check(entry(dev.index, op, rows.buffer_info()[0], leaves, chunks, chunk_rows,
                         stream), what)
        counter.launches += 1


def _quantize_plan(xs, vals=None, scales=None, capacity=None, chunk_rows=CHUNK_ROWS):
    """One pass of checks over the leaves and the output buffers ->
    ``(dev, vals, scales, row0s, tables)``; ``vals`` / ``scales`` are
    allocated when not given; ``tables`` is None on the CPU."""
    dev = _device_of(xs, "x") if vals is None else vals.device
    ptrs, lengths = _leaves(xs, "x", dev)
    row0s, rows = leaf_rows(lengths)
    if vals is None:
        vals = torch.empty((rows, LANES), dtype=_I8, device=dev)
        scales = torch.empty((rows, 1), dtype=_F32, device=dev)
    else:
        _check(vals, "vals", _I8, (rows, LANES), 4, dev)
        _check(scales, "scales", _F32, (rows, 1), 4, dev)
    if dev.type == "cpu":
        return dev, vals, scales, row0s, None
    return dev, vals, scales, row0s, _tables(ptrs, lengths, row0s, vals, scales, capacity,
                                             chunk_rows)


def _quantize_into(xs, vals=None, scales=None, *, capacity=None):
    """The block quantizer over a list of flat f32 leaves, in one launch
    (per ``capacity`` leaves), into ``vals`` / ``scales`` (allocated when
    not given) -> ``(vals, scales, row0s)``."""
    dev, vals, scales, row0s, tables = _quantize_plan(xs, vals, scales, capacity)
    if tables is None:
        v, s, _ = quantize_int8_block_leaves_plain(xs)
        vals.copy_(v)
        scales.copy_(s)
    else:
        _run(_OP_QUANTIZE, dev, tables, QUANT_BLOCK, "int8 block quantize kernel")
    return vals, scales, row0s


def quantize_int8_block_leaves(xs):
    """Every flat f32 leaf of ``xs`` block-quantized, one absmax scale per
    128-element row, in ONE launch -> ``(vals (R, 128) int8, scales (R, 1)
    f32, row0s)``: leaf ``i``'s rows, the tail zero-padded, from row
    ``row0s[i]`` on. CPU leaves take the plain version; CUDA leaves
    (contiguous, 16-byte aligned) launch the kernel or raise."""
    return _quantize_into(xs)


def _dequantize_plan(vals, scales, outs, row0s, capacity=None, chunk_rows=CHUNK_ROWS):
    """One pass of checks -> ``(dev, tables)``; ``tables`` is None on the CPU."""
    if not isinstance(vals, torch.Tensor):
        raise TypeError(f"vals must be a tensor, got {type(vals).__name__}")
    dev = vals.device
    rows = vals.shape[0] if vals.dim() == 2 else -1
    _check(vals, "vals", _I8, (rows, LANES), 4, dev)
    _check(scales, "scales", _F32, (rows, 1), 4, dev)
    ptrs, lengths = _leaves(outs, "out", dev)
    if len(row0s) != len(outs):
        raise ValueError(f"{len(outs)} outputs, {len(row0s)} first rows")
    for i, (n, r0) in enumerate(zip(lengths, row0s)):
        if r0 < 0 or r0 + -(-n // LANES) > rows:
            raise ValueError(f"out[{i}]'s {-(-n // LANES)} rows from row {r0} pass the {rows} "
                             "rows of vals")
    filled = [p for p, n in zip(ptrs, lengths) if n]
    if len(set(filled)) != len(filled):
        raise ValueError("two outputs share one buffer; one launch would write it twice at once")
    if dev.type == "cpu":
        return dev, None
    return dev, _tables(ptrs, lengths, row0s, vals, scales, capacity, chunk_rows)


def _dequantize_into(vals, scales, outs, row0s, accumulate: bool = False, *, capacity=None):
    dev, tables = _dequantize_plan(vals, scales, outs, row0s, capacity)
    if tables is None:
        return dequantize_int8_block_leaves_plain(vals, scales, outs, row0s, accumulate)
    _run(_OP_DEQUANTIZE_ADD if accumulate else _OP_DEQUANTIZE, dev, tables, DEQUANT_BLOCK,
         "int8 block dequantize kernel")
    return outs


def dequantize_int8_block_leaves(vals, scales, outs, row0s, accumulate: bool = False):
    """Inverse of :func:`quantize_int8_block_leaves`, in ONE launch, in
    place -> ``outs``: flat f32 leaf ``outs[i]`` gets its ``n`` elements
    from the rows of ``vals`` / ``scales`` from ``row0s[i]`` on; with
    ``accumulate`` each is added to it with one rounding, as a fused
    multiply-add (the ring's decode-and-add). CPU tensors take the plain
    version; CUDA tensors (``outs`` 16-byte aligned, ``vals`` and
    ``scales`` 4-byte) launch the kernel or raise."""
    return _dequantize_into(vals, scales, outs, row0s, accumulate)


def quantize_int8_block(x2d: torch.Tensor):
    """``(rows, 128) f32 -> ((rows, 128) int8, (rows, 1) f32 scales)``
    with one absmax scale per row (128-element block)."""
    _rows_of(x2d)
    if x2d.device.type == "cpu":
        return quantize_int8_block_plain(x2d)
    vals, scales, _ = _quantize_into([x2d])
    return vals, scales


def dequantize_int8_block(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_block`."""
    rows = _rows_of(vals)
    if vals.device.type == "cpu":
        return dequantize_int8_block_plain(vals, scales)
    out = torch.empty((rows, LANES), dtype=_F32, device=vals.device)
    _dequantize_into(vals, scales, [out], (0,))
    return out


def quantize_int8(x2d: torch.Tensor):
    """``(rows, 128) f32 -> ((rows, 128) int8, (1, 1) f32 scale)`` with a
    single absmax scale for the whole buffer. On the card one launch
    (``quant_whole_kernel``): each CTA's absmax, a grid-wide barrier on a
    counter in this call's scratch, then every CTA quantizes its share
    with the scale."""
    rows, dev = _rows_of(x2d), x2d.device
    if dev.type == "cpu":
        return quantize_int8_plain(x2d)
    _check(x2d, "x", torch.float32, (rows, LANES), 16, dev)
    vals = torch.empty((rows, LANES), dtype=torch.int8, device=dev)
    scale = torch.empty((1, 1), dtype=torch.float32, device=dev)
    cap = max_blocks(dev)
    # the barrier's counter (zeroed by the launch) and one partial a CTA
    scratch = torch.empty((1 + cap,), dtype=torch.int32, device=dev)
    rc = _LIB.get().tmpi_quant(dev.index, x2d.data_ptr(), vals.data_ptr(), scale.data_ptr(),
                               scratch.data_ptr(), rows, cap, stream_handle(dev))
    _LIB.check(rc, "int8 quantize kernel")
    QUANT.launches += 1
    return vals, scale


def _quantize_int8_three_pass(x2d: torch.Tensor):
    """``quantize_int8`` as the three launches ``quant_whole_kernel``
    replaced (block maxima, their max and the scale, then the values). No
    route reaches it: it is called only from here, so that chip_smoke can
    time it in turns against the one-launch kernel. CUDA tensors only."""
    rows, dev = _rows_of(x2d), x2d.device
    _check(x2d, "x", torch.float32, (rows, LANES), 16, dev)
    vals = torch.empty((rows, LANES), dtype=torch.int8, device=dev)
    scale = torch.empty((1, 1), dtype=torch.float32, device=dev)
    n_partial = min(-(-rows * (LANES // 4) // _THREADS), max_blocks(dev))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_quant_three_pass(dev.index, x2d.data_ptr(), vals.data_ptr(),
                                          scale.data_ptr(), partial.data_ptr(), rows, n_partial,
                                          max_blocks(dev), stream_handle(dev))
    _LIB.check(rc, "int8 quantize kernel (three-pass launcher)")
    QUANT_THREE_PASS.launches += 1
    return vals, scale


def dequantize_int8(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``float(vals) * scale``, one
    rounding. On the card ``vals`` must be contiguous and 16-byte aligned
    (the kernel loads 16 values a thread) and ``scale`` a contiguous
    ``(1, 1)`` f32 on the same card; the checks run in one pass, and
    ``_check`` words a failure."""
    rows, dev = _rows_of(vals), vals.device
    if dev.type == "cpu":
        return dequantize_int8_plain(vals, scale)
    if not (vals.dtype is _I8 and vals.is_contiguous() and vals.data_ptr() % 16 == 0
            and isinstance(scale, torch.Tensor) and scale.dtype is _F32
            and scale.shape == (1, 1) and scale.device == dev and scale.is_contiguous()
            and scale.data_ptr() % 4 == 0):
        _check(vals, "vals", _I8, (rows, LANES), 16, dev)
        _check(scale, "scale", _F32, (1, 1), 4, dev)
    out = torch.empty((rows, LANES), dtype=_F32, device=dev)
    rc = _LIB.get().tmpi_dequant(dev.index, vals.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                 rows, stream_handle(dev))
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
    ``(rows + ceil(rows / 32), 128)``. On the card one launch of the
    block quantizer writes the values (the tail's zero pad included) and
    the scale bytes straight into the message."""
    if chunk.dtype != torch.float32:
        raise TypeError(f"wire_encode takes float32, got {chunk.dtype}")
    rows, srows = wire_rows(chunk.numel())
    flat = chunk.reshape(-1)
    if flat.is_cuda and flat.data_ptr() % 16:  # a slice at an odd offset
        flat = flat.clone()
    packed = torch.empty((rows + srows, LANES), dtype=torch.int8, device=chunk.device)
    packed[rows:].zero_()
    _quantize_into([flat], packed[:rows], wire_scales(packed, rows))
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
    ``rows * 128``, or of ``length`` when given (only those elements are
    decoded)."""
    rows = _message_rows(packed, length)
    packed = packed.contiguous()
    out = torch.empty((rows * LANES if length is None else length,), dtype=_F32,
                      device=packed.device)
    _dequantize_into(packed[:rows], wire_scales(packed, rows), [out], (0,))
    return out


def wire_decode_add(packed: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc += wire_decode(packed)`` in place, each element one fused
    multiply-add (``acc``: f32, ``rows * 128`` elements, contiguous). The
    reference's ring adds the decoded segment to its accumulator inside
    one compiled program, where XLA contracts the dequantize multiply and
    the add into an fma; so does this, in one pass on the card."""
    rows = _message_rows(packed, None)
    packed = packed.contiguous()
    _dequantize_into(packed[:rows], wire_scales(packed, rows), [acc.view(rows, LANES)], (0,),
                     accumulate=True)
    return acc
