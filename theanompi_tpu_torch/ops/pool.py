"""3x3 / stride-1 / SAME max pool on NHWC tensors, with Theano's
all-maxima backward.

Port of ``theanompi_tpu/ops/pallas_pool.py``. The kernels are
hand-written CUDA for Hopper (``csrc/pool.cu``): ``maxpool3x3_fwd``
(TPU kernel #12, ``_fwd_kernel``) and ``maxpool3x3_bwd`` (#13,
``_bwd_kernel``), both computed from a halo tile of the input staged in
shared memory; ``tile_plan`` is their launch plan, computed here and
passed to them as plain integers. ``maxpool3x3_s1`` is the
``torch.autograd.Function`` around them: like the reference's
``custom_vjp`` it saves ``(x, y)`` and hands ``(x, y, g)`` to the
backward.

The function, exactly as the TPU kernels compute it:

- forward: ``y[p]`` is the running ``maximum`` of the 9 neighbours of
  ``p`` in (di, dj) order, the border filled with ``-finfo(x.dtype).max``
  (not ``-inf``); a NaN anywhere in the window gives NaN;
- backward: ``dx[p] = sum_{di, dj} [x[p] == y[p + off]] * g[p + off]``
  with ``off = (di - 1, dj - 1)``: the comparison in fp32 (bf16 embeds
  exactly), y framed with fp32 ``-max`` and g with 0, the sum in fp32 from
  0.0 in the order di outer, dj inner, cast once to x's dtype. The
  gradient goes to EVERY position equal to the window's maximum (Theano's
  ``DownsampleFactorMaxGrad``), where ``F.max_pool2d``'s backward, like
  XLA's select-and-scatter, takes the first one only.

The plain versions (``maxpool3x3_fwd_plain``, ``maxpool3x3_bwd_plain``)
compute it with PyTorch ops in the same order; the kernels are
bit-identical to them in fp32 and bf16 (a NaN's payload aside). The
forward kernel takes its maxima row by row (three horizontal maxima,
then their maximum), which returns the same bits on every input free of
-0.0. The wrappers run them only for CPU tensors; for CUDA tensors they
launch the kernels or raise. There is no environment switch: a layer
routes here when its caller asks for it (``nn.Pool(..., kernel=True)``)
and ``routable`` holds.

One divergence inside the reference, followed here as its TPU kernel has
it: the reference's jnp fallback (``TMPI_PALLAS=0``) is a
``reduce_window`` whose ``-max`` init enters every window, so an interior
window of nothing but ``-inf`` gives ``-max`` there and ``-inf`` in the
TPU kernel and in this port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from theanompi_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    KernelLibrary,
    LaunchCounter,
    require_cuda,
    stream_handle,
)

# the reference's routing cap on H*W (its TPU kernel keeps a whole
# spatial map in VMEM); the CUDA kernels have no such limit, but both
# packages route the same layers
MAX_HW = 64 * 64
# the rows of the (di, dj) window, in the reference's order
_OFFSETS = tuple((di, dj) for di in range(3) for dj in range(3))

_P = ctypes.c_void_p
_I = ctypes.c_int
# H, W, C and the launch plan: bh, bw, cb_log2, bands, ctiles, cblocks,
# blocks, threads, smem (``tile_plan``)
_PLAN = (_I,) * 12
_LIB = KernelLibrary(
    "pool.cu",
    {
        # device, dtype, x, y, plan, stream
        "tmpi_maxpool3x3_fwd": (_I, _I, _P, _P, *_PLAN, _P),
        # device, dtype, x, y, g, dx, plan, stream
        "tmpi_maxpool3x3_bwd": (_I, _I, _P, _P, _P, _P, *_PLAN, _P),
    },
)

# The halo tile (csrc/pool.cu): a staged tensor's tile holds at most
# TILE_ELEMS elements (36 KB of bf16, 72 KB of fp32); a tile is at most
# MAX_TILE_COLS output columns wide (a band of 32 columns x 8 bf16 words
# is 256 threads) and MAX_CHANNELS channels deep; a CTA has at most
# MAX_THREADS threads.
TILE_ELEMS = 18432
MAX_TILE_COLS = 32
MAX_CHANNELS = 64
MAX_THREADS = 256
# sm_90's limits (H100): dynamic shared memory a CTA may have, shared
# memory an SM holds, the 1 KB the runtime keeps for each resident CTA,
# resident CTAs and threads an SM, the grid's x dimension
SMEM_PER_CTA = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_CTA = 1024
CTAS_PER_SM = 32
THREADS_PER_SM = 2048
GRID_X_MAX = 2 ** 31 - 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_plan(N: int, H: int, W: int, C: int, itemsize: int, *, rows: int | None = None,
              channels: int | None = None) -> dict:
    """The launch plan of both kernels for an ``[N, H, W, C]`` tensor of
    ``itemsize``-byte elements, as plain integers (see csrc/pool.cu).

    A CTA owns one image, a block of ``cb`` channels (a power of two: the
    smallest that holds C, at most ``MAX_CHANNELS``), a band of ``bh``
    output rows and ``bw`` output columns; it stages the ``(bh + 2) x
    (bw + 2) x cb`` halo of each input it reads. Bands and column tiles
    are as even as their counts allow. ``rows`` caps the band (else the
    tile budget ``TILE_ELEMS`` does) and ``channels`` sets ``cb``; both
    are for the variant tool. Blocks are numbered channel block fastest,
    then column tile, band and image, all in ``gridDim.x``. Raises when
    a tile or the grid does not fit the card."""
    if min(N, H, W, C) < 1:
        raise ValueError(f"tile_plan needs a non-empty map, got {(N, H, W, C)}")
    cb = channels or min(MAX_CHANNELS, max(8, 1 << (C - 1).bit_length()))
    if cb < 8 or cb & (cb - 1):
        raise ValueError(f"the channel block must be a power of two >= 8, got {cb}")
    ctiles = _ceil_div(W, MAX_TILE_COLS)
    bw = _ceil_div(W, ctiles)
    bh_max = rows or max(1, TILE_ELEMS // ((bw + 2) * cb) - 2)
    bands = _ceil_div(H, bh_max)
    bh = _ceil_div(H, bands)
    cblocks = _ceil_div(C, cb)
    blocks = N * bands * ctiles * cblocks
    # the vector path's (column, 16-byte word) pairs of a tile, whole warps
    threads = min(MAX_THREADS, _ceil_div(bw * cb * itemsize // 16, 32) * 32)
    tile_bytes = (bh + 2) * (bw + 2) * cb * itemsize
    plan = dict(bh=bh, bw=bw, cb=cb, cb_log2=cb.bit_length() - 1, bands=bands, ctiles=ctiles,
                cblocks=cblocks, blocks=blocks, threads=threads, smem_fwd=tile_bytes,
                smem_bwd=2 * tile_bytes)
    for k in ("fwd", "bwd"):
        smem = plan[f"smem_{k}"]
        if smem > SMEM_PER_CTA:
            raise ValueError(f"the {k} tile of {(N, H, W, C)} needs {smem} B of shared memory "
                             f"(at most {SMEM_PER_CTA})")
        plan[f"ctas_per_sm_{k}"] = min(CTAS_PER_SM, THREADS_PER_SM // threads,
                                       SMEM_PER_SM // (smem + SMEM_RESERVED_PER_CTA))
    if blocks > GRID_X_MAX:
        raise ValueError(f"{(N, H, W, C)} needs {blocks} CTAs, more than gridDim.x holds")
    return plan


def _plan_args(x: torch.Tensor, plan: dict, kind: str) -> tuple:
    _, H, W, C = x.shape
    return (H, W, C, plan["bh"], plan["bw"], plan["cb_log2"], plan["bands"], plan["ctiles"],
            plan["cblocks"], plan["blocks"], plan["threads"], plan[f"smem_{kind}"])


def launch_fwd(entry, x: torch.Tensor, y: torch.Tensor, plan: dict) -> None:
    """One launch of the forward through ``entry`` (the library's
    ``tmpi_maxpool3x3_fwd``, or a variant's) with ``plan``; the caller
    has checked the tensors. Raises on a CUDA error at launch."""
    dev = x.device
    rc = entry(dev.index, DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
               *_plan_args(x, plan, "fwd"), stream_handle(dev))
    _LIB.check(rc, "maxpool3x3 forward kernel")


def launch_bwd(entry, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, dx: torch.Tensor,
               plan: dict) -> None:
    """Likewise one launch of the backward."""
    dev = x.device
    rc = entry(dev.index, DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), g.data_ptr(),
               dx.data_ptr(), *_plan_args(x, plan, "bwd"), stream_handle(dev))
    _LIB.check(rc, "maxpool3x3 backward kernel")

MAXPOOL_FWD = LaunchCounter("maxpool3x3_fwd")
MAXPOOL_BWD = LaunchCounter("maxpool3x3_bwd")

_DTYPES = (torch.float32, torch.bfloat16)


def build() -> float:
    """Build (or find) and load the kernel library; returns the seconds
    spent compiling (0.0 when it was already built)."""
    _LIB.get()
    return _LIB.build_seconds


def routable(window, stride, padding, x) -> bool:
    """Can ``nn.Pool`` route this max pool to ``maxpool3x3_s1``? The
    reference's rules (``pallas_pool.py::routable``) without its
    environment switch: 3x3 window, stride 1, padding 1 / (1, 1) /
    ``"SAME"``, a 4-D input with H*W <= ``MAX_HW``."""
    if tuple(window) != (3, 3) or tuple(stride) != (1, 1) or x.dim() != 4:
        return False
    if isinstance(padding, str):
        if padding != "SAME":
            return False
    else:
        p = (padding, padding) if isinstance(padding, int) else tuple(padding)
        if p != (1, 1):
            return False
    return x.shape[1] * x.shape[2] <= MAX_HW


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# --------------------------------------------------------------------------


def _frame(t: torch.Tensor, fill: float) -> torch.Tensor:
    """Pad H and W of an NHWC tensor by 1 with ``fill``."""
    return F.pad(t, (0, 0, 1, 1, 1, 1), value=fill)


def maxpool3x3_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C] -> [N, H, W, C]``: the maximum of the 9 shifted
    views of x framed with ``-max``, in (di, dj) order."""
    H, W = x.shape[1], x.shape[2]
    xp = _frame(x, -torch.finfo(x.dtype).max)
    y = None
    for di, dj in _OFFSETS:
        s = xp[:, di:di + H, dj:dj + W]
        y = s if y is None else torch.maximum(y, s)
    return y.contiguous()


def maxpool3x3_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dx`` in x's dtype: the eq-mask sum over the 9 windows that hold
    each position, in fp32, in (di, dj) order."""
    H, W = x.shape[1], x.shape[2]
    xf = x.float()
    yp = _frame(y.float(), -torch.finfo(torch.float32).max)
    gp = _frame(g.float(), 0.0)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for di, dj in _OFFSETS:
        dx = dx + torch.where(xf == yp[:, di:di + H, dj:dj + W], gp[:, di:di + H, dj:dj + W], 0.0)
    return dx.to(x.dtype)


# --------------------------------------------------------------------------
# the wrappers: plain on the CPU, the kernel on the card (or raise)
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, like: torch.Tensor) -> None:
    require_cuda(t, name, dtypes=_DTYPES, device=like.device, like=like)
    if t.dtype != like.dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous NHWC tensor of {like.dtype}")


def _dims(x: torch.Tensor):
    if x.dim() != 4:
        raise ValueError(f"the pool kernels take NHWC tensors, got shape {tuple(x.shape)}")
    N, H, W, C = x.shape
    if max(H, W, C) >= 2 ** 31:
        raise ValueError(f"H, W and C of {tuple(x.shape)} must fit the kernels' int32 arguments")
    return N, H, W, C


def maxpool3x3_fwd(x: torch.Tensor) -> torch.Tensor:
    """Kernel #12: ``y = maxpool3x3(x)`` for a contiguous NHWC fp32 or
    bf16 tensor. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if x.device.type == "cpu":
        return maxpool3x3_fwd_plain(x)
    N, H, W, C = _dims(x)
    _check(x, "x", x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    launch_fwd(_LIB.get().tmpi_maxpool3x3_fwd, x, y, tile_plan(N, H, W, C, x.element_size()))
    MAXPOOL_FWD.launches += 1
    return y


def maxpool3x3_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel #13: the all-maxima ``dx`` from ``(x, y, g)``, all three
    contiguous NHWC of one dtype and shape. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return maxpool3x3_bwd_plain(x, y, g)
    N, H, W, C = _dims(x)
    _check(x, "x", x)
    _check(y, "y", x)
    _check(g, "g", x)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    launch_bwd(_LIB.get().tmpi_maxpool3x3_bwd, x, y, g, dx,
               tile_plan(N, H, W, C, x.element_size()))
    MAXPOOL_BWD.launches += 1
    return dx


class _MaxPool3x3S1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = maxpool3x3_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # the cotangent of y comes from the next layer's backward in its
        # own layout; the kernel reads it in y's
        return maxpool3x3_bwd(x, y, g.contiguous())


def maxpool3x3_s1(x: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 / stride-1 / SAME max pool whose backward is the
    all-maxima eq-mask kernel (see the module docstring)."""
    return _MaxPool3x3S1.apply(x)
