"""3x3 / stride-1 / SAME max pool on NHWC tensors, with Theano's
all-maxima backward.

Port of ``theanompi_tpu/ops/pallas_pool.py``. The kernels are
hand-written CUDA for Hopper (``csrc/pool.cu``): ``maxpool3x3_fwd``
(TPU kernel #12, ``_fwd_kernel``) and ``maxpool3x3_bwd`` (#13,
``_bwd_kernel``). ``maxpool3x3_s1`` is the ``torch.autograd.Function``
around them: like the reference's ``custom_vjp`` it saves ``(x, y)`` and
hands ``(x, y, g)`` to the backward.

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
wrappers run them only for CPU tensors; for CUDA tensors they launch the
kernels or raise. There is no environment switch: a layer routes here
when its caller asks for it (``nn.Pool(..., kernel=True)``) and
``routable`` holds.

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
    max_blocks,
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
_I64 = ctypes.c_int64
_LIB = KernelLibrary(
    "pool.cu",
    {
        # device, dtype, x, y, N, H, W, C, max_blocks, stream
        "tmpi_maxpool3x3_fwd": (_I, _I, _P, _P, _I64, _I, _I, _I, _I, _P),
        # device, dtype, x, y, g, dx, N, H, W, C, max_blocks, stream
        "tmpi_maxpool3x3_bwd": (_I, _I, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
    },
)

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
    dev = x.device
    rc = _LIB.get().tmpi_maxpool3x3_fwd(dev.index, DTYPE_CODES[x.dtype], x.data_ptr(),
                                         y.data_ptr(), N, H, W, C, max_blocks(dev),
                                         stream_handle(dev))
    _LIB.check(rc, "maxpool3x3 forward kernel")
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
    dev = x.device
    rc = _LIB.get().tmpi_maxpool3x3_bwd(dev.index, DTYPE_CODES[x.dtype], x.data_ptr(),
                                         y.data_ptr(), g.data_ptr(), dx.data_ptr(), N, H, W, C,
                                         max_blocks(dev), stream_handle(dev))
    _LIB.check(rc, "maxpool3x3 backward kernel")
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
