"""Flash attention, forward and backward: online softmax over K/V tiles,
the probabilities recomputed from (q, k, lse) in the backward.

Port of ``theanompi_tpu/ops/pallas_attention.py``: the local kernels,
their custom VJP, and ``ring_flash_attention``, the sequence-parallel
ring whose every hop runs them at the hop's global offsets. The kernels
are hand-written CUDA for Hopper (``csrc/flash_attention.cu``): the
forward (TPU kernel #7) as
``flash_fwd_sm90`` (TMA + wgmma) for bf16 with D % 8 == 0, as
``flash_fwd_mma`` (mma.sync, 3xTF32: ``split_tf32x2``) for fp32, and as
``flash_fwd_mma_bf16`` (mma.sync bf16, cp.async or register-staged
loads) for the other bf16 heads (``_fwd_route``; the generic
``flash_fwd`` serves no route and stays for timing in turns); dq (#8
and its long-sequence twin #10) as ``flash_dq_sm90`` (TMA + wgmma, dS
from registers) for bf16 with D % 8 == 0, as ``flash_dq_mma`` (mma.sync,
every product 3xTF32, the forward's ring) for fp32, and as
``flash_dq_mma_bf16`` (mma.sync bf16, the forward's ring) for the other
bf16 heads (``_dq_route``; the generic ``flash_dq`` serves no route and
stays for timing in turns); dk/dv (#9 and #11) as
``flash_dkv_sm90`` (TMA + wgmma, dv exact on the tensor cores through a
three-part bf16 split of p) for bf16 with D % 8 == 0, as
``flash_dkv_mma`` (mma.sync, every product 3xTF32) for fp32, and as
``flash_dkv_mma_bf16`` (mma.sync bf16, the same split of p) for the other
bf16 heads (``_dkv_route``; the generic ``flash_dkv`` serves no route and
stays for timing in turns). The TPU needs the 2-D
backward kernels only because its 1-D ones keep the whole opposite
sequence in VMEM; the CUDA kernels stream it through shared memory a
tile at a time, so one kernel serves every T.

Layout contract, as the reference's: ``flash_attention(q, k, v)`` maps
``[B, Tq, H, D], [B, Tk, H, D] x2 -> [B, Tq, H, D]`` in q's dtype, with
the causal mask ``q_off + row >= k_off + col`` in global positions
(offsets 0 for one device; the sequence-parallel ring passes ``rank *
Tq`` and ``src * Tk``).
Inside, the kernels take heads-major ``[B*H, T, D]`` contiguous tensors.
``precision="highest"`` upcasts q, k and v to fp32 first.

Numerics, at the reference's cast points (see the kernel's header): the
products run in the input dtype with fp32 accumulation, softmax
statistics and every accumulator are fp32, and ``dv += p^T dO`` is an
fp32 x fp32 product with p not rounded (``flash_dkv_sm90`` and
``flash_dkv_mma_bf16`` run it as three exact bf16 products,
``split_bf16x3``); the fp32 forward's, dq's and dk/dv's products run as
three tf32 products each (``split_tf32x2``), held to a tolerance like
every fp32 sum here. The plain versions beside
the wrappers compute the same functions in PyTorch; the forward walks K
in tiles of ``block_k`` as the kernel does, so that bf16 rounds the same
probabilities relative to the same running maxima. The wrappers run the
plain versions only for CPU tensors; for CUDA tensors they launch the
kernels or raise. The reference's ``TMPI_PALLAS=0`` switch has no
counterpart.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from theanompi_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    KernelLibrary,
    LaunchCounter,
    require_cuda,
    stream_handle,
)
from theanompi_tpu_torch.ops.ring_attention import NEG
from theanompi_tpu_torch.parallel.mesh import axis_group, axis_index, post_hop

# the CUDA kernels' tile: rows of Q and of K/V per step (csrc kTile), and
# the widest head they hold in shared memory (csrc kD)
BLOCK = 64
MAX_HEAD_DIM = 64
_TINY = 1e-37  # l_safe: rows that see no key get o = 0 and lse ~ -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = KernelLibrary(
    "flash_attention.cu",
    {
        # device, q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale, dtype, stream
        "tmpi_flash_fwd": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                           _I, _P),
        # device, q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale, stream
        "tmpi_flash_fwd_sm90": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P),
        # device, q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale, stream
        "tmpi_flash_fwd_mma": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P),
        # device, q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale, stream
        "tmpi_flash_fwd_mma_bf16": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    ctypes.c_float, _P),
        # device, q, k, v, dO, lse, dsum, dq, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # dtype, stream
        "tmpi_flash_dq": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          ctypes.c_float, _I, _P),
        # device, q, k, v, dO, lse, dsum, dq, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # stream
        "tmpi_flash_dq_sm90": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P),
        # device, q, k, v, dO, lse, dsum, dq, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # stream
        "tmpi_flash_dq_mma_bf16": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   ctypes.c_float, _P),
        # device, q, k, v, dO, lse, dsum, dq, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # stream
        "tmpi_flash_dq_mma": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P),
        # device, q, k, v, dO, lse, dsum, dk, dv, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # dtype, stream
        "tmpi_flash_dkv": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _P),
        # device, q, k, v, dO, lse, dsum, dk, dv, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # stream
        "tmpi_flash_dkv_sm90": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P),
        # device, q, k, v, dO, lse, dsum, dk, dv, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # stream
        "tmpi_flash_dkv_mma": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P),
        # device, q, k, v, dO, lse, dsum, dk, dv, BH, Tq, Tk, D, q_off, k_off, causal, scale,
        # stream
        "tmpi_flash_dkv_mma_bf16": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, ctypes.c_float, _P),
    },
)

FLASH_FWD = LaunchCounter("flash_fwd")
FLASH_FWD_SM90 = LaunchCounter("flash_fwd_sm90")
FLASH_FWD_MMA = LaunchCounter("flash_fwd_mma")
FLASH_FWD_MMA_BF16 = LaunchCounter("flash_fwd_mma_bf16")
FLASH_DQ = LaunchCounter("flash_dq")
FLASH_DQ_SM90 = LaunchCounter("flash_dq_sm90")
FLASH_DQ_MMA = LaunchCounter("flash_dq_mma")
FLASH_DQ_MMA_BF16 = LaunchCounter("flash_dq_mma_bf16")
FLASH_DKV = LaunchCounter("flash_dkv")
FLASH_DKV_SM90 = LaunchCounter("flash_dkv_sm90")
FLASH_DKV_MMA = LaunchCounter("flash_dkv_mma")
FLASH_DKV_MMA_BF16 = LaunchCounter("flash_dkv_mma_bf16")


def build() -> float:
    """Build (or find) and load the kernel library; returns the seconds
    spent compiling (0.0 when it was already built)."""
    _LIB.get()
    return _LIB.build_seconds


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# --------------------------------------------------------------------------


def _visible(rows: int, cols: int, causal: bool, q_off: int, k_off: int, device) -> torch.Tensor:
    """``[rows, cols]``: may query row i see key column j (global positions)."""
    if not causal:
        return torch.ones((rows, cols), dtype=torch.bool, device=device)
    r = q_off + torch.arange(rows, device=device)[:, None]
    c = k_off + torch.arange(cols, device=device)[None]
    return r >= c


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with fp32 accumulation: bf16 operands are exact in
    fp32, so this is the tensor cores' bf16 x bf16 -> fp32 product."""
    return torch.matmul(a.float(), b.float())


def split_bf16x3(p: torch.Tensor):
    """fp32 ``p`` -> bf16 ``(hi, mid, lo)`` with ``hi + mid + lo == p``
    exactly for every ``p >= 2^-100`` (and 0): each part rounds the
    remainder the previous ones leave, and 3 x 8 significand bits cover
    fp32's 24. ``flash_dkv_sm90`` and ``flash_dkv_mma_bf16`` form the same
    parts in registers, so their ``dv += p^T dO`` is three exact bf16
    products on the tensor cores; two parts would leave up to 2^-17 of
    each p out."""
    hi = p.to(torch.bfloat16)
    r = p - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 (10 stored significand bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero (adding half of the dropped
    13 bits to the magnitude's bits carries into the kept ones), the low
    13 bits cleared. inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32x2(x: torch.Tensor):
    """fp32 ``x`` -> fp32 ``(hi, lo)`` holding tf32 values: ``hi =
    tf32(x)``, ``lo = tf32(x - hi)`` (``x - hi`` is exact). ``flash_fwd_mma``
    and ``flash_dkv_mma`` form the same parts in registers and take each
    product ``a b`` as
    ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` (3xTF32): what is left out is
    about 2^-22 of ``|a b|``, against 2^-11 for ``hi_a hi_b`` alone."""
    hi = _tf32(x.float())
    return hi, _tf32(x.float() - hi)


def flash_fwd_plain(q3, k3, v3, *, causal: bool, scale: float, q_off: int = 0, k_off: int = 0,
                    block_k: int = BLOCK):
    """``[BH, Tq, D], [BH, Tk, D] x2 -> (o [BH, Tq, D] in q3's dtype, lse
    [BH, Tq] f32)``: the online softmax over K tiles of ``block_k``."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    dev = q3.device
    acc = torch.zeros((BH, Tq, D), dtype=torch.float32, device=dev)
    m = torch.full((BH, Tq, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, Tq, 1), dtype=torch.float32, device=dev)
    for k0 in range(0, Tk, block_k):
        kt, vt = k3[:, k0:k0 + block_k], v3[:, k0:k0 + block_k]
        valid = _visible(Tq, kt.shape[1], causal, q_off, k_off + k0, dev)
        s = torch.where(valid, _dot(q3, kt.transpose(1, 2)) * scale, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _dot(p.to(v3.dtype), vt)
        m = m_new
    l_safe = torch.clamp_min(l, _TINY)
    return (acc / l_safe).to(q3.dtype), (m + torch.log(l_safe))[..., 0]


def _probs_and_ds(q3, k3, v3, do3, lse, dsum, causal, scale, q_off, k_off):
    """The backward's recomputed ``p`` (fp32) and ``ds`` (in k's dtype)."""
    Tq, Tk = q3.shape[1], k3.shape[1]
    valid = _visible(Tq, Tk, causal, q_off, k_off, q3.device)
    s = _dot(q3, k3.transpose(1, 2)) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = _dot(do3.to(v3.dtype), v3.transpose(1, 2))
    ds = (p * (dp - dsum[..., None]) * scale).to(k3.dtype)
    return p, ds


def flash_dq_plain(q3, k3, v3, do3, lse, dsum, *, causal: bool, scale: float, q_off: int = 0,
                   k_off: int = 0):
    """dq (f32 ``[BH, Tq, D]``) given the forward's lse and
    ``dsum = sum(dO * o)``, both ``[BH, Tq]`` f32."""
    _, ds = _probs_and_ds(q3, k3, v3, do3, lse, dsum, causal, scale, q_off, k_off)
    return _dot(ds, k3)


def flash_dkv_plain(q3, k3, v3, do3, lse, dsum, *, causal: bool, scale: float, q_off: int = 0,
                    k_off: int = 0):
    """(dk, dv), f32 ``[BH, Tk, D]``: dv from the unrounded p and fp32 dO."""
    p, ds = _probs_and_ds(q3, k3, v3, do3, lse, dsum, causal, scale, q_off, k_off)
    return _dot(ds.transpose(1, 2), q3), _dot(p.transpose(1, 2), do3)


# --------------------------------------------------------------------------
# wrappers: plain version for CPU tensors, the kernel for CUDA tensors
# --------------------------------------------------------------------------


def _check_inputs(q3, k3, v3, *extra, block_k: int = BLOCK):
    """Shapes and dtypes every kernel takes -> (BH, Tq, Tk, D)."""
    if q3.dim() != 3 or k3.dim() != 3 or v3.dim() != 3:
        raise ValueError("q3, k3, v3 must be [B*H, T, D]")
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    if k3.shape != (BH, Tk, D) or v3.shape != (BH, Tk, D):
        raise ValueError(f"k3 {tuple(k3.shape)} / v3 {tuple(v3.shape)} do not match q3 "
                         f"{tuple(q3.shape)}")
    if min(BH, Tq, Tk, D) < 1:
        raise ValueError(f"empty attention input: q3 {tuple(q3.shape)}, k3 {tuple(k3.shape)}")
    if q3.device.type != "cpu":
        if D > MAX_HEAD_DIM:
            raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}: the CUDA kernels hold heads up "
                             f"to {MAX_HEAD_DIM} wide in shared memory")
        if block_k != BLOCK:
            raise ValueError(f"the CUDA kernels tile K by {BLOCK} rows, not {block_k}")
        if q3.dtype not in DTYPE_CODES:
            raise TypeError(f"the kernels take {sorted(map(str, DTYPE_CODES))}, not {q3.dtype}")
        for name, t in (("q3", q3), ("k3", k3), ("v3", v3)) + extra:
            require_cuda(t, name, dtypes=(q3.dtype,), device=q3.device)
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    return BH, Tq, Tk, D


def _check_rows(t, name, shape, device):
    require_cuda(t, name, dtypes=(torch.float32,), device=device)
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 {tuple(shape)}, got "
                         f"{tuple(t.shape)} / {t.stride()}")


def _check_tma_aligned(**tensors):
    """The sm90 kernels' tensor maps need each base on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the tensor maps")


def _fwd_route(dtype: torch.dtype, D: int) -> str:
    """Which forward kernel takes a CUDA input, from its dtype and head
    dim alone: ``"sm90"`` (``flash_fwd_sm90``: TMA + wgmma, bf16, and
    the tensor maps need a row of D bf16 to be whole 16-byte units),
    ``"mma"`` (``flash_fwd_mma``: fp32, 3xTF32 on mma.sync, any D) or
    ``"mma_bf16"`` (``flash_fwd_mma_bf16``: bf16 with another D, odd
    included, on mma.sync)."""
    if dtype == torch.float32:
        return "mma"
    return "sm90" if dtype == torch.bfloat16 and D % 8 == 0 else "mma_bf16"


def _launch_fwd_generic(q3, k3, v3, *, causal, scale, q_off, k_off):
    """``flash_fwd_kernel`` (wmma, synchronous loads), fp32 or bf16. No
    route reaches it: it is called only from here, so that chip_smoke can
    time it in turns against the kernels that replaced it
    (``flash_fwd_mma``, ``flash_fwd_mma_bf16``)."""
    BH, Tq, D = q3.shape
    dev = q3.device
    o = torch.empty_like(q3)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_fwd(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                   o.data_ptr(), lse.data_ptr(), BH, Tq, k3.shape[1], D,
                                   int(q_off), int(k_off), int(causal), float(scale),
                                   DTYPE_CODES[q3.dtype], stream_handle(dev))
    _LIB.check(rc, "flash attention forward kernel")
    FLASH_FWD.launches += 1
    return o, lse


def _launch_fwd_sm90(q3, k3, v3, *, causal, scale, q_off, k_off):
    """``flash_fwd_sm90_kernel`` (TMA + wgmma), bf16 with D % 8 == 0."""
    BH, Tq, D = q3.shape
    dev = q3.device
    o = torch.empty_like(q3)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=dev)
    _check_tma_aligned(q3=q3, k3=k3, v3=v3, o=o)
    rc = _LIB.get().tmpi_flash_fwd_sm90(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                        o.data_ptr(), lse.data_ptr(), BH, Tq, k3.shape[1], D,
                                        int(q_off), int(k_off), int(causal), float(scale),
                                        stream_handle(dev))
    _LIB.check(rc, "flash attention forward kernel (sm90)")
    FLASH_FWD_SM90.launches += 1
    return o, lse


def _launch_fwd_mma(q3, k3, v3, *, causal, scale, q_off, k_off):
    """``flash_fwd_mma_kernel`` (cp.async ring, 3xTF32 on mma.sync), fp32."""
    BH, Tq, D = q3.shape
    dev = q3.device
    o = torch.empty_like(q3)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_fwd_mma(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                       o.data_ptr(), lse.data_ptr(), BH, Tq, k3.shape[1], D,
                                       int(q_off), int(k_off), int(causal), float(scale),
                                       stream_handle(dev))
    _LIB.check(rc, "flash attention forward kernel (mma)")
    FLASH_FWD_MMA.launches += 1
    return o, lse


def _launch_fwd_mma_bf16(q3, k3, v3, *, causal, scale, q_off, k_off):
    """``flash_fwd_mma_bf16_kernel`` (mma.sync bf16; 4-byte cp.async
    copies, or register-staged loads for odd D), bf16 at any D."""
    BH, Tq, D = q3.shape
    dev = q3.device
    o = torch.empty_like(q3)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_fwd_mma_bf16(dev.index, q3.data_ptr(), k3.data_ptr(),
                                            v3.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, Tq,
                                            k3.shape[1], D, int(q_off), int(k_off), int(causal),
                                            float(scale), stream_handle(dev))
    _LIB.check(rc, "flash attention forward kernel (mma, bf16)")
    FLASH_FWD_MMA_BF16.launches += 1
    return o, lse


_FWD_LAUNCH = {"sm90": _launch_fwd_sm90, "mma": _launch_fwd_mma,
               "mma_bf16": _launch_fwd_mma_bf16}


def flash_fwd(q3, k3, v3, *, causal: bool, scale: float, q_off: int = 0, k_off: int = 0,
              block_k: int = BLOCK):
    """Flash forward -> ``(o [BH, Tq, D] in q3's dtype, lse [BH, Tq] f32)``.
    A CUDA input goes to the kernel ``_fwd_route`` names; a failure there
    raises and is never handed to the other kernel."""
    D = _check_inputs(q3, k3, v3, block_k=block_k)[3]
    if q3.device.type == "cpu":
        return flash_fwd_plain(q3, k3, v3, causal=causal, scale=scale, q_off=q_off,
                               k_off=k_off, block_k=block_k)
    return _FWD_LAUNCH[_fwd_route(q3.dtype, D)](q3, k3, v3, causal=causal, scale=scale,
                                                q_off=q_off, k_off=k_off)


def _dq_route(dtype: torch.dtype, D: int) -> str:
    """Which dq kernel takes a CUDA input, from its dtype and head dim
    alone, as ``_fwd_route``: ``"sm90"`` (``flash_dq_sm90``: TMA + wgmma,
    bf16 with rows of whole 16-byte units), ``"mma"`` (``flash_dq_mma``:
    fp32, 3xTF32 on mma.sync, any D) or ``"mma_bf16"``
    (``flash_dq_mma_bf16``: bf16 with another D, odd included, on
    mma.sync)."""
    if dtype == torch.float32:
        return "mma"
    return "sm90" if dtype == torch.bfloat16 and D % 8 == 0 else "mma_bf16"


def _launch_dq_generic(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dq_kernel`` (wmma, synchronous loads, fp32 products as fp32
    FMAs), fp32 or bf16. No route reaches it: it is called only from here,
    so that chip_smoke can time it in turns against the kernels that
    replaced it (``flash_dq_mma``, ``flash_dq_mma_bf16``)."""
    BH, Tq, D = q3.shape
    dev = q3.device
    dq = torch.empty((BH, Tq, D), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_dq(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                  do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                                  BH, Tq, k3.shape[1], D, int(q_off), int(k_off), int(causal),
                                  float(scale), DTYPE_CODES[q3.dtype], stream_handle(dev))
    _LIB.check(rc, "flash attention dq kernel")
    FLASH_DQ.launches += 1
    return dq


def _launch_dq_sm90(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dq_sm90_kernel`` (TMA + wgmma, dS from registers), bf16
    with D % 8 == 0."""
    BH, Tq, D = q3.shape
    dev = q3.device
    dq = torch.empty((BH, Tq, D), dtype=torch.float32, device=dev)
    _check_tma_aligned(q3=q3, k3=k3, v3=v3, do3=do3)
    rc = _LIB.get().tmpi_flash_dq_sm90(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                       do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                                       dq.data_ptr(), BH, Tq, k3.shape[1], D, int(q_off),
                                       int(k_off), int(causal), float(scale), stream_handle(dev))
    _LIB.check(rc, "flash attention dq kernel (sm90)")
    FLASH_DQ_SM90.launches += 1
    return dq


def _launch_dq_mma_bf16(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dq_mma_bf16_kernel`` (mma.sync bf16, dS from registers;
    4-byte cp.async copies, or register-staged loads for odd D), bf16 at
    any D."""
    BH, Tq, D = q3.shape
    dev = q3.device
    dq = torch.empty((BH, Tq, D), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_dq_mma_bf16(dev.index, q3.data_ptr(), k3.data_ptr(),
                                           v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
                                           dsum.data_ptr(), dq.data_ptr(), BH, Tq, k3.shape[1],
                                           D, int(q_off), int(k_off), int(causal), float(scale),
                                           stream_handle(dev))
    _LIB.check(rc, "flash attention dq kernel (mma, bf16)")
    FLASH_DQ_MMA_BF16.launches += 1
    return dq


def _launch_dq_mma(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dq_mma_kernel`` (the forward's cp.async K/V ring, every
    product 3xTF32 on mma.sync, dS from registers), fp32 at any D."""
    BH, Tq, D = q3.shape
    dev = q3.device
    dq = torch.empty((BH, Tq, D), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_dq_mma(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                      do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                                      dq.data_ptr(), BH, Tq, k3.shape[1], D, int(q_off),
                                      int(k_off), int(causal), float(scale), stream_handle(dev))
    _LIB.check(rc, "flash attention dq kernel (mma)")
    FLASH_DQ_MMA.launches += 1
    return dq


_DQ_LAUNCH = {"sm90": _launch_dq_sm90, "mma": _launch_dq_mma, "mma_bf16": _launch_dq_mma_bf16}


def flash_dq(q3, k3, v3, do3, lse, dsum, *, causal: bool, scale: float, q_off: int = 0,
             k_off: int = 0):
    """dq partial, f32 ``[BH, Tq, D]``. A CUDA input goes to the kernel
    ``_dq_route`` names; a failure there raises and is never handed to
    another kernel."""
    BH, Tq, Tk, D = _check_inputs(q3, k3, v3, ("do3", do3))
    if q3.device.type == "cpu":
        return flash_dq_plain(q3, k3, v3, do3, lse, dsum, causal=causal, scale=scale,
                              q_off=q_off, k_off=k_off)
    dev = q3.device
    _check_rows(lse, "lse", (BH, Tq), dev)
    _check_rows(dsum, "dsum", (BH, Tq), dev)
    return _DQ_LAUNCH[_dq_route(q3.dtype, D)](q3, k3, v3, do3, lse, dsum, causal=causal,
                                              scale=scale, q_off=q_off, k_off=k_off)


def _dkv_route(dtype: torch.dtype, D: int) -> str:
    """Which dk/dv kernel takes a CUDA input, from its dtype and head dim
    alone, as ``_fwd_route``: ``"sm90"`` (``flash_dkv_sm90``: TMA +
    wgmma, bf16 with rows of whole 16-byte units), ``"mma"``
    (``flash_dkv_mma``: fp32, 3xTF32 on mma.sync, any D) or
    ``"mma_bf16"`` (``flash_dkv_mma_bf16``: bf16 with another D, odd
    included, on mma.sync)."""
    if dtype == torch.float32:
        return "mma"
    return "sm90" if dtype == torch.bfloat16 and D % 8 == 0 else "mma_bf16"


def _launch_dkv_generic(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dkv_kernel`` (wmma, synchronous loads, dv in fp32 FMAs),
    fp32 or bf16. No route reaches it: it is called only from here, so
    that chip_smoke can time it in turns against the kernels that replaced
    it (``flash_dkv_mma``, ``flash_dkv_mma_bf16``)."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    dev = q3.device
    dk = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    dv = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_dkv(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                   do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                                   dk.data_ptr(), dv.data_ptr(), BH, Tq, Tk, D, int(q_off),
                                   int(k_off), int(causal), float(scale),
                                   DTYPE_CODES[q3.dtype], stream_handle(dev))
    _LIB.check(rc, "flash attention dk/dv kernel")
    FLASH_DKV.launches += 1
    return dk, dv


def _launch_dkv_sm90(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dkv_sm90_kernel`` (TMA + wgmma, dv through the exact
    three-part split of p), bf16 with D % 8 == 0."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    dev = q3.device
    dk = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    dv = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    _check_tma_aligned(q3=q3, k3=k3, v3=v3, do3=do3)
    rc = _LIB.get().tmpi_flash_dkv_sm90(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                        do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(), BH, Tq, Tk, D, int(q_off),
                                        int(k_off), int(causal), float(scale),
                                        stream_handle(dev))
    _LIB.check(rc, "flash attention dk/dv kernel (sm90)")
    FLASH_DKV_SM90.launches += 1
    return dk, dv


def _launch_dkv_mma(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dkv_mma_kernel`` (cp.async Q/dO ring, every product
    3xTF32 on mma.sync), fp32 at any D."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    dev = q3.device
    dk = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    dv = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_dkv_mma(dev.index, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                       do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                                       dk.data_ptr(), dv.data_ptr(), BH, Tq, Tk, D, int(q_off),
                                       int(k_off), int(causal), float(scale), stream_handle(dev))
    _LIB.check(rc, "flash attention dk/dv kernel (mma)")
    FLASH_DKV_MMA.launches += 1
    return dk, dv


def _launch_dkv_mma_bf16(q3, k3, v3, do3, lse, dsum, *, causal, scale, q_off, k_off):
    """``flash_dkv_mma_bf16_kernel`` (mma.sync bf16, dv through the exact
    three-part split of p; 4-byte cp.async Q/dO ring, or register-staged
    loads for odd D), bf16 at any D."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    dev = q3.device
    dk = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    dv = torch.empty((BH, Tk, D), dtype=torch.float32, device=dev)
    rc = _LIB.get().tmpi_flash_dkv_mma_bf16(dev.index, q3.data_ptr(), k3.data_ptr(),
                                            v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
                                            dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
                                            Tq, Tk, D, int(q_off), int(k_off), int(causal),
                                            float(scale), stream_handle(dev))
    _LIB.check(rc, "flash attention dk/dv kernel (mma, bf16)")
    FLASH_DKV_MMA_BF16.launches += 1
    return dk, dv


_DKV_LAUNCH = {"sm90": _launch_dkv_sm90, "mma": _launch_dkv_mma,
               "mma_bf16": _launch_dkv_mma_bf16}


def flash_dkv(q3, k3, v3, do3, lse, dsum, *, causal: bool, scale: float, q_off: int = 0,
              k_off: int = 0):
    """(dk, dv) partials, f32 ``[BH, Tk, D]``. A CUDA input goes to the
    kernel ``_dkv_route`` names; a failure there raises and is never
    handed to another kernel."""
    BH, Tq, Tk, D = _check_inputs(q3, k3, v3, ("do3", do3))
    if q3.device.type == "cpu":
        return flash_dkv_plain(q3, k3, v3, do3, lse, dsum, causal=causal, scale=scale,
                               q_off=q_off, k_off=k_off)
    dev = q3.device
    _check_rows(lse, "lse", (BH, Tq), dev)
    _check_rows(dsum, "dsum", (BH, Tq), dev)
    return _DKV_LAUNCH[_dkv_route(q3.dtype, D)](q3, k3, v3, do3, lse, dsum, causal=causal,
                                                scale=scale, q_off=q_off, k_off=k_off)


# --------------------------------------------------------------------------
# the differentiable entry point
# --------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward saves ``(q3, k3,
    v3, o, lse)``; the backward forms ``dsum = sum(dO * o)`` in plain
    PyTorch (outside any kernel, as ``_dsum_of``), runs dq and dk/dv, and
    casts the f32 partials to the inputs' dtype."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale, block_k):
        o, lse = flash_fwd(q3, k3, v3, causal=causal, scale=scale, block_k=block_k)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, o, lse = ctx.saved_tensors
        g = g.contiguous()
        dsum = torch.sum(g.float() * o.float(), dim=-1)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_dq(q3, k3, v3, g, lse, dsum, **kw)
        dk, dv = flash_dkv(q3, k3, v3, g, lse, dsum, **kw)
        return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype), None, None, None


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None, precision=None, *, block_q: int = BLOCK,
                    block_k: int = BLOCK) -> torch.Tensor:
    """Fused attention, differentiable: drop-in for
    ``ops.ring_attention.full_attention_reference``.

    ``precision``: ``"highest"`` (or ``"float32"``) upcasts q, k, v to
    fp32; otherwise the products run in the input dtype with fp32
    accumulation. ``block_k``: the K tile of the online softmax (its bf16
    rounding depends on it); ``block_q``: the query tile, which changes no
    result. The CUDA kernels tile both by 64 and refuse other sizes."""
    out_dtype = q.dtype
    if precision in ("highest", "float32"):
        q, k, v = q.float(), k.float(), v.float()
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    if q.is_cuda and block_q != BLOCK:
        raise ValueError(f"the CUDA kernels tile Q by {BLOCK} rows, not {block_q}")
    B, Tq, H, D = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    o3 = _Flash.apply(_heads_major(q), _heads_major(k), _heads_major(v), bool(causal),
                      float(sc), int(block_k))
    return o3.view(B, H, Tq, D).permute(0, 2, 1, 3).to(out_dtype)


# --------------------------------------------------------------------------
# ring + flash: sequence-parallel attention whose hops are the kernels
# --------------------------------------------------------------------------


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` custom VJP over the whole ring of
    ``n`` ranks of ``group`` (this rank at ``rank``).

    Forward: hop ``t`` (``src = (rank - t) mod n``, the local block at
    ``t = 0``) runs ``flash_fwd`` on the K/V block from rank ``src`` with
    ``q_off = rank·Tq``, ``k_off = src·Tk`` and merges its ``(o_j,
    lse_j)`` (``o_j`` in q's dtype) into fp32 ``(acc, m, l)`` by the
    logsumexp law: a hop whose keys all lie in this rank's future gives
    ``o_j = 0`` and ``lse_j ~ -1e30``, weighted to zero. Then ``o = acc /
    max(l, 1e-37)`` and ``lse = m + log(max(l, 1e-37))``.

    Backward: ``dsum = sum(dO · o)`` once; hop ``t`` runs ``flash_dq``
    and ``flash_dkv`` on the block from ``src`` with the GLOBAL lse and
    dsum. dq accumulates here in fp32; the fp32 ``(dk, dv)`` partials
    travel with their block (one more exchange a hop) and are home after
    the n-th.

    Each hop's exchange is posted before the current block is folded
    (``overlap``), so that it runs beside the kernels; ``overlap=False``
    waits for it first. The exchange moves bits only, so both orders give
    the same result."""

    @staticmethod
    def forward(ctx, q3, k3, v3, group, n, rank, causal, scale, block_k, overlap):
        BH, Tq, D = q3.shape
        Tk = k3.shape[1]
        acc = torch.zeros((BH, Tq, D), dtype=torch.float32, device=q3.device)
        m = torch.full((BH, Tq), NEG, dtype=torch.float32, device=q3.device)
        l = torch.zeros((BH, Tq), dtype=torch.float32, device=q3.device)
        kv = [k3, v3]
        for t in range(n):
            nxt = post_hop(kv, n, 1, group) if t < n - 1 else None
            if nxt is not None and not overlap:
                kv_next = nxt.wait()
            src = (rank - t) % n
            o_j, lse_j = flash_fwd(q3, kv[0], kv[1], causal=causal, scale=scale,
                                   q_off=rank * Tq, k_off=src * Tk, block_k=block_k)
            m_new = torch.maximum(m, lse_j)
            w_old = torch.exp(m - m_new)
            w_new = torch.exp(lse_j - m_new)
            acc = acc * w_old[..., None] + o_j.float() * w_new[..., None]
            l = l * w_old + w_new
            m = m_new
            if nxt is not None:
                kv = kv_next if not overlap else nxt.wait()
        l_safe = torch.clamp_min(l, _TINY)
        o = (acc / l_safe[..., None]).to(q3.dtype)
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.args = (group, n, rank, causal, scale, overlap)
        return o

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, o, lse = ctx.saved_tensors
        group, n, rank, causal, scale, overlap = ctx.args
        g = g.contiguous()
        Tq, Tk = q3.shape[1], k3.shape[1]
        dsum = torch.sum(g.float() * o.float(), dim=-1)
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        kv = [k3, v3]
        dkv = None
        for t in range(n):
            nxt = post_hop(kv, n, 1, group) if t < n - 1 else None
            if nxt is not None and not overlap:
                kv_next = nxt.wait()
            src = (rank - t) % n
            kw = dict(causal=causal, scale=scale, q_off=rank * Tq, k_off=src * Tk)
            dq += flash_dq(q3, kv[0], kv[1], g, lse, dsum, **kw)
            dk_j, dv_j = flash_dkv(q3, kv[0], kv[1], g, lse, dsum, **kw)
            dkv = [dk_j, dv_j] if dkv is None else [dkv[0] + dk_j, dkv[1] + dv_j]
            if n > 1:  # the partials follow their block, posted after its [k, v] pair
                dkv = post_hop(dkv, n, 1, group).wait()
            if nxt is not None:
                kv = kv_next if not overlap else nxt.wait()
        return (dq.to(q3.dtype), dkv[0].to(k3.dtype), dkv[1].to(v3.dtype),
                None, None, None, None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name,
                         causal: bool = False, scale: Optional[float] = None, precision=None, *,
                         block_q: int = BLOCK, block_k: int = BLOCK,
                         overlap: bool = True) -> torch.Tensor:
    """Sequence-parallel ring attention whose every hop is the flash
    kernels (:class:`_RingFlash`): ``[B, T_local, H, D]`` local blocks of
    a sequence sharded over ``axis_name`` -> the local output block in
    q's dtype, causal in GLOBAL positions through the kernels' offsets
    (a block wholly in a rank's future costs the kernels no tile).
    ``precision`` and the block sizes as :func:`flash_attention`;
    ``overlap``: post each hop's exchange before folding the block."""
    group, n = axis_group(axis_name)
    rank = axis_index(axis_name)
    out_dtype = q.dtype
    if precision in ("highest", "float32"):
        q, k, v = q.float(), k.float(), v.float()
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    if q.is_cuda and block_q != BLOCK:
        raise ValueError(f"the CUDA kernels tile Q by {BLOCK} rows, not {block_q}")
    B, Tq, H, D = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    o3 = _RingFlash.apply(_heads_major(q), _heads_major(k), _heads_major(v), group, n, rank,
                          bool(causal), float(sc), int(block_k), bool(overlap))
    return o3.view(B, H, Tq, D).permute(0, 2, 1, 3).to(out_dtype)
