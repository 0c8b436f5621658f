"""Fused optimizer epilogue: weight decay + global-norm clip coefficient
+ momentum/Nesterov (or plain SGD) + parameter write, one kernel launch
per parameter leaf, in place.

Port of ``theanompi_tpu/ops/pallas_update.py``. The kernels are
hand-written CUDA for Hopper (``csrc/fused_update.cu``); beside each is
its plain PyTorch version (``fused_update_leaf_plain``,
``fused_sgd_leaf_plain``) with the same arithmetic in the same order:

    g_eff = g * coef + wd * p          (fp32)
    v'    = mu * v - lr * g_eff
    p'    = p + v'                     (classical)
    p'    = p + (mu * v' - lr * g_eff) (Nesterov)
    p'    = p - lr * g_eff             (sgd)

rounded once to the param dtype. The wrappers (``fused_update_leaf``,
``fused_sgd_leaf``) take the plain version only for CPU tensors; for
CUDA tensors they launch the kernel or raise. They update ``p`` (and
``v``) IN PLACE — the counterpart of the reference's
``input_output_aliases`` donation — and must be called under
``torch.no_grad()`` when ``p`` is a leaf that requires grad.

``lr`` and the clip coefficient travel to the kernel as one 2-element
fp32 tensor on the device (``scalars``), so the step stays free of host
syncs. ``clip_coefficient`` is plain PyTorch, as the reference computes
it outside any Pallas kernel.

The ``Optimizer`` builders (``fused_momentum_sgd`` / ``fused_nesterov_sgd``
/ ``fused_sgd`` / ``fuse_optimizer``) carry the fused form in ``apply``
and keep the reference tree-map math in ``update``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from theanompi_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    KernelLibrary,
    LaunchCounter,
    max_blocks,
    require_cuda,
    stream_handle,
)
from theanompi_tpu_torch.ops.optimizers import Optimizer, _acc_like
from theanompi_tpu_torch.tree import tree_leaves, tree_map

_P = ctypes.c_void_p
_LIB = KernelLibrary(
    "fused_update.cu",
    {
        # device, p_dtype, g_dtype, p, v, g, sc, n, mu, wd, nesterov, max_blocks, stream
        "tmpi_fused_momentum": (
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, _P,
        ),
        # device, p_dtype, g_dtype, p, g, sc, n, wd, max_blocks, stream
        "tmpi_fused_sgd": (
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P,
            ctypes.c_int64, ctypes.c_float, ctypes.c_int, _P,
        ),
    },
)

MOMENTUM = LaunchCounter("fused_momentum")
SGD = LaunchCounter("fused_sgd")

_PARAM_DTYPES = (torch.float32, torch.bfloat16)


def build() -> float:
    """Build (or find) and load the kernel library; returns the seconds
    spent compiling (0.0 when the library was already built)."""
    _LIB.get()
    return _LIB.build_seconds


def scalars(lr, clip_coef, device) -> torch.Tensor:
    """``[lr, clip_coef]`` as one contiguous fp32 tensor on ``device`` —
    the reference's (1, 2) scalar block. Tensors stay on the device (no
    host sync); Python numbers are placed once."""
    if isinstance(lr, torch.Tensor) or isinstance(clip_coef, torch.Tensor):
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=device).reshape(())
        c_t = torch.as_tensor(clip_coef, dtype=torch.float32, device=device).reshape(())
        return torch.stack([lr_t, c_t])
    return torch.tensor([float(lr), float(clip_coef)], dtype=torch.float32, device=device)


def fused_update_leaf_plain(p, v, g, sc, *, momentum: float, weight_decay: float,
                            nesterov: bool):
    """Plain PyTorch version of the momentum kernel (same op order);
    rewrites ``p`` and ``v`` in place and returns them."""
    lr, coef = sc[0], sc[1]
    pf = p.float()
    gf = g.float() * coef + weight_decay * pf
    v2 = momentum * v - lr * gf
    step = momentum * v2 - lr * gf if nesterov else v2
    new_p = (pf + step).to(p.dtype)
    v.copy_(v2)
    p.copy_(new_p)
    return p, v


def fused_sgd_leaf_plain(p, g, sc, *, weight_decay: float):
    """Plain PyTorch version of the SGD kernel; rewrites ``p`` in place."""
    lr, coef = sc[0], sc[1]
    pf = p.float()
    gf = g.float() * coef + weight_decay * pf
    p.copy_((pf - lr * gf).to(p.dtype))
    return p


def _check_leaf(p, g, sc, v=None):
    dev = p.device
    require_cuda(p, "param", dtypes=_PARAM_DTYPES, device=dev)
    if v is not None:
        require_cuda(v, "velocity", dtypes=(torch.float32,), device=dev, like=p)
    require_cuda(g, "grad", dtypes=(p.dtype, torch.float32), device=dev, like=p)
    require_cuda(sc, "scalars", dtypes=(torch.float32,), device=dev, numel=2)
    return dev, p.numel()


def fused_update_leaf(p, v, g, sc, *, momentum: float, weight_decay: float,
                      nesterov: bool):
    """One leaf through the fused momentum kernel, in place -> ``(p, v)``.

    ``p``: fp32 or bf16; ``v``: fp32, p's shape; ``g``: p's dtype or
    fp32; ``v`` and ``g`` dense with p's strides (conv weights, their
    velocities and cuDNN's grads are all channels_last); ``sc``:
    ``scalars(lr, clip_coef)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if p.device.type == "cpu":
        return fused_update_leaf_plain(p, v, g, sc, momentum=momentum,
                                       weight_decay=weight_decay, nesterov=nesterov)
    dev, n = _check_leaf(p, g, sc, v)
    if n == 0:
        return p, v
    lib = _LIB.get()
    rc = lib.tmpi_fused_momentum(
        dev.index, DTYPE_CODES[p.dtype], DTYPE_CODES[g.dtype],
        p.data_ptr(), v.data_ptr(), g.data_ptr(), sc.data_ptr(), n,
        float(momentum), float(weight_decay), int(bool(nesterov)),
        max_blocks(dev), stream_handle(dev),
    )
    _LIB.check(rc, "fused momentum kernel")
    MOMENTUM.launches += 1
    return p, v


def fused_sgd_leaf(p, g, sc, *, weight_decay: float):
    """Stateless fused SGD leaf, in place -> ``p`` (see ``fused_update_leaf``)."""
    if p.device.type == "cpu":
        return fused_sgd_leaf_plain(p, g, sc, weight_decay=weight_decay)
    dev, n = _check_leaf(p, g, sc)
    if n == 0:
        return p
    lib = _LIB.get()
    rc = lib.tmpi_fused_sgd(
        dev.index, DTYPE_CODES[p.dtype], DTYPE_CODES[g.dtype],
        p.data_ptr(), g.data_ptr(), sc.data_ptr(), n, float(weight_decay),
        max_blocks(dev), stream_handle(dev),
    )
    _LIB.check(rc, "fused sgd kernel")
    SGD.launches += 1
    return p


# --------------------------------------------------------------------------
# clip coefficient: ONE global scalar over the raw grads (plain PyTorch)
# --------------------------------------------------------------------------


def clip_coefficient(grads, clip_norm: Optional[float]) -> torch.Tensor:
    """``min(1, clip_norm / max(||g||, 1e-16))`` over ALL leaves' raw
    gradients in fp32, as a 0-d tensor on the grads' device. A zero-norm
    tree gives 1 (no 0/0); ``None`` gives the constant 1."""
    leaves = tree_leaves(grads)
    device = leaves[0].device if leaves else torch.device("cpu")
    one = torch.ones((), dtype=torch.float32, device=device)
    if clip_norm is None:
        return one
    gsq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(gsq)
    # a true division (``float / tensor`` would be reciprocal-then-multiply)
    limit = torch.full((), float(clip_norm), dtype=torch.float32, device=device)
    return torch.minimum(one, limit / torch.clamp(norm, min=1e-16))


# --------------------------------------------------------------------------
# drop-in Optimizer builders (``apply`` = fused, in place; ``update`` = the
# reference tree-map math)
# --------------------------------------------------------------------------


def _ref_decayed_clipped(grads, params, weight_decay, coef):
    return tree_map(lambda g, p: g.float() * coef + weight_decay * p.float(), grads, params)


def fused_momentum_sgd(momentum: float = 0.9, weight_decay: float = 0.0,
                       clip_norm: Optional[float] = None,
                       nesterov: bool = False) -> Optimizer:
    """Fused classical/Nesterov momentum SGD. State layout matches
    ``momentum_sgd``/``nesterov_sgd`` (``{"vel": fp32}``)."""
    mu, wd = float(momentum), float(weight_decay)

    def init(params):
        return {"vel": _acc_like(params)}

    def apply(grads, state, params, lr):
        leaves_p = tree_leaves(params)
        leaves_v = tree_leaves(state["vel"])
        leaves_g = tree_leaves(grads)
        coef = clip_coefficient(leaves_g, clip_norm)
        sc = scalars(lr, coef, leaves_p[0].device)
        with torch.no_grad():
            for p, v, g in zip(leaves_p, leaves_v, leaves_g):
                fused_update_leaf(p, v, g, sc, momentum=mu, weight_decay=wd,
                                  nesterov=nesterov)
        return params, state

    def update(grads, state, params, lr):
        coef = clip_coefficient(grads, clip_norm)
        g = _ref_decayed_clipped(grads, params, wd, coef)
        vel = tree_map(lambda v, gi: mu * v - lr * gi, state["vel"], g)
        if nesterov:
            updates = tree_map(lambda v, gi: mu * v - lr * gi, vel, g)
        else:
            updates = vel
        return updates, {"vel": vel}

    name = ("nesterov" if nesterov else "momentum") + "_fused"
    return Optimizer(name, init, update, apply)


def fused_nesterov_sgd(momentum: float = 0.9, weight_decay: float = 0.0,
                       clip_norm: Optional[float] = None) -> Optimizer:
    return fused_momentum_sgd(momentum, weight_decay, clip_norm, nesterov=True)


def fused_sgd(weight_decay: float = 0.0, clip_norm: Optional[float] = None) -> Optimizer:
    """Fused vanilla SGD (stateless, like ``sgd``)."""
    wd = float(weight_decay)

    def init(params):
        return ()

    def apply(grads, state, params, lr):
        leaves_p = tree_leaves(params)
        leaves_g = tree_leaves(grads)
        coef = clip_coefficient(leaves_g, clip_norm)
        sc = scalars(lr, coef, leaves_p[0].device)
        with torch.no_grad():
            for p, g in zip(leaves_p, leaves_g):
                fused_sgd_leaf(p, g, sc, weight_decay=wd)
        return params, state

    def update(grads, state, params, lr):
        coef = clip_coefficient(grads, clip_norm)
        g = _ref_decayed_clipped(grads, params, wd, coef)
        return tree_map(lambda gi: -lr * gi, g), state

    return Optimizer("sgd_fused", init, update, apply)


_FUSED_BUILDERS = {
    "sgd": fused_sgd,
    "momentum": fused_momentum_sgd,
    "nesterov": fused_nesterov_sgd,
}


def fuse_optimizer(name: str, **kwargs) -> Optimizer:
    """The ``--fused-update`` entry point: the fused equivalent of a
    registry optimizer name. Only the SGD family has a fused kernel;
    anything else is refused rather than silently run unfused."""
    try:
        builder = _FUSED_BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"--fused-update has no fused kernel for optimizer {name!r}; "
            f"fused rules: {sorted(_FUSED_BUILDERS)} "
            "(ops/fused_update.py — drop the flag for other rules)"
        ) from None
    return builder(**kwargs)
