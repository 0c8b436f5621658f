"""Fused optimizer epilogue: weight decay + global-norm clip coefficient
+ momentum/Nesterov (or plain SGD) + parameter write, in place, as ONE
kernel launch over all of a step's leaves (one per dtype group).

Port of ``theanompi_tpu/ops/pallas_update.py``. The kernel is
hand-written CUDA for Hopper (``csrc/fused_update.cu``); beside it is its
plain PyTorch version (``fused_update_leaf_plain``,
``fused_sgd_leaf_plain``, looped over the leaves by
``fused_update_leaves_plain`` / ``fused_sgd_leaves_plain``) with the same
arithmetic in the same order:

    g_eff = g * coef + wd * p          (fp32)
    v'    = mu * v - lr * g_eff
    p'    = p + v'                     (classical)
    p'    = p + (mu * v' - lr * g_eff) (Nesterov)
    p'    = p - lr * g_eff             (sgd)

rounded once to the param dtype. The wrappers (``fused_update_leaves``,
``fused_sgd_leaves``; the reference's per-leaf ``fused_update_leaf`` /
``fused_sgd_leaf`` are one-leaf calls of them) take the plain version
only for CPU tensors; for CUDA tensors they launch the kernel or raise.
On the card the leaves are grouped by (param dtype, grad dtype), each
group is cut into ``CHUNK``-element chunks, and the work table
(``ops/kernels.py::work_table``) travels to the kernel as its parameter:
one launch per group, split only past the kernel-parameter limit. They
update ``p`` (and ``v``) IN PLACE — the counterpart of the reference's
``input_output_aliases`` donation — and must be called under
``torch.no_grad()`` when ``p`` is a leaf that requires grad.

``lr`` and the clip coefficient travel to the kernel as one 2-element
fp32 tensor on the device (``scalars``), so the step stays free of host
syncs. ``clip_coefficient`` is plain PyTorch, as the reference computes
it outside any Pallas kernel.

The ``Optimizer`` builders (``fused_momentum_sgd`` / ``fused_nesterov_sgd``
/ ``fused_sgd`` / ``fuse_optimizer``) carry the fused form in ``apply``
(one call of the wrappers a step) and keep the reference tree-map math
in ``update``.
"""

from __future__ import annotations

import array
import ctypes
from typing import Optional

import torch

from theanompi_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    PARAM_LIMIT,
    TABLE_LEAF_BYTES,
    KernelLibrary,
    LaunchCounter,
    is_dense,
    pack_rows,
    require_cuda,
    stream_handle,
    work_table,
)
from theanompi_tpu_torch.ops.kernels import table_capacity as kernel_table_capacity
from theanompi_tpu_torch.ops.optimizers import Optimizer, _acc_like
from theanompi_tpu_torch.tree import tree_leaves, tree_map

_P = ctypes.c_void_p
_LIB = KernelLibrary(
    "fused_update.cu",
    {
        "tmpi_fused_table_capacity": (),
        # device, rule, p_dtype, g_dtype, rows, n_leaves, chunks, chunk, sc, mu, wd,
        # nesterov, stream
        "tmpi_fused_update_multi": (
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P, ctypes.c_float, ctypes.c_float, ctypes.c_int, _P,
        ),
    },
)

MOMENTUM = LaunchCounter("fused_momentum")
SGD = LaunchCounter("fused_sgd")

_PARAM_DTYPES = (torch.float32, torch.bfloat16)
_F32 = torch.float32

# elements per chunk of the work table: a CTA's unit of work
CHUNK = 8192
# the kernel's parameter struct (csrc/fused_update.cu, struct Table): a
# 32-byte header, then a TABLE_LEAF_BYTES row per leaf (p, v, g, n;
# chunk0 and the aligned flag)
TABLE_HEADER_BYTES = 32
_RULE_MOMENTUM, _RULE_SGD = 0, 1


def table_capacity(param_limit: int = PARAM_LIMIT) -> int:
    """Leaves one launch's work table can hold under ``param_limit``."""
    return kernel_table_capacity(TABLE_HEADER_BYTES, param_limit)


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


def fused_update_leaves_plain(ps, vs, gs, sc, *, momentum: float, weight_decay: float,
                              nesterov: bool):
    """The momentum kernel's plain version over a list of leaves, leaf by
    leaf; rewrites every ``p`` and ``v`` in place."""
    for p, v, g in zip(ps, vs, gs, strict=True):
        fused_update_leaf_plain(p, v, g, sc, momentum=momentum, weight_decay=weight_decay,
                                nesterov=nesterov)
    return ps, vs


def fused_sgd_leaves_plain(ps, gs, sc, *, weight_decay: float):
    """The SGD kernel's plain version over a list of leaves."""
    for p, g in zip(ps, gs, strict=True):
        fused_sgd_leaf_plain(p, g, sc, weight_decay=weight_decay)
    return ps


def _plain_route(*lists) -> bool:
    """True for CPU leaves (the plain version's route), False for the
    kernel's; decided by the first leaf. A CPU list holding a tensor of
    another device raises."""
    if not lists[0] or lists[0][0].device.type != "cpu":
        return not lists[0]
    other = [t.device for ts in lists for t in ts if t.device.type != "cpu"]
    if other:
        raise ValueError(f"the leaves mix the CPU with {other[0]}: the plain version takes CPU "
                         "tensors, the kernel CUDA tensors")
    return True


def _gather(ps, gs, vs=None, dev=None):
    """One pass over the leaves -> (pointers, lengths, dtype keys) for
    ``work_table``. With ``dev``, each leaf also passes the kernel's
    argument checks (``require_cuda``'s, which word any failure): p an fp32
    or bf16 CUDA tensor on ``dev``, dense (default or channels_last
    order); v fp32 and g p's dtype or fp32, both of p's shape and strides."""
    ptrs, lengths, keys = [], [], []
    for i, p in enumerate(ps):
        g = gs[i]
        v = None if vs is None else vs[i]
        try:
            pd, gd = p.dtype, g.dtype
            if dev is not None:
                shape, stride = p.shape, p.stride()
                if not (p.device == dev and g.device == dev and pd in DTYPE_CODES
                        and (gd is pd or gd is _F32) and is_dense(p)
                        and g.shape == shape and g.stride() == stride
                        and (v is None or (v.device == dev and v.dtype is _F32
                                           and v.shape == shape and v.stride() == stride))):
                    raise ValueError
            keys.append((DTYPE_CODES[pd], DTYPE_CODES[gd]))
        except (AttributeError, KeyError, ValueError):
            _explain(i, p, v, g, dev)
        lengths.append(p.numel())
        ptrs.append((p.data_ptr(), g.data_ptr()) if v is None else
                    (p.data_ptr(), v.data_ptr(), g.data_ptr()))
    return ptrs, lengths, keys


def _explain(i, p, v, g, dev):
    """Raise ``require_cuda``'s error for the leaf that failed a check."""
    try:
        require_cuda(p, "param", dtypes=_PARAM_DTYPES, device=dev)
        if v is not None:
            require_cuda(v, "velocity", dtypes=(_F32,), device=dev, like=p)
        require_cuda(g, "grad", dtypes=(p.dtype, _F32), device=dev, like=p)
    except (TypeError, ValueError) as e:
        raise type(e)(f"leaf {i}: {e}") from None
    raise ValueError(f"leaf {i}: not a leaf the kernel takes")


def plan(ps, gs, vs=None, *, capacity: int, chunk: int = CHUNK) -> list:
    """The multi-tensor launches for these leaves (``ops/kernels.py::
    TableLaunch``): one per (param dtype, grad dtype) group, split past
    ``capacity`` leaves. Reads only pointers, lengths and dtypes."""
    return work_table(*_gather(ps, gs, vs), chunk=chunk, capacity=capacity)


def table_rows(launch) -> array.array:
    """A launch's work table as the kernel's ``Leaf`` rows, 5 int64 each
    (an sgd leaf's velocity address is 0); the kernel reads them at
    ``rows.buffer_info()[0]``."""
    return pack_rows(
        (*(ptrs if len(ptrs) == 3 else (ptrs[0], 0, ptrs[1])), n, c0, aligned)
        for ptrs, n, c0, aligned in zip(launch.ptrs, launch.lengths, launch.chunk0,
                                        launch.aligned))


def _checked_plan(ps, gs, sc, vs, capacity=None, chunk=CHUNK):
    """The launches, after every leaf passed the kernel's checks ->
    ``(device, launches)``; ``capacity`` defaults to the built library's."""
    if not len(ps) == len(gs) == (len(ps) if vs is None else len(vs)):
        raise ValueError(f"{len(ps)} params, {len(gs)} grads"
                         + ("" if vs is None else f", {len(vs)} velocities"))
    dev = ps[0].device
    require_cuda(ps[0], "param", dtypes=_PARAM_DTYPES, device=dev)
    require_cuda(sc, "scalars", dtypes=(_F32,), device=dev, numel=2)
    ptrs, lengths, keys = _gather(ps, gs, vs, dev)
    filled = [pt[0] for pt, n in zip(ptrs, lengths) if n]
    if len(set(filled)) != len(filled):
        raise ValueError("two param leaves share one buffer; one launch would update it twice "
                         "at once")
    if capacity is None:
        capacity = _LIB.get().tmpi_fused_table_capacity()
    return dev, work_table(ptrs, lengths, keys, chunk=chunk, capacity=capacity)


def _launch(rule, ps, gs, sc, vs, *, momentum, weight_decay, nesterov, counter, what):
    dev, launches = _checked_plan(ps, gs, sc, vs)
    lib = _LIB.get()
    stream = stream_handle(dev)
    for launch in launches:
        rows = table_rows(launch)
        rc = lib.tmpi_fused_update_multi(
            dev.index, rule, launch.key[0], launch.key[1], rows.buffer_info()[0],
            len(launch.leaves), launch.chunks, CHUNK, sc.data_ptr(), float(momentum),
            float(weight_decay), int(bool(nesterov)), stream,
        )
        _LIB.check(rc, what)
        counter.launches += 1


def fused_update_leaves(ps, vs, gs, sc, *, momentum: float, weight_decay: float,
                        nesterov: bool):
    """Every leaf through the fused momentum kernel, in place -> ``(ps, vs)``.

    ``ps``: fp32 or bf16 leaves; ``vs``: fp32, each its p's shape; ``gs``:
    each its p's dtype or fp32; each ``v`` and ``g`` dense with its p's
    strides (conv weights, their velocities and cuDNN's grads are all
    channels_last); ``sc``: ``scalars(lr, clip_coef)``. CPU tensors take
    the plain version; CUDA tensors launch the kernel, once per (param
    dtype, grad dtype) group, or raise."""
    if _plain_route(ps, vs, gs):
        return fused_update_leaves_plain(ps, vs, gs, sc, momentum=momentum,
                                         weight_decay=weight_decay, nesterov=nesterov)
    _launch(_RULE_MOMENTUM, ps, gs, sc, vs, momentum=momentum, weight_decay=weight_decay,
            nesterov=nesterov, counter=MOMENTUM, what="fused momentum kernel")
    return ps, vs


def fused_sgd_leaves(ps, gs, sc, *, weight_decay: float):
    """Stateless fused SGD over every leaf, in place -> ``ps`` (see
    ``fused_update_leaves``)."""
    if _plain_route(ps, gs):
        return fused_sgd_leaves_plain(ps, gs, sc, weight_decay=weight_decay)
    _launch(_RULE_SGD, ps, gs, sc, None, momentum=0.0, weight_decay=weight_decay,
            nesterov=False, counter=SGD, what="fused sgd kernel")
    return ps


def fused_update_leaf(p, v, g, sc, *, momentum: float, weight_decay: float,
                      nesterov: bool):
    """One leaf through the fused momentum kernel, in place -> ``(p, v)``:
    ``fused_update_leaves`` of a one-leaf list."""
    fused_update_leaves([p], [v], [g], sc, momentum=momentum, weight_decay=weight_decay,
                        nesterov=nesterov)
    return p, v


def fused_sgd_leaf(p, g, sc, *, weight_decay: float):
    """Stateless fused SGD leaf, in place -> ``p`` (``fused_sgd_leaves`` of
    a one-leaf list)."""
    fused_sgd_leaves([p], [g], sc, weight_decay=weight_decay)
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
            fused_update_leaves(leaves_p, leaves_v, leaves_g, sc, momentum=mu,
                                weight_decay=wd, nesterov=nesterov)
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
            fused_sgd_leaves(leaves_p, leaves_g, sc, weight_decay=wd)
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
