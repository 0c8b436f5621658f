"""Where the fused update's time goes: the multi-tensor kernel's variants
and the per-leaf launches it replaced, timed in turns.

    python -m theanompi_tpu_torch.tools.update_variants [--reps 20] [--out PATH]

Over one optimizer step of AlexNet's 16 leaves (fp32, and bf16 params
with bf16 grads) and of GoogLeNet's 128 (fp32), each leaf in its model's
layout (conv weights channels_last), for the momentum rule (#1
``fused_momentum``, momentum 0.9, weight decay 5e-4) and sgd (#2
``fused_sgd``), each of these in turns (in order, then in reverse):

- ``multi``: the package's wrapper (``fused_update_leaves`` /
  ``fused_sgd_leaves``), host work included: one launch per dtype group,
  ``CHUNK`` elements a chunk;
- ``base_prepared``: the same launch, the leaves checked and the table
  built once (the device's time alone);
- ``blocks1`` / ``blocks3`` (CTAs an SM the grid is sized for; the base:
  2) and ``quads4`` / ``quads16`` (4-element quads a thread loads before
  it computes; the base: 8), likewise prepared: text edits of
  ``csrc/fused_update.cu``, each built by nvcc into its own library (all
  builds started together);
- ``base_chunk4096`` / ``16384`` / ``32768``: the base kernel cut into
  other chunks;
- ``per_leaf``: the design it replaced, one grid-stride launch per leaf
  with scalar accesses (``tmpi_fused_momentum`` / ``tmpi_fused_sgd``),
  through a copy of the old wrapper, its per-leaf checks included.

Every variant's step is first checked bit for bit against the plain
version. The last stdout line is a JSON summary. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import fused_update as fu
from theanompi_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    max_blocks,
    require_cuda,
    stream_handle,
)
from theanompi_tpu_torch.tools.fwd_variants import _ms, build_variants, run
from theanompi_tpu_torch.tree import tree_leaves

RULES = {"momentum": dict(momentum=0.9, weight_decay=5e-4, nesterov=False),
         "sgd": dict(weight_decay=5e-4)}
CHUNKS = (4096, 16384, 32768)

_P = ctypes.c_void_p
# the replaced per-leaf entry points of csrc/fused_update.cu
PER_LEAF_SIGNATURES = {
    # device, p_dtype, g_dtype, p, v, g, sc, n, mu, wd, nesterov, max_blocks, stream
    "tmpi_fused_momentum": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P,
    ),
    # device, p_dtype, g_dtype, p, g, sc, n, wd, max_blocks, stream
    "tmpi_fused_sgd": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P,
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, _P,
    ),
}


def _per_leaf_lib():
    lib = fu._LIB.get()
    for name, args in PER_LEAF_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def _check_per_leaf(p, g, sc, v=None):
    dev = p.device
    require_cuda(p, "param", dtypes=(torch.float32, torch.bfloat16), device=dev)
    if v is not None:
        require_cuda(v, "velocity", dtypes=(torch.float32,), device=dev, like=p)
    require_cuda(g, "grad", dtypes=(p.dtype, torch.float32), device=dev, like=p)
    require_cuda(sc, "scalars", dtypes=(torch.float32,), device=dev, numel=2)
    return dev, p.numel()


def per_leaf_momentum(ps, vs, gs, sc, *, momentum, weight_decay, nesterov):
    """The replaced wrapper: checks and one launch per leaf, in place."""
    lib = _per_leaf_lib()
    for p, v, g in zip(ps, vs, gs, strict=True):
        dev, n = _check_per_leaf(p, g, sc, v)
        if n == 0:
            continue
        rc = lib.tmpi_fused_momentum(
            dev.index, DTYPE_CODES[p.dtype], DTYPE_CODES[g.dtype], p.data_ptr(), v.data_ptr(),
            g.data_ptr(), sc.data_ptr(), n, float(momentum), float(weight_decay),
            int(bool(nesterov)), max_blocks(dev), stream_handle(dev))
        fu._LIB.check(rc, "per-leaf momentum kernel")


def per_leaf_sgd(ps, gs, sc, *, weight_decay):
    """The replaced SGD wrapper: one launch per leaf, in place."""
    lib = _per_leaf_lib()
    for p, g in zip(ps, gs, strict=True):
        dev, n = _check_per_leaf(p, g, sc)
        if n == 0:
            continue
        rc = lib.tmpi_fused_sgd(
            dev.index, DTYPE_CODES[p.dtype], DTYPE_CODES[g.dtype], p.data_ptr(), g.data_ptr(),
            sc.data_ptr(), n, float(weight_decay), max_blocks(dev), stream_handle(dev))
        fu._LIB.check(rc, "per-leaf sgd kernel")


def step_fns(rule, ps, vs, gs, sc) -> dict:
    """One optimizer step of ``rule`` over the leaves, three ways:
    ``multi`` (the package's wrapper), ``per_leaf`` (the replaced
    launches) and ``plain`` (the plain version), each in place."""
    kw = RULES[rule]
    if rule == "sgd":
        return {"multi": lambda: fu.fused_sgd_leaves(ps, gs, sc, **kw),
                "per_leaf": lambda: per_leaf_sgd(ps, gs, sc, **kw),
                "plain": lambda: fu.fused_sgd_leaves_plain(ps, gs, sc, **kw)}
    return {"multi": lambda: fu.fused_update_leaves(ps, vs, gs, sc, **kw),
            "per_leaf": lambda: per_leaf_momentum(ps, vs, gs, sc, **kw),
            "plain": lambda: fu.fused_update_leaves_plain(ps, vs, gs, sc, **kw)}


def per_leaf_apply(rule, ps, vs, gs, lr):
    """The replaced ``Optimizer.apply`` (no clip): the clip coefficient and
    the scalar block, then one launch per leaf."""
    sc = fu.scalars(lr, fu.clip_coefficient(gs, None), ps[0].device)
    with torch.no_grad():
        if rule == "sgd":
            per_leaf_sgd(ps, gs, sc, **RULES["sgd"])
        else:
            per_leaf_momentum(ps, vs, gs, sc, **RULES["momentum"])


def prepare(entry, rule, ps, gs, sc, vs=None, *, chunk=fu.CHUNK, momentum=0.0,
            weight_decay=0.0, nesterov=False):
    """The package's multi-tensor launches through ``entry`` (a variant
    library's ``tmpi_fused_update_multi``) with ``chunk``-element chunks,
    the leaves checked and the table built once -> a function that
    launches them (its time is the device's: no host work but the ctypes
    calls)."""
    dev, launches = fu._checked_plan(ps, gs, sc, vs, chunk=chunk)
    tables = [(la, fu.table_rows(la)) for la in launches]
    code, stream = (1 if rule == "sgd" else 0), stream_handle(dev)

    def launch():
        for la, rows in tables:
            rc = entry(dev.index, code, la.key[0], la.key[1], rows.buffer_info()[0],
                       len(la.leaves), la.chunks, chunk, sc.data_ptr(), float(momentum),
                       float(weight_decay), int(bool(nesterov)), stream)
            fu._LIB.check(rc, "variant of the fused update kernel")

    return launch


def leaf_specs(model: str) -> list:
    """``[(shape, channels_last)]`` of a model's parameter leaves, in
    ``tree_leaves`` order (AlexNet 16, GoogLeNet 128)."""
    if model == "alexnet":
        from theanompi_tpu_torch.models.alex_net import AlexNet as cls
    else:
        from theanompi_tpu_torch.models.googlenet import GoogLeNet as cls
    params, _ = cls().init(torch.Generator().manual_seed(0), "cpu")
    return [(tuple(p.shape), p.dim() == 4 and not p.is_contiguous()
             and p.is_contiguous(memory_format=torch.channels_last))
            for p in tree_leaves(params)]


def make_leaves(specs, dev, seed: int = 1, dtype=torch.float32, gdtype=torch.float32):
    """p (0.01 scale), v (1e-3) and g (1e-2) on ``dev``, each leaf in its
    spec's layout."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(shape, cl, scale, dt):
        t = (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    return ([leaf(s, cl, 0.01, dtype) for s, cl in specs],
            [leaf(s, cl, 1e-3, torch.float32) for s, cl in specs],
            [leaf(s, cl, 1e-2, gdtype) for s, cl in specs])


def _variants(src: str) -> dict:
    blocks = "constexpr int kBlocksPerSm = 2;"
    quads = "constexpr int kQuads = 8;"
    return {
        "base": [],
        "blocks1": [(blocks, blocks.replace("2", "1"))],
        "blocks3": [(blocks, blocks.replace("2", "3"))],
        "quads4": [(quads, quads.replace("8", "4"))],
        "quads16": [(quads, quads.replace("8", "16"))],
    }


LEAF_SETS = (("alexnet", "alexnet", torch.float32), ("alexnet-bf16", "alexnet", torch.bfloat16),
             ("googlenet", "googlenet", torch.float32))


def measure(reps: int = 20, make_variants=_variants, chunk_entry: str = "base") -> dict:
    """Every variant of every leaf set and rule, in turns (see the module
    docstring); ``*_prepared`` and the text-edited variants time the
    device (the table built once), ``multi`` and ``per_leaf`` the
    wrappers, host work included."""
    dev = torch.device("cuda", torch.cuda.current_device())
    fu.build()
    out = {"device": torch.cuda.get_device_name(dev), "reps": reps, "chunk": fu.CHUNK,
           "table_capacity": fu._LIB.get().tmpi_fused_table_capacity(), "sets": {}}
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), make_variants, "tmpi_fused_update_multi",
                             library=fu._LIB)
        for label, model, dtype in LEAF_SETS:
            specs = leaf_specs(model)
            ps, vs, gs = make_leaves(specs, dev, dtype=dtype, gdtype=dtype)
            sc = fu.scalars(0.01, 1.0, dev)
            out["sets"][label] = {"leaves": len(ps), "elements": sum(p.numel() for p in ps),
                                  "dtype": str(dtype)}
            for rule, kw in RULES.items():
                vv = None if rule == "sgd" else vs
                ways = step_fns(rule, ps, vs, gs, sc)
                runs = {"multi": ways["multi"]}
                for name, fn in fns.items():
                    runs[f"{name}_prepared"] = prepare(fn, rule, ps, gs, sc, vv, **kw)
                for c in CHUNKS:
                    runs[f"{chunk_entry}_chunk{c}_prepared"] = prepare(
                        fns[chunk_entry], rule, ps, gs, sc, vv, chunk=c, **kw)
                runs["per_leaf"] = ways["per_leaf"]
                start = [p.clone() for p in ps], [v.clone() for v in vs]
                ways["plain"]()
                want_p, want_v = [p.clone() for p in ps], [v.clone() for v in vs]
                for name, fn in runs.items():
                    for p, v, p0, v0 in zip(ps, vs, *start):
                        p.copy_(p0)
                        v.copy_(v0)
                    fn()
                    if not (all(torch.equal(a, b) for a, b in zip(ps, want_p))
                            and all(torch.equal(a, b) for a, b in zip(vs, want_v))):
                        raise RuntimeError(f"{label} {rule} {name}: differs from the plain version")
                readings = {name: [] for name in runs}
                for name in list(runs) + list(runs)[::-1]:
                    readings[name].append(_ms(runs[name], reps))
                out["sets"][label][rule] = {
                    "ms": {n: sum(r) / len(r) for n, r in readings.items()},
                    "readings_ms": readings}
                del start, want_p, want_v
            del ps, vs, gs
            torch.cuda.empty_cache()
    # run()'s printout: one line per (leaf set, rule, variant)
    out["ms"] = {f"{m}/{r}/{n}": t for m, d in out["sets"].items()
                 for r in RULES for n, t in d[r]["ms"].items()}
    out["readings_ms"] = {f"{m}/{r}/{n}": t for m, d in out["sets"].items()
                          for r in RULES for n, t in d[r]["readings_ms"].items()}
    return out


def main(argv=None) -> int:
    return run(measure, __doc__, "update_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
