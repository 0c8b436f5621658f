"""Where the halo-tile max pool's time goes: variants of its source and of
its launch plan, timed in turns.

    python -m theanompi_tpu_torch.tools.pool_variants [--reps 10] [--out PATH]

Over GoogLeNet's nine inception pool inputs at batch 512, bf16 (one
training step's launches of each kernel), the forward (#12
``maxpool3x3_fwd``) and the backward (#13 ``maxpool3x3_bwd``), each of
these in turns (in order, then in reverse; CUDA events over ``--reps``
steps of nine launches):

- ``base``: ``csrc/pool.cu`` and ``tile_plan`` as they are;
- ``rows4`` / ``rows14``: bands of at most 4 rows (more halo rows
  re-read) or 14 (the 28x28 maps in 2 bands: a 61 KB bf16 tile, one
  backward CTA an SM); ``cb16`` / ``cb32``: channel blocks of 16 or 32
  (the base: 64): the base library with another plan;
- ``nine_way`` (#12): the forward reads its 9 neighbours from the tile
  for every output, in the plain version's row-major order, instead of
  keeping 3 horizontal maxima in registers;
- ``plain_loads``: the tile staged with 16-byte loads and shared-memory
  stores instead of ``cp.async``;
- ``ctas2``: at most 2 CTAs an SM (each asks for 100 KB of shared
  memory); ``minblocks4``: ``__launch_bounds__(256, 4)``, registers
  capped for 4 CTAs of 256 threads;
- ``lanes_fp32``: bf16 lanes one at a time in fp32 (the explicit NaN
  check for the maxima, an fp32 comparison for the backward's mask), as
  the grid-stride design computed them, instead of lane pairs
  (``max.NaN.bf16x2``, ``set.eq.bf16x2``);
- ``minblocks3``: ``__launch_bounds__(256, 3)``; ``regs96``: the
  backward's ``__launch_bounds__(224, 3)`` (the bf16 plans' widest CTA,
  3 of them an SM);
- ``memory_only``: a diagnostic that computes another function, its
  outputs not checked: each output is its input's centre word (the
  staging, x's loads and the stores without the arithmetic);
- ``decode64``: the grid-stride design's index arithmetic grafted on:
  each output's offset decoded from a flat 64-bit index with its five
  64-bit divisions, as the kernel this one replaced did a thread
  iteration (sizes that fault alone).

The text-edited variants are built by nvcc into their own libraries (all
builds started together, ``tools/fwd_variants.build_variants``). Every
variant's outputs are first checked bit for bit against the plain
version. ``build_parent`` builds the kernels of an earlier tree's
``csrc/pool.cu`` (the grid-stride design), for ``chip_smoke.py``'s
old/new turns. The last stdout line is a JSON summary. Needs a card and
nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import kernels as K
from theanompi_tpu_torch.ops import pool as tp
from theanompi_tpu_torch.tools.fwd_variants import _ms, build_variants, run

# the nine inception pool inputs at batch 512 (chip_smoke.py's
# inception_pool_shapes, from the model's own shape walk)
SHAPES = [(512, 28, 28, 192), (512, 28, 28, 256), (512, 14, 14, 480), (512, 14, 14, 512),
          (512, 14, 14, 512), (512, 14, 14, 512), (512, 14, 14, 528), (512, 7, 7, 832),
          (512, 7, 7, 832)]
ENTRIES = ("tmpi_maxpool3x3_fwd", "tmpi_maxpool3x3_bwd")
# variants that compute another function (their outputs are not checked)
DIAGNOSTICS = ("memory_only",)
PLANS = {"rows4": dict(rows=4), "rows14": dict(rows=14), "cb16": dict(channels=16),
         "cb32": dict(channels=32)}

_FWD_WALK_END = ("  }\n}\n\ntemplate <typename T, int VEC>\n__global__ void "
                 "__launch_bounds__(kMaxThreads)\nmaxpool_bwd_tile_kernel")
_NINE_WAY = """    for (int r = 0; r < o.rows; ++r) {
      P best = col[r * per_row];
#pragma unroll
      for (int q = 1; q < 9; ++q) best = vmax(best, col[(r + q / 3) * per_row + (q % 3) * stride]);
      *reinterpret_cast<P*>(y + off) = best;
      off += row_step;
    }
"""
# bf16 lane pairs (max.NaN.bf16x2, set.eq.bf16x2) off: one lane at a time in fp32
_PAIRS_MAX = ("  if constexpr (VEC % 2 == 0) {\n#pragma unroll\n"
              "    for (int j = 0; j < VEC / 2; ++j)\n"
              "      reinterpret_cast<__nv_bfloat162*>(r.v)[j] =\n          __hmax2_nan(")
_LANE_MAX = ("      r.v[k] = __bfloat16_as_ushort(\n"
             "          __hmax_nan(__ushort_as_bfloat16(a.v[k]), __ushort_as_bfloat16(b.v[k])));")
_LANE_MAX_FP32 = ("      r.v[k] = (BF16::f(a.v[k]) == BF16::f(a.v[k]) && (BF16::f(b.v[k]) != "
                  "BF16::f(b.v[k]) ||\n               BF16::f(b.v[k]) > BF16::f(a.v[k]))) ? "
                  "b.v[k] : a.v[k];")
_PAIRS_EQ = ("  if constexpr (VEC % 2 == 0) {\n#pragma unroll\n"
             "    for (int j = 0; j < VEC / 2; ++j) {\n      const unsigned m = __heq2_mask(")
def _decode64(var: str) -> str:
    """``var`` (an element offset) re-derived from its flat 64-bit index by
    the grid-stride design's five 64-bit divisions."""
    return f"""{{
        const int64_t groups = t.C / VEC;
        const int64_t i = {var} / VEC;
        const int64_t cg = i % groups, pix = i / groups;
        const int64_t ww = pix % t.W, hh = (pix / t.W) % t.H, nn = pix / ((int64_t)t.W * t.H);
        {var} = ((nn * t.H + hh) * t.W + ww) * t.C + cg * VEC;
      }}"""


# the backward's registers capped for 3 CTAs of 224 threads (bf16 plans only)
_BWD_BOUNDS = ("__launch_bounds__(kMaxThreads)\nmaxpool_bwd_tile_kernel",
               "__launch_bounds__(224, 3)\nmaxpool_bwd_tile_kernel")


def _variants(src: str) -> dict:
    walk = src[src.index("    // horizontal maxima of tile rows"):src.index(_FWD_WALK_END)]
    cp_async = ('    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), '
                '"l"(src) : "memory");')
    launch = "const Launch l{device, blocks, threads, smem, (cudaStream_t)stream};"
    return {
        "base": [],
        "nine_way": [(walk, _NINE_WAY)],
        "plain_loads": [(cp_async, "    (void)s;\n    *reinterpret_cast<uint4*>(dst) = "
                                   "__ldg(reinterpret_cast<const uint4*>(src));")],
        "ctas2": [(launch, launch.replace("smem,", "smem < 100 * 1024 ? 100 * 1024 : smem,"))],
        "minblocks4": [("__launch_bounds__(kMaxThreads)", "__launch_bounds__(kMaxThreads, 4)")],
        "decode64": [("off += row_step;", "off += row_step;\n      " + _decode64("off")),
                     ("const int64_t at = off + (int64_t)r * row_step;",
                      "int64_t at = off + (int64_t)r * row_step;\n      " + _decode64("at"))],
        "lanes_fp32": [(_PAIRS_MAX, _PAIRS_MAX.replace("VEC % 2 == 0", "false")),
                       (_LANE_MAX, _LANE_MAX_FP32),
                       (_PAIRS_EQ, _PAIRS_EQ.replace("VEC % 2 == 0", "false"))],
        "minblocks3": [("__launch_bounds__(kMaxThreads)", "__launch_bounds__(kMaxThreads, 3)")],
        "memory_only": [("*reinterpret_cast<P*>(y + off) = vmax(vmax(a, b), c);",
                         "*reinterpret_cast<P*>(y + off) = col[(r + 1) * per_row + stride];"),
                        ("      P out;\n      round_out(acc, out);\n"
                         "      *reinterpret_cast<P*>(dx + at) = out;",
                         "      *reinterpret_cast<P*>(dx + at) = xs;")],
        "regs96": [_BWD_BOUNDS],
    }


def step_inputs(dev, seed: int = 13):
    """The nine bf16 inputs (post-ReLU, as an inception pool's), their
    plain forward and a cotangent each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.relu(torch.randn(s, generator=g, device=dev)).to(torch.bfloat16) for s in SHAPES]
    gs = [torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in SHAPES]
    ys = [tp.maxpool3x3_fwd_plain(x) for x in xs]
    return xs, ys, gs


def measure(reps: int = 10) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    tp.build()
    xs, ys, gs = step_inputs(dev)
    dxs = [tp.maxpool3x3_bwd_plain(x, y, gg) for x, y, gg in zip(xs, ys, gs)]
    outs = [torch.empty_like(x) for x in xs]
    base_plans = [tp.tile_plan(*x.shape, x.element_size()) for x in xs]
    out = {"device": torch.cuda.get_device_name(dev), "reps": reps, "shapes": SHAPES,
           "plans": {name: [tp.tile_plan(*x.shape, x.element_size(), **kw) for x in xs]
                     for name, kw in PLANS.items()}, "ops": {}}
    out["plans"]["base"] = base_plans
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), _variants, ENTRIES, library=tp._LIB)
        for op, entry in zip(("forward", "backward"), ENTRIES):
            # nine_way edits the forward alone
            runs = {name: (fns[entry], base_plans) for name, fns in libs.items()
                    if op == "forward" or name != "nine_way"}
            for name in PLANS:
                runs[name] = (libs["base"][entry], out["plans"][name])

            def step(fn, plans, op=op):
                for i, x in enumerate(xs):
                    if op == "forward":
                        tp.launch_fwd(fn, x, outs[i], plans[i])
                    else:
                        tp.launch_bwd(fn, x, ys[i], gs[i], outs[i], plans[i])

            want = ys if op == "forward" else dxs
            for name, (fn, plans) in runs.items():
                if name in DIAGNOSTICS:
                    continue
                for o in outs:
                    o.fill_(float("nan"))
                step(fn, plans)
                torch.cuda.synchronize()
                if not all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                           for a, b in zip(outs, want)):
                    raise RuntimeError(f"{op} {name}: differs from the plain version")
            readings = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                readings[name].append(_ms(lambda: step(*runs[name]), reps))
            out["ops"][op] = {"ms": {n: sum(r) / len(r) for n, r in readings.items()},
                              "readings_ms": readings}
    out["ms"] = {f"{op}/{n}": t for op, d in out["ops"].items() for n, t in d["ms"].items()}
    out["readings_ms"] = {f"{op}/{n}": t for op, d in out["ops"].items()
                          for n, t in d["readings_ms"].items()}
    return out


# the grid-stride kernels' C interface (before the halo tile): device,
# dtype, x, y[, g, dx], N, H, W, C, max_blocks, stream
_I, _I64, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_PARENT_SIGNATURES = {
    "tmpi_maxpool3x3_fwd": (_I, _I, _P, _P, _I64, _I, _I, _I, _I, _P),
    "tmpi_maxpool3x3_bwd": (_I, _I, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
}


def build_parent(source: Path, workdir: Path):
    """The grid-stride kernels of an earlier tree's ``csrc/pool.cu``, built
    with the package's flags -> ``(fwd(x, y), bwd(x, y, g, dx))``
    launchers on the current stream (tensors checked by the caller).
    Raises if that source has not the grid-stride interface."""
    text = source.read_text()
    if "int64_t N, int H, int W, int C, int max_blocks" not in text:
        raise RuntimeError(f"{source} does not hold the grid-stride pool kernels")
    so = workdir / "pool_parent.so"
    proc = subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(so), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}"[-3000:])
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _PARENT_SIGNATURES.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int

    def fwd(x, y):
        dev = x.device
        N, H, W, C = x.shape
        tp._LIB.check(lib.tmpi_maxpool3x3_fwd(dev.index, K.DTYPE_CODES[x.dtype], x.data_ptr(),
                                              y.data_ptr(), N, H, W, C, K.max_blocks(dev),
                                              K.stream_handle(dev)), "the parent's forward")

    def bwd(x, y, g, dx):
        dev = x.device
        N, H, W, C = x.shape
        tp._LIB.check(lib.tmpi_maxpool3x3_bwd(dev.index, K.DTYPE_CODES[x.dtype], x.data_ptr(),
                                              y.data_ptr(), g.data_ptr(), dx.data_ptr(), N, H,
                                              W, C, K.max_blocks(dev), K.stream_handle(dev)),
                      "the parent's backward")

    return fwd, bwd


def main(argv=None) -> int:
    return run(measure, __doc__, "pool_variants", 10, argv)


if __name__ == "__main__":
    raise SystemExit(main())
