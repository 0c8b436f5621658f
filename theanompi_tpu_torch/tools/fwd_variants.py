"""Where flash_fwd_sm90's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.fwd_variants [--reps 50] [--out PATH]

Each variant is ``csrc/flash_attention.cu`` with one text edit, built by
nvcc into its own library (all builds started together) and launched
through ``tmpi_flash_fwd_sm90`` at the 136M LM's attention shape (BH 96,
T 1024, D 64, bf16, causal). The variants run in turns, forward and then
backward through the list, and each reports the mean of its two
readings (CUDA events over ``--reps`` launches each).

- ``base``: the source as it is; checked against the plain version;
- ``stages3`` / ``stages4``: a K/V ring of 3 or 4 stages;
- ``minblocks1``: ``__launch_bounds__(256, 1)``;
- ``mask_every_tile``: every tile takes the masked softmax path;
- ``fast_exp``, ``no_softmax``, ``no_softmax_no_pv``: diagnostics that
  compute another function (``__expf``; no softmax; no softmax and no
  P.V product). They say what the exponentials, the softmax and the
  second product cost; their outputs are not checked.

The last stdout line is a JSON summary. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import flash_attention as fa
from theanompi_tpu_torch.ops import kernels as K

SHAPE = dict(BH=96, T=1024, D=64)


def _variants(src: str) -> dict:
    def between(a: str, b: str) -> str:
        return src[src.index(a):src.index(b)]

    softmax = between("    if (k0 + kKeys > Tk || (causal", "#pragma unroll\n    for (int i = 0; i < 32; ++i) acc[i]")
    pv = between("    for (int kk = 0; kk < kKeys / 16; ++kk) {\n      wgmma_rs_tb",
                 "    wgmma_commit();\n    wgmma_wait();\n    fence_regs(acc);")
    exp = "float p = expf(sc[i] - (top ? mn0 : mn1));"
    no_softmax = "    corr0 = corr1 = 1.0f;\n"
    return {
        "base": [],
        "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        "stages4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
        "minblocks1": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
        "mask_every_tile": [("    if (k0 + kKeys > Tk || (causal", "    if (true || (causal")],
        "fast_exp": [(exp, exp.replace("expf(", "__expf("))],
        "no_softmax": [(softmax, no_softmax)],
        "no_softmax_no_pv": [(softmax, no_softmax), (pv, "")],
    }


def build_variants(workdir: Path, make_variants=_variants,
                   entry: str = "tmpi_flash_fwd_sm90", library=None) -> dict:
    """{variant: the library's ``entry``}, built in parallel ({variant:
    {entry: function}} when ``entry`` is a tuple of names);
    ``make_variants`` maps the source to {variant: [(old, new), ...]};
    ``library`` is the ``KernelLibrary`` whose source is edited (default:
    flash attention's)."""
    library = library or fa._LIB
    src = (K.CSRC_DIR / library.source).read_text()
    procs = {}
    for name, edits in make_variants(src).items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the edit's anchor is not in the source")
            text = text.replace(old, new)
        cu, so = workdir / f"{name}.cu", workdir / f"{name}.so"
        cu.write_text(text)
        # -I: the copy includes its headers (csrc/*.cuh) from beside the source
        cmd = [K.nvcc_path(), *K.NVCC_FLAGS, "-I", str(K.CSRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        loaded = {}
        for e in (entry,) if isinstance(entry, str) else entry:
            fn = getattr(lib, e)
            fn.argtypes = list(library.signatures[e])
            fn.restype = ctypes.c_int
            loaded[e] = fn
        fns[name] = loaded[entry] if isinstance(entry, str) else loaded
    return fns


def _ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(reps: int = 50) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(BH, T, D, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(BH, T, device=dev)
    scale = 1.0 / math.sqrt(D)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), BH, T, T, D, 0, 0, 1, scale, K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        launch(fns["base"])
        po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
        base_err = {"o_max_abs": (o.float() - po.float()).abs().max().item(),
                    "lse_max_abs": (lse - plse).abs().max().item()}
        readings = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            readings[name].append(_ms(lambda: launch(fns[name]), reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "reps": reps,
            "base_error": base_err,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def run(measure_fn, doc: str, tool: str, reps: int, argv=None) -> int:
    """A variant tool's command line: time the variants with
    ``measure_fn(reps)``, print each one's mean and readings, and the JSON
    summary as the last line (also written to ``--out``)."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=reps)
    p.add_argument("--out", default=None, help="also write the JSON summary here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool} needs a CUDA card")
    result = measure_fn(args.reps)
    for name, ms in result["ms"].items():
        print(f"{name:18s} {ms:.4f} ms  {result['readings_ms'][name]}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


def main(argv=None) -> int:
    return run(measure, __doc__, "fwd_variants", 50, argv)


if __name__ == "__main__":
    raise SystemExit(main())
