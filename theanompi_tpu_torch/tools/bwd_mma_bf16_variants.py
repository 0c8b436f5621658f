"""Where the bf16 mma.sync backward's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.bwd_mma_bf16_variants [--reps 20] [--out PATH]

The counterpart of ``fwd_mma_bf16_variants`` (same build and turns) for
``flash_dq_mma_bf16`` and ``flash_dkv_mma_bf16``, the dq and dk/dv of bf16
heads with D % 8 != 0: each variant is ``csrc/flash_attention.cu`` with one
text edit, launched through ``tmpi_flash_dq_mma_bf16`` and
``tmpi_flash_dkv_mma_bf16`` at BH 96, T 1024, D 60 (bf16, causal), random
bf16 inputs, lse and dsum from the plain forward. A ``dq_*`` variant times
the dq kernel, a ``dkv_*`` one the dk/dv kernel, ``base`` both. In the same
turns: ``old_dq`` and ``old_dkv``, the generic kernels these heads took
before (``fa._launch_dq_generic``, ``fa._launch_dkv_generic``), and
``sdpa_bwd``, PyTorch's ``scaled_dot_product_attention`` backward at D 60
(dq, dk and dv in one call; a yardstick only).

- ``base``: the source as it is (4-byte cp.async loads at D 60);
- ``dq_staged`` / ``dkv_staged``: the register-staged loads of odd heads
  at D 60 as well;
- ``dq_minblocks2``: dq's registers held to two CTAs an SM (128 a thread);
- ``dkv_qsub32``: S^T and dP^T formed 32 queries at a time with the
  cp.async loads, not 64;
- ``dkv_staged_qsub32`` / ``dkv_staged_qsub64``: the staged loads with
  steps of 32 or 64 queries, not 16;
  the six above compute the same function and are checked against the
  plain versions at phase flash's bf16 limits (dq and dk rtol 1e-4 + 2^-9
  of the largest value, dv rtol 1e-4 + 1e-5 of it);
- ``dq_no_s``, ``dq_no_dp``, ``dq_no_dq``, ``dkv_no_s``, ``dkv_no_dp``,
  ``dkv_no_dk``, ``dkv_no_dv`` (the three dV products and the split that
  feeds them), ``dkv_hi_only_dv`` (dV from p's hi part alone): diagnostics
  that compute another function, each with one product (or dV's lo and mid
  products) dropped. They say what each product costs; not checked.

Each variant's registers, stack and spills per kernel instantiation
(``cuobjdump --dump-resource-usage`` of its library, from the toolkit of
nvcc) are in the summary. The last stdout line is a JSON summary. Needs a
card and nvcc.
"""

from __future__ import annotations

import math
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import flash_attention as fa
from theanompi_tpu_torch.ops import kernels as K
from theanompi_tpu_torch.tools.fwd_variants import _ms, build_variants, run

SHAPE = dict(BH=96, T=1024, D=60)
ENTRIES = ("tmpi_flash_dq_mma_bf16", "tmpi_flash_dkv_mma_bf16")
# the variants that compute the kernels' own function, checked before timing
SAME_FUNCTION = ("base", "dq_staged", "dq_minblocks2", "dkv_staged", "dkv_qsub32",
                 "dkv_staged_qsub32", "dkv_staged_qsub64")


def _variants(src: str) -> dict:
    def pair(acc: str, a: str, b: str, indent: int) -> str:
        pad = " " * indent
        return (f"{pad}mma_bf16({acc} + 8 * p, {a}, {b}[p][0], {b}[p][1]);\n"
                f"{pad}mma_bf16({acc} + 8 * p + 4, {a}, {b}[p][2], {b}[p][3]);\n")

    def dv(part: str) -> str:
        return pair("dv_acc", part, "bt", 14)

    dkv_words = ("const bool dkv_words = D % 2 == 0 &&", "const bool dkv_words = false &&")
    copies, staged = "constexpr int kQSubCopies = 64;", "constexpr int kQSubStaged = 16;"
    return {
        "base": [],
        "dq_staged": [("const bool dq_words = D % 2 == 0 &&", "const bool dq_words = false &&")],
        "dq_minblocks2": [("constexpr int kDqMinBlocks = 1;", "constexpr int kDqMinBlocks = 2;")],
        "dq_no_s": [(pair("s_acc", "qfr[kk]", "kfr", 12), "")],
        "dq_no_dp": [(pair("dp_acc", "ofr[kk]", "vfr", 12), "")],
        "dq_no_dq": [(pair("dq_acc", "dsa", "ktr", 12), "")],
        "dkv_staged": [dkv_words],
        "dkv_qsub32": [(copies, copies.replace("64", "32"))],
        "dkv_staged_qsub32": [dkv_words, (staged, staged.replace("16", "32"))],
        "dkv_staged_qsub64": [dkv_words, (staged, staged.replace("16", "64"))],
        "dkv_no_s": [(pair("st", "kfr[kk]", "qrow", 14), "")],
        "dkv_no_dp": [(pair("dpt", "vfr[kk]", "orow", 14), "")],
        "dkv_no_dk": [(pair("dk_acc", "dsa", "bt", 14), "")],
        "dkv_no_dv": [(dv("lo"), ""), (dv("mid"), ""), (dv("hi"), "")],
        "dkv_hi_only_dv": [(dv("lo"), ""), (dv("mid"), "")],
    }


def _resources(so: Path) -> dict:
    """{kernel instantiation: its cuobjdump resource line} of the two
    kernels in a variant's library (ILb0E: cp.async loads, ILb1E:
    register-staged)."""
    tool = Path(K.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-resource-usage", str(so)], capture_output=True,
                         text=True, timeout=300).stdout.splitlines()
    found = {}
    for i, line in enumerate(out[:-1]):
        m = re.search(r"(flash_d(?:q|kv)_mma_bf16_kernelILb[01]E)", line)
        if m:
            found[m.group(1)] = out[i + 1].strip()
    return found


def _share(got, want, rtol, atol_share) -> float:
    """max(|got - want| - rtol |want|) / (atol_share max|want|): <= 1 passes."""
    return (((got - want).abs() - rtol * want.abs()).max() / (atol_share * want.abs().max())).item()


def measure(reps: int = 20) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    dsum = torch.sum(do.float() * o.float(), dim=-1)
    dq = torch.empty((BH, T, D), device=dev)
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, ENTRIES)
        resources = {name: _resources(Path(tmp) / f"{name}.so") for name in fns}

        def launch(fn, entry):
            args = (dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr())
            if entry == ENTRIES[0]:
                rc = fn[entry](*args, dq.data_ptr(), BH, T, T, D, 0, 0, 1, scale,
                               K.stream_handle(dev))
            else:
                rc = fn[entry](*args, dk.data_ptr(), dv.data_ptr(), BH, T, T, D, 0, 0, 1, scale,
                               K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        kw = dict(causal=True, scale=scale)
        pdq = fa.flash_dq_plain(q, k, v, do, lse, dsum, **kw)
        pdk, pdv = fa.flash_dkv_plain(q, k, v, do, lse, dsum, **kw)
        shares = {}
        for name in SAME_FUNCTION:
            got = {}
            if not name.startswith("dkv_"):
                launch(fns[name], ENTRIES[0])
                got["dq"] = _share(dq, pdq, 1e-4, 2.0 ** -9)
            if not name.startswith("dq_"):
                launch(fns[name], ENTRIES[1])
                got["dk"] = _share(dk, pdk, 1e-4, 2.0 ** -9)
                got["dv"] = _share(dv, pdv, 1e-4, 1e-5)
            torch.cuda.synchronize()
            shares[name] = got
            if max(got.values()) > 1:
                raise RuntimeError(f"{name} differs from the plain version: {got} of the limit")
        del pdq, pdk, pdv
        runs = {}
        for name, fn in fns.items():
            if not name.startswith("dkv_"):
                runs[f"dq:{name}"] = lambda fn=fn: launch(fn, ENTRIES[0])
            if not name.startswith("dq_"):
                runs[f"dkv:{name}"] = lambda fn=fn: launch(fn, ENTRIES[1])
        fkw = dict(kw, q_off=0, k_off=0)
        runs["old_dq"] = lambda: fa._launch_dq_generic(q, k, v, do, lse, dsum, **fkw)
        runs["old_dkv"] = lambda: fa._launch_dkv_generic(q, k, v, do, lse, dsum, **fkw)
        q4, k4, v4 = (t.view(-1, 12, T, D).detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        do4 = do.view(-1, 12, T, D)
        runs["sdpa_bwd"] = lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                       retain_graph=True)
        readings = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            readings[name].append(_ms(runs[name], reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "dtype": "bfloat16",
            "reps": reps, "share_of_limit": shares, "resources": resources,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "bwd_mma_bf16_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
