"""Where flash_dq_mma's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.dq_mma_variants [--reps 20] [--out PATH]

The counterpart of ``dkv_mma_variants`` (same build and turns) for the
fp32 dq: each variant is ``csrc/flash_attention.cu`` with one text edit,
launched through ``tmpi_flash_dq_mma`` at the 136M LM's attention shape in
fp32 (BH 96, T 1024, D 64, causal), random fp32 inputs, lse and dsum from
the plain forward. In the same turns: ``old``, the generic kernel's fp32
instantiation (fp32 FMAs, ``fa._launch_dq_generic``, on no route).

- ``base``: the source as it is; checked against the plain version at
  phase flash's fp32 dq limit (rtol 1e-4 + 1e-5 of the largest value);
- ``no_s``, ``no_dp``, ``no_dq``: diagnostics that compute another
  function, each with one product (its three tf32 terms) dropped;
  ``one_product``: every product as hi * hi alone (one tf32 product
  instead of three); ``no_split``: the K/V tiles left unsplit. They say
  what each product, the two small terms and the split pass cost; their
  outputs are not checked.

Each variant's registers, stack and spills (``cuobjdump
--dump-resource-usage`` of its library, from the toolkit of nvcc) are in
the summary. The last stdout line is a JSON summary. Needs a card and
nvcc.
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
from theanompi_tpu_torch.tools.fwd_variants import SHAPE, _ms, build_variants, run

_MMA = "            mma_tf32({}, {}, kv_hi[n][0], kv_hi[n][1]);"


def _variants(src: str) -> dict:
    def prod(acc: str, a_lo: str, a_hi: str) -> list:
        """One product's three terms (small ones first) in the source."""
        return [_MMA.format(acc, a_lo), _MMA.format(acc, a_hi).replace("kv_hi", "kv_lo"),
                _MMA.format(acc, a_hi)]

    s_terms = prod("s_acc + 4 * n", "q_lo[kk]", "q_hi[kk]")
    dp_terms = prod("dp_acc + 4 * n", "o_lo", "o_hi")
    dq_terms = ["if (n < steps) mma_tf32(dq_acc + 4 * n, ds_lo, th[n][0], th[n][1]);",
                "if (n < steps) mma_tf32(dq_acc + 4 * n, ds_hi, tl[n][0], tl[n][1]);",
                "if (n < steps) mma_tf32(dq_acc + 4 * n, ds_hi, th[n][0], th[n][1]);"]

    def drop(terms) -> list:
        return [(t, t[:t.index("mma_tf32")] + "{}") for t in terms]

    return {
        "base": [],
        "no_s": drop(s_terms),
        "no_dp": drop(dp_terms),
        "no_dq": drop(dq_terms),
        "one_product": drop(s_terms[:2] + dp_terms[:2] + dq_terms[:2]),
        "no_split": [("    split_kv_dq(sm, ks, vs);\n", "")],
    }


def _resources(so: Path) -> str:
    """The cuobjdump resource line of ``flash_dq_mma_kernel`` in a
    variant's library."""
    tool = Path(K.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-resource-usage", str(so)], capture_output=True,
                         text=True, timeout=300).stdout.splitlines()
    for i, line in enumerate(out[:-1]):
        if re.search(r"flash_dq_mma_kernel", line):
            return out[i + 1].strip()
    return "not found"


def measure(reps: int = 20) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=dev) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    dsum = torch.sum(do * o, dim=-1)
    dq = torch.empty((BH, T, D), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_flash_dq_mma")
        resources = {name: _resources(Path(tmp) / f"{name}.so") for name in fns}

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), BH, T, T, D, 0, 0, 1, scale,
                    K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        launch(fns["base"])
        pdq = fa.flash_dq_plain(q, k, v, do, lse, dsum, causal=True, scale=scale)
        share = (((dq - pdq).abs() - 1e-4 * pdq.abs()).max() / (1e-5 * pdq.abs().max())).item()
        if share > 1:
            raise RuntimeError(f"base differs from the plain version: {share} of the limit")
        del pdq
        runs = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
        runs["old"] = lambda: fa._launch_dq_generic(q, k, v, do, lse, dsum, causal=True,
                                                    scale=scale, q_off=0, k_off=0)
        readings = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            readings[name].append(_ms(runs[name], reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "dtype": "float32",
            "reps": reps, "base_share_of_limit": share, "resources": resources,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "dq_mma_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
