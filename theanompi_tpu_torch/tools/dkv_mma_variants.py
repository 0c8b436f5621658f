"""Where flash_dkv_mma's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.dkv_mma_variants [--reps 20] [--out PATH]

The counterpart of ``dkv_variants`` (same build and turns) for the fp32
dk/dv: each variant is ``csrc/flash_attention.cu`` with one text edit,
launched through ``tmpi_flash_dkv_mma`` at the 136M LM's attention shape
in fp32 (BH 96, T 1024, D 64, causal), random fp32 inputs. In the same
turns: ``old``, the generic kernel's fp32 instantiation (fp32 FMAs,
``fa._launch_dkv_generic``).

- ``base``: the source as it is; checked against the plain version at
  phase flash's fp32 dk/dv limit (rtol 1e-4 + 1e-5 of the largest value);
- ``one_product``, ``no_split``, ``no_dkdv``: diagnostics that compute
  another function (each product as hi * hi alone, one tf32 product
  instead of three; the Q/dO tiles left unsplit; no dV and dK products,
  p and ds added to the accumulators instead).
  They say what the two small products, the split pass and the second
  pair of products cost; their outputs are not checked.

The last stdout line is a JSON summary. Needs a card and nvcc.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import flash_attention as fa
from theanompi_tpu_torch.ops import kernels as K
from theanompi_tpu_torch.tools.fwd_variants import SHAPE, _ms, build_variants, run


def _variants(src: str) -> dict:
    small = ("mma_tf32(st + 4 * n, kal, qbh[n][0], qbh[n][1]);",
             "mma_tf32(dpt + 4 * n, val, obh[n][0], obh[n][1]);",
             "mma_tf32(st + 4 * n, kah, qbl[n][0], qbl[n][1]);",
             "mma_tf32(dpt + 4 * n, vah, obl[n][0], obl[n][1]);",
             "if (n < steps) mma_tf32(dv + 4 * n, pal, bfh[n][0], bfh[n][1]);",
             "if (n < steps) mma_tf32(dv + 4 * n, pah, bfl[n][0], bfl[n][1]);",
             "if (n < steps) mma_tf32(dk + 4 * n, dal, bfh[n][0], bfh[n][1]);",
             "if (n < steps) mma_tf32(dk + 4 * n, dah, bfl[n][0], bfl[n][1]);")
    dkdv = src[src.index("      for (int qs8 = 0; qs8 < kHalfQ / 8; ++qs8) {"):
               src.index("    __syncthreads();  // every thread is done with Q^T, dO^T")]
    return {
        "base": [],
        "one_product": [(s, "{}") for s in small],
        "no_split": [("    split_qdo_t(sm, sm.q[j % kRing], sm.d_o[j % kRing]);\n", "")],
        # st and dpt still feed the accumulators, so S^T, dP^T and p stay
        "no_dkdv": [(dkdv, "      for (int i = 0; i < 16; ++i) {\n        dv[i] += st[i];\n"
                           "        dk[i] += dpt[i];\n      }\n    }\n")],
    }


def measure(reps: int = 20) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=dev) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    dsum = torch.sum(do * o, dim=-1)
    dk = torch.empty((BH, T, D), device=dev)
    dv = torch.empty_like(dk)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_flash_dkv_mma")

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, T, T, D,
                    0, 0, 1, scale, K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        launch(fns["base"])
        pdk, pdv = fa.flash_dkv_plain(q, k, v, do, lse, dsum, causal=True, scale=scale)
        shares = {name: (((a - b).abs() - 1e-4 * b.abs()).max() / (1e-5 * b.abs().max())).item()
                  for name, a, b in (("dk", dk, pdk), ("dv", dv, pdv))}
        if max(shares.values()) > 1:
            raise RuntimeError(f"base differs from the plain version: {shares} of the limit")
        runs = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
        runs["old"] = lambda: fa._launch_dkv_generic(q, k, v, do, lse, dsum, causal=True,
                                                     scale=scale, q_off=0, k_off=0)
        readings = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            readings[name].append(_ms(runs[name], reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "dtype": "float32",
            "reps": reps, "base_share_of_limit": shares,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "dkv_mma_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
