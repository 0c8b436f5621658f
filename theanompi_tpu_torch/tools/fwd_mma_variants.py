"""Where flash_fwd_mma's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.fwd_mma_variants [--reps 20] [--out PATH]

The fp32 forward's counterpart of ``fwd_variants`` (same build and
turns): each variant is ``csrc/flash_attention.cu`` with one text edit,
launched through ``tmpi_flash_fwd_mma`` at the 136M LM's attention shape
in fp32 (BH 96, T 1024, D 64, causal), random fp32 inputs. In the same
turns: ``old``, the generic kernel's fp32 instantiation (fp32 FMAs,
``fa._launch_fwd_generic``), and ``sdpa``, PyTorch's fp32
``scaled_dot_product_attention`` forward (a yardstick only).

- ``base``: the source as it is; checked against the plain version at
  phase flash's fp32 o limit (rtol 1e-5 + 1e-6 max|o|) and lse atol 1e-5;
- ``fast_exp``, ``one_product``, ``no_split``, ``no_softmax``:
  diagnostics that compute another function (``__expf``; each product as
  hi * hi alone, one tf32 product instead of three; the K/V tiles left
  unsplit; no softmax, p = s). They say what the exponentials, the two
  small products, the split pass and the softmax cost; their outputs are
  not checked.

The last stdout line is a JSON summary. Needs a card and nvcc.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from theanompi_tpu_torch.ops import flash_attention as fa
from theanompi_tpu_torch.ops import kernels as K
from theanompi_tpu_torch.tools.fwd_variants import SHAPE, _ms, build_variants, run


def _variants(src: str) -> dict:
    exp = "float p = expf(sc[i] - (top ? mn0 : mn1));"
    small = ("mma_tf32(sc + 4 * n, ql[kk], kh[n][0], kh[n][1]);",
             "mma_tf32(sc + 4 * n, qh[kk], kl[n][0], kl[n][1]);",
             "mma_tf32(pv + 4 * n, pl, vh[n][0], vh[n][1]);",
             "mma_tf32(pv + 4 * n, ph, vl[n][0], vl[n][1]);")
    split_pass = "    split_kv(sm, ks, vs);\n"
    softmax = ("      float corr0, corr1;\n      if (edge) {\n        sm90::tile_softmax<true>")
    return {
        "base": [],
        "no_split": [(split_pass, "")],
        "no_softmax": [(softmax, "      float corr0 = 1.0f, corr1 = 1.0f;\n      if (edge) {\n"
                                 "        if (false) sm90::tile_softmax<true>"),
                       ("        sm90::tile_softmax<false>(sc, m0, m1, l0, l1, corr0, corr1, "
                        "scale, causal, q_off, k_off,\n", "        (void)(m0 + m1 + l0 + l1 + "
                        "corr0 + corr1 + scale + causal + q_off + k_off + \n")],
        "fast_exp": [(exp, exp.replace("expf(", "__expf("))],
        "one_product": [(s, "{}") for s in small],
    }


def measure(reps: int = 20) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(BH, T, D, generator=g, device=dev) for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(BH, T, device=dev)
    scale = 1.0 / math.sqrt(D)
    q4, k4, v4 = (t.view(-1, 12, T, D) for t in (q, k, v))
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_flash_fwd_mma")

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), BH, T, T, D, 0, 0, 1, scale, K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        launch(fns["base"])
        po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
        o_share = (((o - po).abs() - 1e-5 * po.abs()).max() / (1e-6 * po.abs().max())).item()
        lse_err = (lse - plse).abs().max().item()
        if o_share > 1 or lse_err > 1e-5:
            raise RuntimeError(f"base differs from the plain version: o at {o_share:.3g} of "
                               f"the limit, lse off by {lse_err:.3g}")
        runs = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
        runs["old"] = lambda: fa._launch_fwd_generic(q, k, v, causal=True, scale=scale,
                                                     q_off=0, k_off=0)
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        readings = {name: [] for name in runs}
        with torch.no_grad():
            for name in list(runs) + list(runs)[::-1]:
                readings[name].append(_ms(runs[name], reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "dtype": "float32",
            "reps": reps, "base_error": {"o_share_of_limit": o_share, "lse_max_abs": lse_err},
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "fwd_mma_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
