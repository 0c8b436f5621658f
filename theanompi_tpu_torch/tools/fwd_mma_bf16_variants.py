"""Where flash_fwd_mma_bf16's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.fwd_mma_bf16_variants [--reps 30] [--out PATH]

The counterpart of ``fwd_variants`` (same build and turns) for the bf16
forward of heads with D % 8 != 0: each variant is
``csrc/flash_attention.cu`` with one text edit, launched through
``tmpi_flash_fwd_mma_bf16`` at BH 96, T 1024, D 60 (bf16, causal), random
bf16 inputs. In the same turns: ``old``, the generic forward
(``fa._launch_fwd_generic``, which these heads took before), and
``sdpa``, PyTorch's ``scaled_dot_product_attention`` forward at D 60 (a
yardstick only).

- ``base``: the source as it is (4-byte cp.async loads, two CTAs an SM);
  checked against the plain version at phase flash's bf16 o limit (1
  ulp + 2^-9 sum p|v|/l) and lse atol 1e-5;
- ``minblocks1``: ``__launch_bounds__(256, 1)`` for the cp.async
  instantiation too (no register cap of 128, one CTA an SM);
- ``staged``: the register-staged loads of odd heads at D 60 as well;
- ``no_pv``: a diagnostic that computes another function (no P V
  product); it says what the second product costs; not checked.

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
from theanompi_tpu_torch.tools.fwd_variants import _ms, build_variants, run

SHAPE = dict(BH=96, T=1024, D=60)


def _variants(src: str) -> dict:
    bounds = "__launch_bounds__(kMmaThreads, kStaged ? 1 : 2)"
    staged = "const bool staged = D % 2 != 0 ||"
    pv = ("            mma_bf16(acc + 8 * p, pa, vf[p][0], vf[p][1]);\n"
          "            mma_bf16(acc + 8 * p + 4, pa, vf[p][2], vf[p][3]);\n")
    return {
        "base": [],
        "minblocks1": [(bounds, "__launch_bounds__(kMmaThreads, 1)")],
        "staged": [(staged, "const bool staged = true ||")],
        "no_pv": [(pv, "")],
    }


def _o_share(o, po, weight) -> float:
    """o's error as a share of phase flash's bf16 limit (<= 1 passes): 1
    bf16 ulp of the plain value plus 2^-9 of sum_i p_i |v_i| / l."""
    w = po.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(w, 1e-30))) - 7)
    excess = (o.float() - po.float()).abs() - ulp
    return (excess / torch.clamp_min(2.0 ** -9 * weight, 1e-30)).max().item()


def measure(reps: int = 30) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(BH, T, D, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(BH, T, device=dev)
    scale = 1.0 / math.sqrt(D)
    q4, k4, v4 = (t.view(-1, 12, T, D) for t in (q, k, v))
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_flash_fwd_mma_bf16")

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), BH, T, T, D, 0, 0, 1, scale, K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
        weight, _ = fa.flash_fwd_plain(q.float(), k.float(), v.float().abs(), causal=True,
                                       scale=scale)
        errors = {}
        for name in ("base", "minblocks1", "staged"):
            launch(fns[name])
            errors[name] = {"o_share_of_limit": _o_share(o, po, weight),
                            "lse_max_abs": (lse - plse).abs().max().item()}
            if errors[name]["o_share_of_limit"] > 1 or errors[name]["lse_max_abs"] > 1e-5:
                raise RuntimeError(f"{name} differs from the plain version: {errors[name]}")
        del weight
        runs = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
        runs["old"] = lambda: fa._launch_fwd_generic(q, k, v, causal=True, scale=scale,
                                                     q_off=0, k_off=0)
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        readings = {name: [] for name in runs}
        with torch.no_grad():
            for name in list(runs) + list(runs)[::-1]:
                readings[name].append(_ms(runs[name], reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "dtype": "bfloat16",
            "reps": reps, "errors": errors,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "fwd_mma_bf16_variants", 30, argv)


if __name__ == "__main__":
    raise SystemExit(main())
