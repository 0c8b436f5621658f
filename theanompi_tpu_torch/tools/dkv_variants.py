"""Where flash_dkv_sm90's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.dkv_variants [--reps 30] [--out PATH]

The dk/dv counterpart of ``fwd_variants`` (same build and turns): each
variant is ``csrc/flash_attention.cu`` with one text edit, launched
through ``tmpi_flash_dkv_sm90`` at the 136M LM's attention shape (BH 96,
T 1024, D 64, bf16, causal).

- ``base``: the source as it is; checked against the plain version;
- ``stages3_ahead1``, ``stages4_ahead1``, ``stages4_ahead2``: a Q/dO
  ring of 3 or 4 stages, loaded 1 or 2 tiles ahead (the base: 2 stages,
  1 ahead). Thread 0 refills a stage only after both warpgroups released
  it, so stages beyond the lookahead let one warpgroup run ahead of the
  other;
- ``mask_every_tile``: every tile takes the masked path;
- ``fast_exp``, ``two_part_dv``, ``hi_only_dv``, ``no_dv``: diagnostics
  that compute another function (``__expf``; dv from p's hi and mid
  parts, or its hi part alone; no dv product, so no split either). They
  say what the exponentials, each part's product and the whole dv
  product cost; their outputs are not checked.

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
    def part(name: str) -> str:
        return (f"      wgmma_rs_tb(dv, {name}[4 * kk], {name}[4 * kk + 1], {name}[4 * kk + 2], "
                f"{name}[4 * kk + 3], b);\n")

    stages, ahead = "constexpr int kQStages = 2;", "constexpr int kQAhead = 1;"
    masked = "    const bool masked = q0 + kQTile > Tq"
    exp = "float p = expf(st[r] * scale - lse_c[c]);"
    return {
        "base": [],
        "stages3_ahead1": [(stages, stages.replace("2", "3"))],
        "stages4_ahead1": [(stages, stages.replace("2", "4"))],
        "stages4_ahead2": [(stages, stages.replace("2", "4")), (ahead, ahead.replace("1", "2"))],
        "mask_every_tile": [(masked, masked.replace("= q0", "= true || q0"))],
        "fast_exp": [(exp, exp.replace("expf(", "__expf("))],
        "two_part_dv": [(part("lo"), "")],
        "hi_only_dv": [(part("mid") + part("lo"), "")],
        "no_dv": [(part("hi") + part("mid") + part("lo"), "")],
    }


def measure(reps: int = 30) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    BH, T, D = SHAPE["BH"], SHAPE["T"], SHAPE["D"]
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    dsum = torch.sum(do.float() * o.float(), dim=-1)
    dk = torch.empty((BH, T, D), device=dev)
    dv = torch.empty_like(dk)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_flash_dkv_sm90")

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, T, T, D,
                    0, 0, 1, scale, K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        launch(fns["base"])
        pdk, pdv = fa.flash_dkv_plain(q, k, v, do, lse, dsum, causal=True, scale=scale)
        base_err = {"dk_max_abs": (dk - pdk).abs().max().item(),
                    "dv_max_abs": (dv - pdv).abs().max().item()}
        readings = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            readings[name].append(_ms(lambda: launch(fns[name]), reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "reps": reps,
            "base_error": base_err,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "dkv_variants", 30, argv)


if __name__ == "__main__":
    raise SystemExit(main())
