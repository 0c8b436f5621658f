"""Where flash_dq_sm90's time goes: variants of its source, timed in turns.

    python -m theanompi_tpu_torch.tools.dq_variants [--reps 30] [--out PATH]

The dq counterpart of ``fwd_variants`` and ``dkv_variants`` (same build
and turns): each variant is ``csrc/flash_attention.cu`` with one text
edit, launched through ``tmpi_flash_dq_sm90`` at the 136M LM's attention
shape (BH 96, T 1024, D 64, bf16, causal).

- ``base``: the source as it is; checked against the plain version;
- ``stages3``: a K/V ring of 3 stages (the base: 2), loaded 2 tiles
  ahead;
- ``mask_every_tile``: every tile takes the masked path;
- ``dp_waited_first``: dP's wgmma group is waited for before p is
  formed (no ``wgmma_wait_1`` overlap of the exponentials with dP);
- ``no_dq``: a diagnostic that computes another function (no dQ += dS K
  product). It says what the last product costs; its output is not
  checked.

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
    stages = "constexpr int kDqStages = 2;"
    masked = "    const bool dq_masked = k0"
    wait1 = "    wgmma_wait_1();\n    fence_regs(sc);"
    dq_product = ("      wgmma_rs_tb(dq, dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], "
                  "dsa[4 * kk + 3], b);\n")
    return {
        "base": [],
        "stages3": [(stages, stages.replace("2", "3"))],
        "mask_every_tile": [(masked, masked.replace("= k0", "= true || k0"))],
        "dp_waited_first": [(wait1, wait1.replace("wgmma_wait_1()", "wgmma_wait()"))],
        "no_dq": [(dq_product, "")],
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
    dq = torch.empty((BH, T, D), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_flash_dq_sm90")

        def launch(fn):
            rc = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), BH, T, T, D, 0, 0, 1, scale,
                    K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")

        launch(fns["base"])
        pdq = fa.flash_dq_plain(q, k, v, do, lse, dsum, causal=True, scale=scale)
        base_err = {"dq_max_abs": (dq - pdq).abs().max().item(),
                    "dq_max_abs_ref": pdq.abs().max().item()}
        readings = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            readings[name].append(_ms(lambda: launch(fns[name]), reps))
    return {"device": torch.cuda.get_device_name(dev), "shape": SHAPE, "reps": reps,
            "base_error": base_err,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "dq_variants", 30, argv)


if __name__ == "__main__":
    raise SystemExit(main())
