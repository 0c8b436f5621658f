"""The whole-buffer int8 quantizer (#5) over one buffer: the one-launch
kernel, its variants and the three-pass launcher it replaced, in turns.

    python -m theanompi_tpu_torch.tools.quant_whole_variants [--reps 20] [--out PATH]

One ``(476292, 128)`` f32 buffer: a codec round's 60,965,376 elements
(AlexNet's 16 leaves, ``quant_variants.round_leaves``, each zero-padded
to whole rows, end to end), 244 MB, past the 50 MB L2. Each of these in
turns (in order, then in reverse):

- ``three_pass``: ``quant._quantize_int8_three_pass``, the launcher the
  one-launch kernel replaced (block maxima, the scale, the values: three
  launches and a partials allocation a call);
- ``whole``: the package's ``quantize_int8`` (one launch of
  ``quant_whole_kernel``, its scratch allocated a call);
- ``base`` and its variants, launched through a variant library's
  ``tmpi_quant`` with the scratch allocated once: ``forward`` (the second
  pass first slot first, not last first), ``unroll2`` / ``unroll8`` (2 or
  8 slots' loads a thread in flight, not 4): text edits of
  ``csrc/quant.cu``, each built by nvcc into its own library (all builds
  started together), with each one's registers, stack and spills
  (``cuobjdump --dump-resource-usage``); and ``base_grid4``, the base
  with its grid capped at 4 CTAs an SM (the occupancy allows more).

Every run's values and scale are first checked bit for bit against
``quantize_int8_plain``. The last stdout line is a JSON summary. Needs a
card and nvcc.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import kernels as K
from theanompi_tpu_torch.ops import quant as tq
from theanompi_tpu_torch.tools.fwd_variants import _ms, build_variants, run
from theanompi_tpu_torch.tools.quant_variants import round_leaves


def _variants(src: str) -> dict:
    unroll, reverse = "constexpr int kWholeUnroll = 4;", "constexpr bool kReverse = true;"
    return {
        "base": [],
        "forward": [(reverse, reverse.replace("true", "false"))],
        "unroll2": [(unroll, unroll.replace("4", "2"))],
        "unroll8": [(unroll, unroll.replace("4", "8"))],
    }


def _resources(so: Path) -> str:
    """The cuobjdump resource line of ``quant_whole_kernel`` in a variant's
    library."""
    tool = Path(K.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-resource-usage", str(so)], capture_output=True,
                         text=True, timeout=300).stdout.splitlines()
    for i, line in enumerate(out[:-1]):
        if "quant_whole_kernel" in line:
            return out[i + 1].strip()
    return "not found"


def round_buffer(dev) -> torch.Tensor:
    """A codec round's leaves, each zero-padded to whole 128-lane rows,
    as one ``(rows, 128)`` f32 buffer."""
    return torch.cat([tq.pad_rows(x) for x in round_leaves(dev)])


def measure(reps: int = 20) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    tq.build()
    x = round_buffer(dev)
    rows = x.shape[0]
    want_v, want_s = tq.quantize_int8_plain(x)
    vals, scale = torch.empty_like(want_v), torch.empty_like(want_s)
    cap = K.max_blocks(dev)
    scratch = torch.empty((1 + cap,), dtype=torch.int32, device=dev)

    def prepared(fn, max_blocks):
        def launch():
            rc = fn(dev.index, x.data_ptr(), vals.data_ptr(), scale.data_ptr(),
                    scratch.data_ptr(), rows, max_blocks, K.stream_handle(dev))
            if rc:
                raise RuntimeError(f"launch failed with code {rc}")
            return vals, scale
        return launch

    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), _variants, "tmpi_quant", library=tq._LIB)
        resources = {name: _resources(Path(tmp) / f"{name}.so") for name in fns}
        runs = {"three_pass": lambda: tq._quantize_int8_three_pass(x),
                "whole": lambda: tq.quantize_int8(x)}
        for name, fn in fns.items():
            runs[name] = prepared(fn, cap)
        runs["base_grid4"] = prepared(fns["base"], cap // 2)
        for name, fn in runs.items():
            vals.fill_(0x5A)
            scale.fill_(-1.0)
            got_v, got_s = fn()
            if not (torch.equal(got_v, want_v) and torch.equal(got_s, want_s)):
                raise RuntimeError(f"{name}: differs from the plain version")
        readings = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            readings[name].append(_ms(runs[name], reps))
    return {"device": torch.cuda.get_device_name(dev), "rows": rows, "elements": x.numel(),
            "bytes": x.numel() * 5 + 4, "reps": reps, "max_blocks": cap, "resources": resources,
            "ms": {n: sum(r) / len(r) for n, r in readings.items()}, "readings_ms": readings}


def main(argv=None) -> int:
    return run(measure, __doc__, "quant_whole_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
