"""Where the int8 block codec's time goes: the multi-leaf kernel's variants
and its per-leaf calls, timed in turns.

    python -m theanompi_tpu_torch.tools.quant_variants [--reps 20] [--out PATH]

Over one codec round of AlexNet's 16 leaves (flat f32 at the leaves'
lengths, 60,965,224 elements, row magnitudes spread over e^+-9), for the
quantizer (#3 ``quant_block``) and the dequantizer (#4 ``dequant_block``),
each of these in turns (in order, then in reverse):

- ``multi``: the package's wrapper (``quantize_int8_block_leaves`` /
  ``dequantize_int8_block_leaves``), host work included: one launch,
  ``CHUNK_ROWS`` rows a chunk;
- ``base_prepared``: the same launch, the leaves checked and the table
  built once (the device's time alone);
- ``threads16`` / ``threads32`` (threads a 128-lane row; the base: 8),
  ``blocks_q2`` / ``blocks_q3`` (CTAs an SM of the quantize's grid; the
  base: 4), ``blocks_d3`` / ``blocks_d4`` (the dequantize's; the base: 2),
  ``plain_store`` (the dequantize's output stored without the base's
  evict-first hint, ``__stcs``), ``stream_load`` (the quantize's input
  loaded with one, ``__ldcs``) and
  ``threads32_blocks8`` (a warp a row at 8 CTAs an SM, the layout of the
  per-buffer kernels this one replaced), likewise prepared: text edits of ``csrc/quant.cu``, each built
  by nvcc into its own library (all builds started together);
- ``base_chunk32`` / ``128`` / ``256``: the base kernel cut into chunks
  of other row counts;
- ``per_leaf``: the codec's call pattern before the multi-leaf wrapper,
  one call of the one-buffer wrapper (``quantize_int8_block`` /
  ``dequantize_int8_block``) per leaf's zero-padded ``(rows, 128)``
  buffer: 16 one-leaf launches of this kernel, each call's checks and
  output allocations included (the host's share of a round's time).

Every variant's round is first checked bit for bit against the plain
version. The last stdout line is a JSON summary. Needs a card and nvcc.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path

import torch

from theanompi_tpu_torch.ops import quant as tq
from theanompi_tpu_torch.tools.fwd_variants import _ms, build_variants, run
from theanompi_tpu_torch.tools.update_variants import leaf_specs

CHUNKS = (32, 128, 256)

def per_leaf_quantize(x2ds) -> list:
    """The codec's call pattern before the multi-leaf wrapper: one call of
    the one-buffer wrapper per leaf's ``(rows, 128)`` buffer, each with
    its checks, its outputs allocated and one launch -> ``[(vals,
    scales)]``."""
    return [tq.quantize_int8_block(x2d) for x2d in x2ds]


def per_leaf_dequantize(pairs) -> list:
    """Likewise one ``dequantize_int8_block`` call per ``(vals, scales)``
    pair -> ``[(rows, 128) f32]``."""
    return [tq.dequantize_int8_block(vals, scales) for vals, scales in pairs]


def round_leaves(dev, seed: int = 7) -> list:
    """AlexNet's 16 leaves as flat f32 on ``dev`` (``tree_leaves`` order),
    magnitude 1e-2 with each 128-element row scaled by e^(3 N(0, 1))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = []
    for shape, _ in leaf_specs("alexnet"):
        n = math.prod(shape)
        rows = -(-n // tq.LANES)
        spread = torch.exp(3 * torch.randn(rows, 1, generator=gen, device=dev))
        x = torch.randn(rows, tq.LANES, generator=gen, device=dev) * 1e-2 * spread
        xs.append(x.view(-1)[:n].clone())
    return xs


def out_views(row0s, lengths, dev) -> tuple:
    """``(buffer, outs)``: the codec's dequantize outputs, leaf ``i`` at row
    ``row0s[i]`` of one f32 buffer (every view 512-byte aligned)."""
    rows = row0s[-1] + -(-lengths[-1] // tq.LANES)
    buf = torch.empty(rows * tq.LANES, dtype=torch.float32, device=dev)
    return buf, [buf[r0 * tq.LANES:r0 * tq.LANES + n] for r0, n in zip(row0s, lengths)]


def prepare(entry, op: str, xs, vals, scales, outs, row0s, chunk_rows: int = tq.CHUNK_ROWS):
    """The package's launch through ``entry`` (a variant library's
    ``tmpi_block_codec_multi``; None: the package's own) with ``chunk_rows``-row chunks, the
    leaves checked and the table built once -> a function that launches
    it (its time is the device's: no host work but the ctypes call)."""
    if op == "quantize":
        dev, _, _, _, tables = tq._quantize_plan(xs, vals, scales, chunk_rows=chunk_rows)
        code, counter = tq._OP_QUANTIZE, tq.QUANT_BLOCK
    else:
        dev, tables = tq._dequantize_plan(vals, scales, outs, row0s, chunk_rows=chunk_rows)
        code, counter = tq._OP_DEQUANTIZE, tq.DEQUANT_BLOCK
    return lambda: tq._run(code, dev, tables, counter, f"variant of the block {op} kernel",
                           chunk_rows, entry)


def _variants(src: str) -> dict:
    threads = "constexpr int kRowThreads = 8;"
    qblocks = "constexpr int kQuantBlocksPerSm = 4;"
    dblocks = "constexpr int kDequantBlocksPerSm = 2;"
    store = "__stcs(reinterpret_cast<float4*>(out + slot_at(g, k)), dequant4(c[k], s));"
    load = "v[k] = *reinterpret_cast<const float4*>(x + slot_at(g, k));"
    return {
        "base": [],
        "threads16": [(threads, threads.replace("8", "16"))],
        "threads32": [(threads, threads.replace("8", "32"))],
        "blocks_q2": [(qblocks, qblocks.replace("4", "2"))],
        "blocks_q3": [(qblocks, qblocks.replace("4", "3"))],
        "blocks_d3": [(dblocks, dblocks.replace("2", "3"))],
        "blocks_d4": [(dblocks, dblocks.replace("2", "4"))],
        "plain_store": [(store, "*reinterpret_cast<float4*>(out + slot_at(g, k)) = "
                                "dequant4(c[k], s);")],
        "stream_load": [(load, "v[k] = __ldcs(reinterpret_cast<const float4*>(x + "
                               "slot_at(g, k)));")],
        "threads32_blocks8": [(threads, threads.replace("8", "32")),
                              (qblocks, qblocks.replace("4", "8")),
                              (dblocks, dblocks.replace("2", "8"))],
    }


def measure(reps: int = 20, make_variants=_variants) -> dict:
    """Every variant of the quantizer and the dequantizer, in turns (see
    the module docstring); ``*_prepared`` and the text-edited variants
    time the device (the table built once), ``multi`` and ``per_leaf``
    the wrappers, host work included."""
    dev = torch.device("cuda", torch.cuda.current_device())
    tq.build()
    xs = round_leaves(dev)
    lengths = [x.numel() for x in xs]
    x2ds = [tq.pad_rows(x) for x in xs]
    want_v, want_s, row0s = tq.quantize_int8_block_leaves_plain(xs)
    buf, outs = out_views(row0s, lengths, dev)
    want_out = torch.cat(tq.dequantize_int8_block_leaves_plain(
        want_v, want_s, [torch.empty(n, device=dev) for n in lengths], row0s))
    vals, scales = torch.empty_like(want_v), torch.empty_like(want_s)
    pairs = [(want_v[r0:r0 + x.shape[0]], want_s[r0:r0 + x.shape[0]])
             for r0, x in zip(row0s, x2ds)]
    out = {"device": torch.cuda.get_device_name(dev), "reps": reps, "chunk_rows": tq.CHUNK_ROWS,
           "leaves": len(xs), "elements": sum(lengths), "rows": int(want_v.shape[0]),
           "table_capacity": tq._LIB.get().tmpi_block_codec_capacity(), "ops": {}}

    def result(op, name, fn):
        """Run ``fn`` once on outputs filled with junk -> what it wrote,
        as the plain version's tensors lay it out."""
        vals.fill_(0x5A)
        scales.fill_(-1.0)
        buf.fill_(-1.0)
        got = fn()
        if op == "quantize":
            if name == "per_leaf":
                return torch.cat([v for v, _ in got]), torch.cat([s for _, s in got])
            return got[:2] if name == "multi" else (vals, scales)
        if name == "per_leaf":
            return (torch.cat([o.view(-1)[:n] for o, n in zip(got, lengths)]),)
        return (torch.cat(outs),)

    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), make_variants, "tmpi_block_codec_multi", library=tq._LIB)
        for op in ("quantize", "dequantize"):
            if op == "quantize":
                src, want = (vals, scales), (want_v, want_s)
                runs = {"multi": lambda: tq.quantize_int8_block_leaves(xs)}
            else:
                src, want = (want_v, want_s), (want_out,)
                runs = {"multi": lambda: tq.dequantize_int8_block_leaves(want_v, want_s, outs,
                                                                         row0s)}
            for name, fn in fns.items():
                runs[f"{name}_prepared"] = prepare(fn, op, xs, *src, outs, row0s)
            for c in CHUNKS:
                runs[f"base_chunk{c}_prepared"] = prepare(fns["base"], op, xs, *src, outs, row0s,
                                                          chunk_rows=c)
            runs["per_leaf"] = ((lambda: per_leaf_quantize(x2ds)) if op == "quantize"
                                else (lambda: per_leaf_dequantize(pairs)))
            for name, fn in runs.items():
                if not all(torch.equal(a, b) for a, b in zip(result(op, name, fn), want)):
                    raise RuntimeError(f"{op} {name}: differs from the plain version")
            readings = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                readings[name].append(_ms(runs[name], reps))
            out["ops"][op] = {"ms": {n: sum(r) / len(r) for n, r in readings.items()},
                              "readings_ms": readings}
    # run()'s printout: one line per (op, variant)
    out["ms"] = {f"{op}/{n}": t for op, d in out["ops"].items() for n, t in d["ms"].items()}
    out["readings_ms"] = {f"{op}/{n}": t for op, d in out["ops"].items()
                          for n, t in d["readings_ms"].items()}
    return out


def main(argv=None) -> int:
    return run(measure, __doc__, "quant_variants", 20, argv)


if __name__ == "__main__":
    raise SystemExit(main())
