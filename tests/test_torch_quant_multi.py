"""The multi-leaf int8 block codec of the PyTorch port (theanompi_tpu_torch/
ops/quant.py: ``quantize_int8_block_leaves`` / ``dequantize_int8_block_
leaves``, one kernel launch over a list of leaves) on the CPU: its plain
version against the JAX package's per-leaf ``quantize_int8_block`` /
``dequantize_int8_block`` (its jnp route, ``TMPI_PALLAS=0``, and its
Pallas route in interpret mode), its work table replayed as the kernel
reads it, and ``WireCodec.compress`` over three rounds against
theanompi_tpu/parallel/codec.py.

On the CPU the wrappers run their plain versions; the CUDA kernel is held
against them on the card by chip_smoke.py (phase quant).

Tolerance: none. Every int8 value, f32 scale (NaN positions included),
decoded value, wire tree and residual is bit-identical.
"""

import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.ops import pallas_quant as jq
from theanompi_tpu.parallel import codec as jc
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.ops import fused_update as tfu
from theanompi_tpu_torch.ops import kernels as K
from theanompi_tpu_torch.ops import quant as tq
from theanompi_tpu_torch.parallel import codec as tc

RAGGED = [1, 127, 128, 129, 34_848]  # the last: AlexNet's conv1 kernel, 272.25 rows


def _leaves(lengths, seed=0):
    """Flat f32 leaves with row magnitudes spread over e^+-9; a leaf of
    1000 gets a NaN row, one of 300 an inf, one of 129 a NaN in its
    1-element last row."""
    r = np.random.RandomState(seed)
    out = []
    for n in lengths:
        rows = -(-n // 128)
        x = r.randn(rows, 128) * 1e-2 * np.exp(3 * r.randn(rows, 1))
        out.append(x.astype(np.float32).reshape(-1)[:n].copy())
    return out


def _specials():
    lengths = RAGGED + [1000, 300, 129, 0]
    xs = _leaves(lengths, seed=1)
    xs[5][256:384] = np.nan
    xs[6][5] = np.inf
    xs[7][128] = np.nan
    return xs


def _route(monkeypatch, route):
    monkeypatch.setenv("TMPI_PALLAS", "0" if route == "jnp" else "1")


def _reference(xs):
    """The JAX package, leaf by leaf, compiled as its codec runs it (inside
    jit, where XLA turns ``amax / 127.0`` into a reciprocal multiply on
    either route): its zero pad, quantize and dequantize."""
    quantize = jax.jit(lambda x: jq.quantize_int8_block(jq._pad_rows(x)))
    dequantize = jax.jit(jq.dequantize_int8_block)
    out = []
    for x in xs:
        if not x.size:
            out.append((np.zeros((0, 128), np.int8), np.zeros((0, 1), np.float32),
                        np.zeros(0, np.float32)))
            continue
        v, s = quantize(jnp.asarray(x))
        back = np.asarray(dequantize(v, s)).reshape(-1)[:x.size]
        out.append((np.asarray(v), np.asarray(s), back))
    return out


# --------------------------------------------------------------------------
# the plain multi-leaf path against the reference, leaf by leaf
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["jnp", "pallas"])
@pytest.mark.parametrize("data", ["ragged", "specials"])
def test_leaves_match_reference_leaf_by_leaf(monkeypatch, route, data):
    _route(monkeypatch, route)
    xs = _leaves(RAGGED) if data == "ragged" else _specials()
    ts = [torch.from_numpy(x.copy()) for x in xs]
    want = _reference(xs)
    for fn in (tq.quantize_int8_block_leaves_plain, tq.quantize_int8_block_leaves):
        vals, scales, row0s = fn(ts)
        assert row0s == tq.leaf_rows([x.size for x in xs])[0]
        assert vals.shape == (sum(-(-x.size // 128) for x in xs), 128) and vals.dtype == torch.int8
        for (v, s, _), r0 in zip(want, row0s):
            np.testing.assert_array_equal(vals[r0:r0 + len(v)].numpy(), v)
            np.testing.assert_array_equal(scales[r0:r0 + len(v)].numpy(), s)  # NaN as NaN
    for fn in (tq.dequantize_int8_block_leaves_plain, tq.dequantize_int8_block_leaves):
        outs = [torch.full((x.size,), 7.0) for x in xs]
        got = fn(vals, scales, outs, row0s)
        assert got is outs or all(a is b for a, b in zip(got, outs))  # in place
        for o, (_, _, back) in zip(outs, want):
            np.testing.assert_array_equal(o.numpy(), back)


def test_decode_and_add_is_one_fma_per_element_leaf_by_leaf():
    """``accumulate`` adds each leaf's decode to its accumulator with one
    rounding, as the one-leaf ``wire_decode_add`` does; outputs need not
    be padded (only ``n`` elements are touched)."""
    xs = [torch.from_numpy(x) for x in _specials()]
    vals, scales, row0s = tq.quantize_int8_block_leaves(xs)
    r = np.random.RandomState(3)
    accs = [torch.from_numpy(r.randn(x.numel()).astype(np.float32)) for x in xs]
    got = tq.dequantize_int8_block_leaves(vals, scales, [a.clone() for a in accs], row0s,
                                          accumulate=True)
    for g, a, x, r0 in zip(got, accs, xs, row0s):
        rows = -(-x.numel() // 128)
        want = tq.dequantize_add_int8_block_plain(vals[r0:r0 + rows], scales[r0:r0 + rows],
                                                  tq.pad_rows(a)).reshape(-1)[:x.numel()]
        assert torch.equal(torch.nan_to_num(g, nan=123.0), torch.nan_to_num(want, nan=123.0))
    # the ring's padded accumulator through the packed wire, one leaf
    flat = xs[4]
    acc = torch.from_numpy(r.randn(-(-flat.numel() // 128) * 128).astype(np.float32))
    msg = tq.wire_encode(flat)
    one = tq.wire_decode_add(msg, acc.clone())
    v, s, _ = tq.quantize_int8_block_leaves([flat])
    many = tq.dequantize_int8_block_leaves(v, s, [acc.clone()], (0,), accumulate=True)[0]
    assert torch.equal(one, many)


def test_cpu_path_counts_no_launches():
    counters = (tq.QUANT_BLOCK, tq.DEQUANT_BLOCK)
    before = [c.launches for c in counters]
    xs = [torch.from_numpy(x) for x in _specials()]
    vals, scales, row0s = tq.quantize_int8_block_leaves(xs)
    tq.dequantize_int8_block_leaves(vals, scales, [torch.empty(x.numel()) for x in xs], row0s)
    tq.wire_decode_add(tq.wire_encode(xs[1]), torch.zeros(128))
    codec = tc.get_codec("int8:ef")
    tree = bridge.tree_from_jax(_tree(0))
    codec.compress(tree, codec.init_ef(tree), bridge.default_layouts(_tree(0)))
    assert [c.launches for c in counters] == before


def test_refusals_name_the_leaf():
    x = torch.zeros(300)
    with pytest.raises(ValueError, match="no x leaves"):
        tq.quantize_int8_block_leaves([])
    with pytest.raises(TypeError, match=r"x\[1\] has dtype torch.float64"):
        tq.quantize_int8_block_leaves([x, x.double()])
    with pytest.raises(ValueError, match=r"x\[1\] must be contiguous"):
        tq.quantize_int8_block_leaves([x, torch.zeros(4, 8).t()])
    with pytest.raises(TypeError, match=r"x\[1\] must be a tensor"):
        tq.quantize_int8_block_leaves([x, np.zeros(3, np.float32)])
    with pytest.raises(ValueError, match=r"x\[1\] is on meta"):
        tq.quantize_int8_block_leaves([x, torch.empty(3, device="meta")])
    vals, scales, row0s = tq.quantize_int8_block_leaves([x, x[:129]])
    with pytest.raises(ValueError, match="2 outputs, 1 first rows"):
        tq.dequantize_int8_block_leaves(vals, scales, [x, x[:129]], row0s[:1])
    with pytest.raises(ValueError, match=r"out\[1\]'s 2 rows from row 4 pass the 5 rows"):
        tq.dequantize_int8_block_leaves(vals, scales, [torch.empty(300), torch.empty(129)],
                                        (0, 4))
    with pytest.raises(ValueError, match="share one buffer"):
        tq.dequantize_int8_block_leaves(vals, scales, [x, x[:129]], row0s)
    with pytest.raises(ValueError, match=r"scales has shape \(4, 1\)"):
        tq.dequantize_int8_block_leaves(vals, scales[:4], [torch.empty(300)], (0,))
    # the one-buffer functions keep their words
    with pytest.raises(ValueError, match=r"\(rows >= 1, 128\)"):
        tq.quantize_int8_block(torch.zeros(4, 64))


# --------------------------------------------------------------------------
# the work table, replayed as the kernel reads it
# --------------------------------------------------------------------------

LENGTHS = [0, 1, 127, 128, 129, 8191, 8192, 8193, 34_848, 2_000_003]


def _replay(tables, lengths, row0s, vals_ptr, scales_ptr, ptrs, chunk_rows):
    """Every row each launch's chunks reach -> {leaf: [global rows]}; on
    the way, the row layout of each table against the leaves."""
    seen = {}
    for rows, n_leaves, chunks in tables:
        raw = np.frombuffer(rows.tobytes(), dtype=np.int64).reshape(-1, 5)
        assert rows.itemsize * len(rows) == tq.TABLE_LEAF_BYTES * n_leaves == raw.nbytes
        assert tq.TABLE_HEADER_BYTES + raw.nbytes <= K.PARAM_LIMIT
        x, v, s, n = raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3]
        c0 = raw[:, 4] & 0xFFFFFFFF
        r0 = raw[:, 4] >> 32
        leaf_ids = [ptrs.index(int(p)) for p in x]  # distinct pointers in these tests
        assert (n == [lengths[i] for i in leaf_ids]).all() and (n > 0).all()
        assert (r0 == [row0s[i] for i in leaf_ids]).all()
        assert (v == vals_ptr + r0 * 128).all() and (s == scales_ptr + r0 * 4).all()
        assert c0[0] == 0 and (np.diff(c0) == -(-n[:-1] // (128 * chunk_rows))).all()
        assert chunks == c0[-1] - (-n[-1] // (128 * chunk_rows))
        for c in range(chunks):  # the kernel: the last leaf whose first chunk is <= c
            lo, hi = 0, n_leaves - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if c0[mid] <= c else (lo, mid - 1)
            first = (c - c0[lo]) * chunk_rows
            count = min(chunk_rows, -(-n[lo] // 128) - first)
            assert count > 0
            seen.setdefault(leaf_ids[lo], []).extend(range(r0[lo] + first, r0[lo] + first + count))
    return seen


@settings(max_examples=120, deadline=None)
@given(st.lists(st.sampled_from(LENGTHS), min_size=1, max_size=30),
       st.sampled_from([1, 2, 7, tq.table_capacity(4096), tq.table_capacity()]),
       st.sampled_from([1, 32, tq.CHUNK_ROWS, 256]))
def test_table_covers_every_row_of_every_leaf_once(lengths, capacity, chunk_rows):
    row0s, total = tq.leaf_rows(lengths)
    assert list(row0s) == list(np.cumsum([0] + [-(-n // 128) for n in lengths])[:-1])
    ptrs = [0x7F0000000000 + i * (1 << 32) for i in range(len(lengths))]
    vals, scales = torch.empty(8, dtype=torch.int8), torch.empty(2)
    tables = tq._tables(ptrs, lengths, row0s, vals, scales, capacity, chunk_rows)
    nonempty = [i for i, n in enumerate(lengths) if n]
    assert len(tables) == -(-len(nonempty) // capacity)
    assert all(1 <= leaves <= capacity for _, leaves, _ in tables)
    seen = _replay(tables, lengths, row0s, vals.data_ptr(), scales.data_ptr(), ptrs, chunk_rows)
    assert sorted(seen) == nonempty
    for i in nonempty:  # each leaf's own rows, each once; together every row once
        assert sorted(seen[i]) == list(range(row0s[i], row0s[i] - (-lengths[i] // 128)))
    assert sorted(r for rows in seen.values() for r in rows) == list(range(total))
    # a split at capacity gives the same rows as one table
    whole = _replay(tq._tables(ptrs, lengths, row0s, vals, scales, len(lengths), chunk_rows),
                    lengths, row0s, vals.data_ptr(), scales.data_ptr(), ptrs, chunk_rows)
    assert {i: sorted(r) for i, r in whole.items()} == {i: sorted(r) for i, r in seen.items()}


def test_table_capacity_fits_the_parameter_limit():
    for limit in (4096, K.PARAM_LIMIT):
        cap = tq.table_capacity(limit)
        assert tq.TABLE_HEADER_BYTES + cap * tq.TABLE_LEAF_BYTES <= limit
        assert tq.TABLE_HEADER_BYTES + (cap + 1) * tq.TABLE_LEAF_BYTES > limit
    assert tq.table_capacity() == 818  # csrc/quant.cu's kCap under CUDA >= 12.1
    # GoogLeNet's 128 leaves fit one launch; AlexNet's 16 too
    assert tq.table_capacity() >= 128


def test_table_rows_layout():
    launches = K.work_table([(16, 4096, 8192), (32, 4096 + 3 * 128, 8192 + 12)], [300, 129],
                            [0, 0], chunk=tq.CHUNK_ROWS * 128, capacity=8)
    raw = np.frombuffer(tq.table_rows(launches[0], (0, 3)).tobytes(), np.int64).reshape(2, 5)
    assert raw[:, :4].tolist() == [[16, 4096, 8192, 300], [32, 4480, 8204, 129]]
    assert raw[:, 4:].copy().view(np.int32).tolist() == [[0, 0], [1, 3]]  # chunk0, row0


# --------------------------------------------------------------------------
# the codec round: one launch each way, bit for bit against the reference
# --------------------------------------------------------------------------


def _tree(seed):
    """An AlexNet-shaped small gradient tree in the reference's layout: a
    conv kernel (HWIO, 9.4 rows), biases of 1 and 96 elements, a leaf of
    129 and an fc weight."""
    r = np.random.RandomState(seed)
    return {
        "conv1": {"w": (r.randn(5, 5, 3, 16) * 0.1).astype(np.float32),
                  "b": r.randn(96).astype(np.float32)},
        "fc": {"w": (r.randn(40, 33) * np.exp(r.randn(40, 1))).astype(np.float32),
               "b": r.randn(1).astype(np.float32)},
        "odd": r.randn(129).astype(np.float32),
    }


def _assert_tree_equal(port_tree, ref_tree):
    got = jax.tree_util.tree_leaves(bridge.tree_to_jax(port_tree))
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == np.shape(b)
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("route,jit,spec", [
    ("pallas", False, "int8"), ("pallas", False, "int8:ef"), ("pallas", True, "int8"),
    ("jnp", True, "int8")])
def test_compress_matches_reference_over_three_rounds(monkeypatch, route, jit, spec):
    """The reference's Pallas route eagerly (as tests/test_torch_codec.py),
    and both routes compiled. Not compiled ``int8:ef``: there XLA contracts
    the residual ``x - q`` into an FMA with the dequantize's multiply,
    which the reference's eager round (and the port) rounds twice; nor
    the jnp route eagerly, which divides by 127 truly where XLA multiplies
    by its reciprocal."""
    _route(monkeypatch, route)
    calls = []
    real = tc.quantize_int8_block_leaves
    monkeypatch.setattr(tc, "quantize_int8_block_leaves",
                        lambda xs: calls.append(len(xs)) or real(xs))
    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)
    tree0 = _tree(1)
    jef = jcodec.init_ef(jax.tree_util.tree_map(jnp.asarray, tree0))
    tef = tcodec.init_ef(bridge.tree_from_jax(tree0))
    for rnd in range(3):
        tree = _tree(10 + rnd)
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        jwire, jef = (jax.jit(jcodec.compress) if jit else jcodec.compress)(jtree, jef)
        twire, tef = tcodec.compress(bridge.tree_from_jax(tree), tef,
                                     bridge.default_layouts(tree))
        _assert_tree_equal(twire, jwire)
        if tcodec.error_feedback:
            _assert_tree_equal(tef, jef)
            assert tef["conv1"]["w"].is_contiguous(memory_format=torch.channels_last)
        else:
            assert tef == ()
    assert calls == [5, 5, 5]  # the whole tree quantized in one call a round


def test_qdq_and_compress_leaf_are_one_leaf_tables():
    codec = tc.get_codec("int8:ef")
    r = np.random.RandomState(4)
    v = torch.from_numpy((r.randn(3, 3, 4, 6) * 0.1).astype(np.float32))
    ef = torch.from_numpy((r.randn(3, 3, 4, 6) * 1e-3).astype(np.float32))
    q, ef2 = codec.compress_leaf(v, ef)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jc.get_codec("int8").qdq(
        jnp.asarray((v + ef).numpy()))))
    assert torch.equal(q + ef2, v + ef)
    wire, ef_tree = codec.compress({"w": v}, {"w": ef}, {"w": "plain"})
    assert torch.equal(wire["w"], q) and torch.equal(ef_tree["w"], ef2)


# --------------------------------------------------------------------------
# tools/quant_variants.py: its text edits
# --------------------------------------------------------------------------


def test_quant_variants_find_their_anchors_in_the_source():
    """``tools/quant_variants.py`` builds its variants by text edits of
    ``csrc/quant.cu``: each edit's anchor must stand in the source exactly
    once, and the entry point it times must be there."""
    from theanompi_tpu_torch.tools import quant_variants

    src = (K.CSRC_DIR / "quant.cu").read_text()
    variants = quant_variants._variants(src)
    assert variants["base"] == [] and len(variants) >= 5
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and new != old, name
    assert "int tmpi_block_codec_multi(" in src and "tmpi_block_codec_multi" in tq._LIB.signatures
    # the per-buffer kernels it replaced are gone: no entry point but the
    # multi-leaf launch and the whole-buffer #5-6
    assert sorted(re.findall(r"^int (tmpi_\w+)\(", src, re.M)) == sorted(tq._LIB.signatures)


def test_quant_variants_per_leaf_calls_are_the_one_buffer_wrappers():
    """The tool's ``per_leaf`` turn is the codec's former call pattern: one
    call of the package's one-buffer wrapper per padded leaf (on the CPU
    their plain versions, counting no launch)."""
    from theanompi_tpu_torch.tools import quant_variants

    r = np.random.RandomState(9)
    xs = [torch.from_numpy(r.randn(n).astype(np.float32)) for n in (1, 300, 129)]
    x2ds = [tq.pad_rows(x) for x in xs]
    K.reset_launch_counts()
    got = quant_variants.per_leaf_quantize(x2ds)
    vals, scales, row0s = tq.quantize_int8_block_leaves_plain(xs)
    assert torch.equal(torch.cat([v for v, _ in got]), vals)
    assert torch.equal(torch.cat([s for _, s in got]), scales)
    outs = quant_variants.per_leaf_dequantize(got)
    for out, x2d, (v, s) in zip(outs, x2ds, got):
        assert out.shape == x2d.shape
        assert torch.equal(out, tq.dequantize_int8_block_plain(v, s))
    assert K.launch_counts()["quant_block"] == K.launch_counts()["dequant_block"] == 0


def test_pack_rows_is_the_kernels_40_byte_row():
    """``ops/kernels.py::pack_rows``, shared by both multi-tensor tables:
    four int64, then the first chunk and the kernel's own int32,
    little-endian (``csrc/work_table.cuh``'s row)."""
    rows = K.pack_rows([(1, -2, 3, 4, 5, 6), (2**40, 0, 7, 8, 2**31 - 1, 1)])
    raw = rows.tobytes()
    assert len(raw) == 2 * K.TABLE_LEAF_BYTES == 80
    assert np.frombuffer(raw[:32], np.int64).tolist() == [1, -2, 3, 4]
    assert np.frombuffer(raw[32:40], np.int32).tolist() == [5, 6]
    assert np.frombuffer(raw[40:72], np.int64).tolist() == [2**40, 0, 7, 8]
    assert np.frombuffer(raw[72:80], np.int32).tolist() == [2**31 - 1, 1]
    for src in ("quant.cu", "fused_update.cu"):
        text = (K.CSRC_DIR / src).read_text()
        assert '#include "work_table.cuh"' in text and "work_table::leaf_of(" in text, src
    header = (K.CSRC_DIR / "work_table.cuh").read_text()
    assert f"constexpr int kRowBytes = {K.TABLE_LEAF_BYTES};" in header
    assert f"constexpr int kParamLimit = {K.PARAM_LIMIT};" in header
    assert K.table_capacity(16) == tq.table_capacity() and K.table_capacity(32) == \
        tfu.table_capacity()
