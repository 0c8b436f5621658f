"""The multi-tensor fused update of the PyTorch port (theanompi_tpu_torch/
ops/fused_update.py: one launch over all leaves of a dtype group) on the
CPU: its work table (ops/kernels.py::work_table), and the list wrappers
and the fused ``Optimizer.apply`` on a mixed tree against the JAX
reference (theanompi_tpu/ops/pallas_update.py) leaf by leaf.

On the CPU the wrappers run their plain versions; the CUDA kernel is held
against them on the card by chip_smoke.py (phase kernels).

Tolerances:
- against the reference's jnp route (``TMPI_PALLAS=0``, eager: every op
  rounded on its own, as the port's plain version and kernel): bit for
  bit, fp32 and bf16;
- against the reference's Pallas kernel in interpret mode: 1 fp32 ulp
  (1 bf16 ulp for bf16 params), as tests/test_torch_fused_update.py.
  XLA on the CPU contracts ``mu * v - lr * g`` into one fused multiply-add
  (fma(mu, v, -(lr * g)) reproduces its velocity bit for bit), which the
  port does not (the kernel is built with -fmad=false);
- the fused ``apply`` with a clip: the global-norm coefficient is summed
  in another order on each side, so 4 fp32 ulps against the reference
  (as the reference-math test), and bit for bit against the port's own
  per-leaf plain path.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from theanompi_tpu.ops import pallas_update as jfu
from theanompi_tpu_torch.ops import fused_update as tfu
from theanompi_tpu_torch.ops import kernels as K

LR = 0.05
KEYS = [(0, 0), (1, 1), (1, 0)]  # (param dtype, grad dtype) codes: fp32/fp32, bf16/bf16, bf16/fp32

# the mixed tree: (name, shape, param dtype, grad dtype); 4-D leaves are
# channels_last on the torch side, as the port's conv weights
TREE = [
    ("conv_a", (16, 3, 5, 5), "float32", "float32"),
    ("conv_b", (8, 16, 3, 3), "bfloat16", "bfloat16"),
    ("conv_c", (8, 4, 1, 1), "bfloat16", "float32"),
    ("one_f32", (1,), "float32", "float32"),
    ("one_bf16", (1,), "bfloat16", "float32"),
    ("odd", (1001,), "float32", "float32"),
    ("dense", (37, 129), "bfloat16", "bfloat16"),
    ("long", (8193,), "bfloat16", "float32"),
]
RULES = [
    ("momentum", {"momentum": 0.9, "weight_decay": 5e-4}),
    ("nesterov", {"momentum": 0.95, "weight_decay": 0.01}),
    ("sgd", {"weight_decay": 0.02}),
]


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


def _ulps(ref, got, bf16, operands=0.0):
    """Max distance in ulps at the leaf's scale (bf16 ulps for bf16): the
    largest magnitude of the result or of ``operands``. A contracted
    multiply-add errs by an ulp of its operands, so a result that cancels
    to below them is held to their scale."""
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    scale = np.float32(max(np.max(np.abs(ref)), np.max(np.abs(operands))))
    ulp = np.spacing(scale) * (2.0 ** 16 if bf16 else 1.0)
    return float(np.max(np.abs(ref - got)) / ulp)


def _np(t):
    return t.detach().float().numpy()


def _numpy_tree(seed):
    r = np.random.RandomState(seed)
    out = {}
    for name, shape, pd, gd in TREE:
        out[name] = (r.randn(*shape).astype(np.float32), (r.randn(*shape) * 0.1).astype(np.float32),
                     r.randn(*shape).astype(np.float32), pd, gd)
    return out


def _torch_leaf(a, dtype):
    t = torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


def _jax_leaf(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))


def _torch_tree(tree):
    ps = {k: _torch_leaf(p, pd) for k, (p, v, g, pd, gd) in tree.items()}
    vs = {k: _torch_leaf(v, "float32") for k, (p, v, g, pd, gd) in tree.items()}
    gs = {k: _torch_leaf(g, gd) for k, (p, v, g, pd, gd) in tree.items()}
    return ps, vs, gs


def _jax_tree(tree):
    ps = {k: _jax_leaf(p, pd) for k, (p, v, g, pd, gd) in tree.items()}
    vs = {k: jnp.asarray(v) for k, (p, v, g, pd, gd) in tree.items()}
    gs = {k: _jax_leaf(g, gd) for k, (p, v, g, pd, gd) in tree.items()}
    return ps, vs, gs


def _set_route(monkeypatch, route):
    monkeypatch.setenv("TMPI_PALLAS", "0" if route == "jnp" else "1")


def _hold(ref, got, bf16, route, what, operands=0.0):
    if route == "jnp":
        assert np.array_equal(_bits(ref), _bits(got)), f"{what}: not bit-identical"
    else:
        ulps = _ulps(ref, got, bf16, operands)
        assert ulps <= 1, f"{what}: {ulps} ulp"


# --------------------------------------------------------------------------
# the list wrappers against the reference, leaf by leaf
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["jnp", "pallas"])
@pytest.mark.parametrize("coef", [1.0, 0.37], ids=["clip_off", "clip_on"])
@pytest.mark.parametrize("name,kwargs", RULES, ids=[r[0] for r in RULES])
def test_leaves_match_reference_leaf_by_leaf(monkeypatch, route, coef, name, kwargs):
    _set_route(monkeypatch, route)
    tree = _numpy_tree(0)
    tp, tv, tg = _torch_tree(tree)
    jp, jv, jg = _jax_tree(tree)
    keys = list(tree)
    sc = tfu.scalars(LR, coef, "cpu")
    if name == "sgd":
        out = tfu.fused_sgd_leaves([tp[k] for k in keys], [tg[k] for k in keys], sc, **kwargs)
        assert all(o is tp[k] for o, k in zip(out, keys))  # in place
    else:
        nest = name == "nesterov"
        out_p, out_v = tfu.fused_update_leaves(
            [tp[k] for k in keys], [tv[k] for k in keys], [tg[k] for k in keys], sc,
            momentum=kwargs["momentum"], weight_decay=kwargs["weight_decay"], nesterov=nest)
        assert all(o is tp[k] for o, k in zip(out_p, keys))
        assert all(o is tv[k] for o, k in zip(out_v, keys))
    for k in keys:
        bf16 = tree[k][3] == "bfloat16"
        assert tp[k].dtype == getattr(torch, tree[k][3])
        if tp[k].dim() == 4:
            assert tp[k].is_contiguous(memory_format=torch.channels_last)
        if name == "sgd":
            want_p = jfu.fused_sgd_leaf(jp[k], jg[k], jnp.float32(LR), jnp.float32(coef), **kwargs)
        else:
            want_p, want_v = jfu.fused_update_leaf(
                jp[k], jv[k], jg[k], jnp.float32(LR), jnp.float32(coef),
                momentum=kwargs["momentum"], weight_decay=kwargs["weight_decay"], nesterov=nest)
            # the contracted product's operands: mu * v and lr * (g * coef + wd * p)
            p0, v0, g0 = (np.asarray(a, np.float32) for a in tree[k][:3])
            ops = np.concatenate([np.abs(kwargs["momentum"] * v0).ravel(),
                                  np.abs(LR * (g0 * coef + kwargs["weight_decay"] * p0)).ravel()])
            _hold(want_v, _np(tv[k]), False, route, f"{k} velocity", ops)
        _hold(want_p.astype(jnp.float32), _np(tp[k]), bf16, route, f"{k} param")


@pytest.mark.parametrize("clip", [None, 2.0], ids=["clip_off", "clip_on"])
@pytest.mark.parametrize("name,kwargs", RULES, ids=[r[0] for r in RULES])
def test_fused_apply_matches_reference_on_a_mixed_tree(monkeypatch, clip, name, kwargs):
    _set_route(monkeypatch, "jnp")
    tree = _numpy_tree(1)
    tp, _, tg = _torch_tree(tree)
    jp, _, jg = _jax_tree(tree)
    to = tfu.fuse_optimizer(name, clip_norm=clip, **kwargs)
    jo = jfu.fuse_optimizer(name, clip_norm=clip, **kwargs)
    # the port's per-leaf plain path from the same start, the port's coefficient
    pp = {k: t.clone() for k, t in tp.items()}
    ts, js = to.init(tp), jo.init(jp)
    ps_ = to.init(pp)
    for _ in range(2):
        tp, ts = to.apply(tg, ts, tp, torch.tensor(LR))
        jp, js = jo.apply(jg, js, jp, jnp.float32(LR))
        sc = tfu.scalars(torch.tensor(LR), tfu.clip_coefficient(list(tg.values()), clip), "cpu")
        for k in tree:
            if name == "sgd":
                tfu.fused_sgd_leaf_plain(pp[k], tg[k], sc, **kwargs)
            else:
                tfu.fused_update_leaf_plain(pp[k], ps_["vel"][k], tg[k], sc,
                                            momentum=kwargs["momentum"],
                                            weight_decay=kwargs["weight_decay"],
                                            nesterov=name == "nesterov")
    for k in tree:
        bf16 = tree[k][3] == "bfloat16"
        assert torch.equal(tp[k], pp[k]), f"{k}: apply differs from the per-leaf plain path"
        ref = np.asarray(jp[k].astype(jnp.float32))
        if clip is None:
            assert np.array_equal(_bits(ref), _bits(_np(tp[k]))), f"{k} param"
        else:
            assert _ulps(ref, _np(tp[k]), bf16) <= 4, f"{k} param"
        if name != "sgd":
            assert torch.equal(ts["vel"][k], ps_["vel"][k])
            vref = np.asarray(js["vel"][k])
            if clip is None:
                assert np.array_equal(_bits(vref), _bits(_np(ts["vel"][k]))), f"{k} velocity"
            else:
                assert _ulps(vref, _np(ts["vel"][k]), False) <= 4, f"{k} velocity"


def test_cpu_path_counts_no_launches():
    tfu.MOMENTUM.reset()
    tfu.SGD.reset()
    tp, tv, tg = _torch_tree(_numpy_tree(2))
    keys = list(tp)
    sc = tfu.scalars(LR, 1.0, "cpu")
    tfu.fused_update_leaves([tp[k] for k in keys], [tv[k] for k in keys],
                            [tg[k] for k in keys], sc, momentum=0.9, weight_decay=0.0,
                            nesterov=True)
    tfu.fused_sgd_leaves([tp[k] for k in keys], [tg[k] for k in keys], sc, weight_decay=0.0)
    for name, kwargs in RULES:
        opt = tfu.fuse_optimizer(name, clip_norm=1.0, **kwargs)
        opt.apply(tg, opt.init(tp), tp, torch.tensor(LR))
    assert tfu.MOMENTUM.launches == 0 and tfu.SGD.launches == 0


def test_a_list_that_is_not_all_on_the_cpu_raises():
    cpu, meta = torch.ones(5), torch.empty(5, device="meta")
    sc = tfu.scalars(LR, 1.0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_update_leaves([cpu, meta], [cpu.clone(), meta], [cpu.clone(), meta], sc,
                                momentum=0.9, weight_decay=0.0, nesterov=False)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_sgd_leaves([meta, cpu], [meta, cpu.clone()], sc, weight_decay=0.0)


def test_checks_refuse_two_leaves_on_one_buffer_and_ragged_lists(monkeypatch):
    # the device checks need a card; what is left to test here is the
    # leaf-list logic around them (the one pass takes the first leaf's
    # device, here the CPU)
    monkeypatch.setattr(tfu, "require_cuda", lambda *a, **k: None)
    p, g = torch.ones(8), torch.ones(8)
    sc = torch.ones(2)
    cap = tfu.table_capacity()
    with pytest.raises(ValueError, match="share one buffer"):
        tfu._checked_plan([p, p[:4]], [g, g[:4]], sc, [torch.zeros(8), torch.zeros(4)], cap)
    with pytest.raises(ValueError, match="2 params, 1 grads"):
        tfu._checked_plan([p, torch.ones(3)], [g], sc, None, cap)
    # an empty leaf has no buffer to share, and no launch
    dev, launches = tfu._checked_plan([torch.ones(0), torch.ones(0), p], [g[:0], g[:0], g], sc,
                                      None, cap)
    assert dev == p.device and [la.leaves for la in launches] == [(2,)]


@pytest.mark.parametrize("bad", ["shape", "strides", "grad_dtype", "param_dtype", "velocity_dtype",
                                 "not_a_tensor"])
def test_the_one_pass_words_a_failed_check_as_require_cuda(bad):
    """The one pass's inline checks fail where ``require_cuda`` does, and
    raise its error, naming the leaf (the device checks are the card's;
    here the first leaf's device, the CPU, stands in for it)."""
    cpu = torch.device("cpu")
    p = torch.zeros(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    ps, vs, gs = [torch.zeros(3), p], [torch.zeros(3), torch.zeros_like(p)], [torch.zeros(3),
                                                                              torch.zeros_like(p)]
    assert tfu._gather(ps, gs, vs, cpu)[2] == [(0, 0), (0, 0)]
    if bad == "shape":
        gs[1] = torch.zeros(2, 3, 4, 6)
    elif bad == "strides":
        gs[1] = torch.zeros(2, 3, 4, 5)  # contiguous, not channels_last
    elif bad == "grad_dtype":
        gs[1] = gs[1].double()
    elif bad == "param_dtype":
        ps[1], vs[1], gs[1] = p.half(), vs[1], gs[1].half()
    elif bad == "velocity_dtype":
        vs[1] = vs[1].to(torch.bfloat16)
    else:
        gs[1] = np.zeros((2, 3, 4, 5), np.float32)
    # require_cuda words it: on the CPU, the first thing it says is the device
    with pytest.raises((TypeError, ValueError), match="leaf 1: "):
        tfu._gather(ps, gs, vs, cpu)


# --------------------------------------------------------------------------
# the work table
# --------------------------------------------------------------------------

LENGTHS = [0, 1, 7, 127, 8191, 8192, 8193, 2_000_003, 37_748_736]  # the last: AlexNet's fc6
OFFSETS = [0, 0, 0, 2, 4, 8, 16]  # bytes off a 256-byte boundary (0: aligned)


def _check_table(launches, lengths, keys, ptrs, chunk, capacity):
    """Every property the kernel relies on, by its own chunk -> leaf search."""
    nonempty = [i for i, n in enumerate(lengths) if n]
    seen = [i for la in launches for i in la.leaves]
    # the launches partition the non-empty leaves, each group by its key
    assert sorted(seen) == nonempty and len(seen) == len(set(seen))
    per_key = {}
    for i in nonempty:
        per_key.setdefault(keys[i], []).append(i)
    assert list(dict.fromkeys(la.key for la in launches)) == list(per_key)
    for key, members in per_key.items():
        mine = [la for la in launches if la.key == key]
        assert [i for la in mine for i in la.leaves] == members  # input order kept
        assert len(mine) == -(-len(members) // capacity)  # split only past the capacity
    for la in launches:
        assert 1 <= len(la.leaves) <= capacity
        assert all(keys[i] == la.key for i in la.leaves)
        assert la.ptrs == tuple(tuple(ptrs[i]) for i in la.leaves)
        assert la.lengths == tuple(lengths[i] for i in la.leaves)
        assert la.aligned == tuple(all(a % 16 == 0 for a in ptrs[i]) for i in la.leaves)
        # the kernel: chunk c belongs to the last leaf whose first chunk <= c
        c0 = np.asarray(la.chunk0, np.int64)
        n = np.asarray(la.lengths, np.int64)
        c = np.arange(la.chunks, dtype=np.int64)
        leaf = np.searchsorted(c0, c, side="right") - 1
        start = (c - c0[leaf]) * chunk
        length = np.minimum(chunk, n[leaf] - start)
        assert la.chunks < 2 ** 31 and (leaf >= 0).all()
        assert (start >= 0).all() and (length > 0).all()
        assert (start + length <= n[leaf]).all()  # no chunk crosses its leaf's end
        # every element of every leaf exactly once: chunks are contiguous from 0
        counts = np.bincount(leaf, minlength=len(n))
        assert (counts == -(-n // chunk)).all()
        assert (np.bincount(leaf, weights=length, minlength=len(n)) == n).all()
        assert (start == np.concatenate([np.arange(k) * chunk for k in counts])).all()


@st.composite
def leaf_lists(draw):
    k = draw(st.integers(0, 40))
    arrays = draw(st.sampled_from([2, 3]))  # sgd (p, g) or momentum (p, v, g)
    lengths = draw(st.lists(st.sampled_from(LENGTHS), min_size=k, max_size=k))
    keys = draw(st.lists(st.sampled_from(KEYS), min_size=k, max_size=k))
    offs = draw(st.lists(st.lists(st.sampled_from(OFFSETS), min_size=arrays, max_size=arrays),
                         min_size=k, max_size=k))
    # distinct 256-byte-aligned bases, one per array of each leaf, plus its offset
    ptrs = [tuple(0x7F0000000000 + (i * arrays + j) * (1 << 30) + o for j, o in enumerate(off))
            for i, off in enumerate(offs)]
    return ptrs, lengths, keys


@settings(max_examples=150, deadline=None)
@given(leaf_lists(),
       st.sampled_from([1, 3, tfu.table_capacity(4096), tfu.table_capacity()]),
       st.sampled_from([4096, tfu.CHUNK, 16384]))
def test_work_table_covers_every_element_once(leaves, capacity, chunk):
    ptrs, lengths, keys = leaves
    launches = K.work_table(ptrs, lengths, keys, chunk=chunk, capacity=capacity)
    _check_table(launches, lengths, keys, ptrs, chunk, capacity)


def _table_bytes(n_leaves):
    return tfu.TABLE_HEADER_BYTES + tfu.TABLE_LEAF_BYTES * n_leaves


@pytest.mark.parametrize("limit", [4096, tfu.PARAM_LIMIT])
def test_every_launch_fits_the_parameter_limit(limit):
    cap = tfu.table_capacity(limit)
    assert _table_bytes(cap) <= limit < _table_bytes(cap + 1)
    # GoogLeNet's 128 leaves: one launch under CUDA >= 12.1, two under 4 KB
    lengths = [100] * 128
    launches = K.work_table([(16 * i, 16 * i) for i in range(128)], lengths, [(0, 0)] * 128,
                            chunk=tfu.CHUNK, capacity=cap)
    assert len(launches) == (1 if limit == tfu.PARAM_LIMIT else 2)
    assert all(_table_bytes(len(la.leaves)) <= limit for la in launches)
    _check_table(launches, lengths, [(0, 0)] * 128, [(16 * i, 16 * i) for i in range(128)],
                 tfu.CHUNK, cap)


def test_work_table_small_chunks_and_refusals():
    # chunk 8: two of the kernel's 4-element quads; every leaf a multiple and not
    lengths, keys = [8, 9, 0, 16, 1], [(0, 0)] * 5
    ptrs = [(256 * i, 256 * i + 4) for i in range(5)]
    launches = K.work_table(ptrs, lengths, keys, chunk=8, capacity=2)
    assert [la.leaves for la in launches] == [(0, 1), (3, 4)]
    assert [la.chunk0 for la in launches] == [(0, 1), (0, 2)]
    assert [la.chunks for la in launches] == [3, 3]
    assert all(not a for la in launches for a in la.aligned)
    _check_table(launches, lengths, keys, ptrs, 8, 2)
    assert K.work_table([], [], [], chunk=8, capacity=1) == []
    with pytest.raises(ValueError, match="positive"):
        K.work_table(ptrs, lengths, keys, chunk=0, capacity=1)
    with pytest.raises(ValueError, match="negative"):
        K.work_table(ptrs[:1], [-1], keys[:1], chunk=8, capacity=1)
    with pytest.raises(ValueError, match="lengths"):
        K.work_table(ptrs, lengths[:2], keys, chunk=8, capacity=1)
    # the kernel loads 4-element quads from every chunk start, and the
    # table's alignment flag speaks for every chunk of the leaf
    assert tfu.CHUNK % 4 == 0


def test_plan_of_real_leaves_groups_dtypes_and_flags_misaligned_views():
    f32 = torch.zeros(1000, dtype=torch.float32)
    bf = torch.zeros(1000, dtype=torch.bfloat16)
    ps = [f32[:100], bf[:64], bf[8:72], f32[1:101], bf[:0], f32[200:201], bf[2:10]]
    gs = [torch.zeros(100), torch.zeros(64, dtype=torch.bfloat16), torch.zeros(64),
          torch.zeros(101)[1:], torch.zeros(0), torch.zeros(1), torch.zeros(8)]
    vs = [torch.zeros(p.shape) for p in ps]
    launches = tfu.plan(ps, gs, vs, capacity=tfu.table_capacity())
    # groups in first-appearance order: fp32/fp32, bf16/bf16, bf16/fp32; the empty leaf dropped
    assert [(la.key, la.leaves) for la in launches] == [
        ((0, 0), (0, 3, 5)), ((1, 1), (1,)), ((1, 0), (2, 6))]
    want = {i: all(t.data_ptr() % 16 == 0 for t in (ps[i], vs[i], gs[i])) for i in range(7)}
    assert want[3] is False and want[6] is False  # 4-byte-misaligned views
    for la in launches:
        assert la.aligned == tuple(want[i] for i in la.leaves)
        assert la.ptrs == tuple((ps[i].data_ptr(), vs[i].data_ptr(), gs[i].data_ptr())
                                for i in la.leaves)
    sgd = tfu.plan(ps, gs, capacity=1)
    assert [la.leaves for la in sgd] == [(0,), (3,), (5,), (1,), (2,), (6,)]
    assert all(len(p) == 2 for la in sgd for p in la.ptrs)


def test_table_rows_are_the_kernels_leaf_layout():
    launches = K.work_table([(16, 32, 48), (4100, 4, 8)], [20_000, 3], [(0, 0), (0, 0)],
                            chunk=8192, capacity=8)
    rows = tfu.table_rows(launches[0])
    assert rows.itemsize * len(rows) == tfu.TABLE_LEAF_BYTES * 2
    raw = np.frombuffer(rows.tobytes(), dtype=np.int64).reshape(2, 5)
    assert raw[:, :4].tolist() == [[16, 32, 48, 20_000], [4100, 4, 8, 3]]
    tail = raw[:, 4:].copy().view(np.int32)  # (chunk0, aligned) as two int32, little end first
    assert tail.tolist() == [[0, 1], [3, 0]]
    sgd = tfu.table_rows(K.work_table([(16, 48)], [5], [(1, 1)], chunk=8192, capacity=8)[0])
    assert sgd.tolist()[:4] == [16, 0, 48, 5]


# --------------------------------------------------------------------------
# tools/update_variants.py: its text edits and its leaf lists
# --------------------------------------------------------------------------


def test_update_variants_find_their_anchors_in_the_source():
    """``tools/update_variants.py`` builds its variants by text edits of
    ``csrc/fused_update.cu``: each edit's anchor must stand in the source
    exactly once."""
    from theanompi_tpu_torch.tools import update_variants

    src = (K.CSRC_DIR / "fused_update.cu").read_text()
    variants = update_variants._variants(src)
    assert variants["base"] == [] and len(variants) == 5
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and new != old, name


def test_update_variants_leaf_lists_are_the_models():
    from theanompi_tpu_torch.tools import update_variants

    alex, gnet = update_variants.leaf_specs("alexnet"), update_variants.leaf_specs("googlenet")
    assert len(alex) == 16 and sum(int(np.prod(s)) for s, _ in alex) == 60_965_224
    assert len(gnet) == 128 and sum(int(np.prod(s)) for s, _ in gnet) == 13_378_280
    # the conv kernels whose layouts differ are channels_last, as on the main path
    assert sum(cl for _, cl in alex) == 5 and all(len(s) == 4 for s, cl in gnet if cl)
