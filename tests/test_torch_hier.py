"""The ``hier`` strategy of the port over ``--slices`` (``parallel/
strategies.py::hierarchical_sync``, its bucketed composition, and
``parallel/mesh.py``'s slice groups) against the JAX package's
(``tests/test_hier.py``), on 4 gloo ranks in 2 slices of 2.

1. The exchange alone, each rank's gradient tree (a conv kernel carried
   across with the bridge, a 1-element leaf, odd lengths) against the
   reference's on ``make_multislice_mesh(4, 2)``: ``hier`` with no codec,
   ``int8`` and ``int8:ef`` on the cross-slice hop, and in 0.001 MB
   buckets (2 buckets, one of three leaves) with the same three codecs
   (no codec and ``int8`` posted from a backward, ``int8:ef`` after it).
   Each hop sums two ranks, so the order of the sum is the reference's:
   the mean gradients are bit-identical (the int8 path too: compiled,
   both the reference's routes quantize as the port does; ROADMAP's
   note on the codec's two references). The ``:ef`` residual rows, ``x - Q(x)`` of the slice-summed
   shard plus its residual, are within 1 ulp of x: the jitted reference
   contracts the subtraction into a fused multiply-add.
2. Training: 3 steps of the 67x67 no-dropout AlexNet (fp32) from the
   reference's weights over 4 ranks: ``hier`` against the reference's
   ``hier`` engine at the trajectory limits of ``tests/test_torch_bsp.py``
   (losses rtol 1e-5, params and velocities rtol 1e-4 + atol 1e-6) and
   against the port's flat ``psum`` (the sum associates differently:
   the same limits); ``hier`` with ``int8:ef`` in 4 MB buckets tracks
   the exact run within the reference's band for it (loss rtol 0.05,
   params rtol 0.15 + atol 5e-3); the replicas bit-identical, the
   residuals per rank.
3. hier's ``:ef`` state (``[n, seg]``, or one a bucket) through a
   ``.npz`` written by each package, row by rank.
4. The refusals: ``hier`` without slices, a ring over slices, a world
   the slices do not divide.
"""

import pathlib
import shutil
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.parallel import strategies as jst
from theanompi_tpu.parallel.bsp import BSPEngine as JBSPEngine
from theanompi_tpu.parallel.mesh import make_multislice_mesh
from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.bridge import default_layouts
from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.parallel import strategies as tst
from theanompi_tpu_torch.parallel.bsp import BSPEngine
from theanompi_tpu_torch.parallel.mesh import slice_topology
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.utils import checkpoint as tckpt
from tests.tinymodel import TinyCNN as JTinyCNN

import torch_exchange_rank_fns
from torch_rank_fns import TinyCNN as TTinyCNN

N, SLICES = 4, 2
AXES = ("dcn", "data")
SIZES = (2, 2)
BUCKET_MB = 0.001
CASES = {  # name -> (codec, bucketed)
    "hier": (None, False), "hier+int8": ("int8", False), "hier+int8:ef": ("int8:ef", False),
    "buckets": (None, True), "buckets+int8": ("int8", True),
    "buckets+int8:ef": ("int8:ef", True),
}


def _grads(seed=0):
    r = np.random.RandomState(seed)
    return {
        "conv": {"w": (r.randn(N, 3, 3, 4, 6) * 0.1).astype(np.float32),
                 "b": r.randn(N, 1).astype(np.float32)},
        "fc": {"w": (r.randn(N, 20, 33) * np.exp(r.randn(N, 20, 1))).astype(np.float32),
               "b": r.randn(N, 7).astype(np.float32)},
    }


def _efs():
    """Residual rows [N, seg] (one per bucket when bucketed) of each
    ``:ef`` case, drawn small."""
    r = np.random.RandomState(1)
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a[0], _grads()))
    out = {}
    for case, (codec, buckets) in CASES.items():
        if codec != "int8:ef":
            continue
        idxs = (jst.assign_buckets(leaves, max(1, int(BUCKET_MB * 2 ** 20))) if buckets
                else [range(len(leaves))])
        rows = [(0.01 * r.randn(N, jst.hier_segment(sum(leaves[i].size for i in idx),
                                                     SIZES[1]))).astype(np.float32)
                for idx in idxs]
        out[case] = tuple(rows) if buckets else rows[0]
    return out


def _unstack(tree):
    return [jax.tree_util.tree_map(lambda a: a[i], tree) for i in range(N)]


def _reference(case):
    codec, buckets = CASES[case]
    mesh = make_multislice_mesh(N, n_slices=SLICES)
    strat = (jst.bucketed("hier", AXES, N, BUCKET_MB, codec=codec, axis_sizes=SIZES) if buckets
             else jst.get_strategy("hier", AXES, N, codec=codec, axis_sizes=SIZES))
    grads = jax.tree_util.tree_map(jnp.asarray, _grads())
    first = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)  # noqa: E731
    stack = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)  # noqa: E731
    if getattr(strat, "stateful", False):
        def f(g, e):
            out, e = strat(first(g), e)
            return stack(out), e

        fn = jax.shard_map(f, mesh=mesh, in_specs=(P(AXES), P(AXES)),
                           out_specs=(P(AXES), P(AXES)), check_vma=False)
        out, ef = jax.jit(fn)(grads, jax.tree_util.tree_map(jnp.asarray, _efs()[case]))
        return jax.tree_util.tree_map(np.asarray, out), [np.asarray(e) for e in
                                                         jax.tree_util.tree_leaves(ef)]
    fn = jax.shard_map(lambda g: stack(strat(first(g))), mesh=mesh, in_specs=(P(AXES),),
                       out_specs=P(AXES), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(grads)), []


_PORT: dict = {}


@pytest.fixture
def strategy_results(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if "strategies" not in _PORT:
        efs = {case: [tuple(row[i] for row in rows) if isinstance(rows, tuple) else rows[i]
                      for i in range(N)] for case, rows in _efs().items()}
        _PORT["strategies"] = spawn_ranks(
            torch_exchange_rank_fns.hier_strategies_rank, N,
            (_unstack(_grads()), efs, CASES, SLICES, BUCKET_MB), device="cpu", timeout=240)
    return _PORT["strategies"]


@pytest.mark.parametrize("case", list(CASES))
def test_hier_exchange_matches_the_reference(strategy_results, case):
    ref_out, ref_ef = _reference(case)
    efs = _efs().get(case)
    for rank, res in enumerate(strategy_results):
        out, ef = res[case]
        got, want = jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref_out)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b[rank], err_msg=f"{case} rank {rank}")
        assert len(ef) == len(ref_ef)
        for i, (a, b) in enumerate(zip(ef, ref_ef)):
            # x = the slice-summed shard + the carried residual; |r' - r'_ref| <= 1 ulp of x
            carried = (efs[i] if isinstance(efs, tuple) else efs)[rank]
            x_bound = np.abs(carried).max() + SLICES * max(
                np.abs(g).max() for g in jax.tree_util.tree_leaves(_grads()))
            np.testing.assert_allclose(a, b[rank], rtol=0, atol=2.0 ** -23 * x_bound,
                                       err_msg=f"{case} residual rank {rank}")
        for a, b in zip(got, jax.tree_util.tree_leaves(strategy_results[0][case][0])):
            np.testing.assert_array_equal(a, b)


class JAlexNetNoDropout(JAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, jnn.Dropout):
                layer.rate = 0.0
        return net


GLOBAL_BATCH = 8
STEPS = 3
RUNS = {
    "psum": {"n_slices": SLICES},
    "hier": {"n_slices": SLICES, "strategy": "hier"},
    "hier+int8:ef+buckets": {"n_slices": SLICES, "strategy": "hier", "wire_codec": "int8:ef",
                             "allreduce_buckets": 4.0},
}


@pytest.fixture
def training_results(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if "training" not in _PORT:
        jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(
            input_shape=(67, 67, 3), num_classes=10, batch_size=GLOBAL_BATCH,
            compute_dtype=jnp.float32))
        engine = JBSPEngine(jm, make_multislice_mesh(N, n_slices=SLICES), strategy="hier")
        jstate = engine.init_state(jax.random.PRNGKey(0))
        params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
        vel0 = jax.tree_util.tree_map(np.asarray, jstate.opt_state)
        r = np.random.RandomState(0)
        batches = [(r.randn(GLOBAL_BATCH, 67, 67, 3).astype(np.float32),
                    r.randint(0, 10, GLOBAL_BATCH).astype(np.int32)) for _ in range(STEPS)]
        ranks = spawn_ranks(torch_exchange_rank_fns.exchange_rank, N,
                            (params0, vel0, batches, RUNS), device="cpu", timeout=400)
        losses = []
        for x, y in batches:
            jstate, m = engine.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                          jax.random.PRNGKey(1))
            losses.append(float(m["loss"]))
        _PORT["training"] = (ranks, losses, jstate)
    return _PORT["training"]


def _close(mine, ref, rtol, atol, what):
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def test_hier_training_matches_the_reference_and_flat_psum(training_results):
    ranks, jlosses, jstate = training_results
    for rank, res in enumerate(ranks):
        hier, flat = res["hier"], res["psum"]
        assert hier["step"] == STEPS
        np.testing.assert_allclose(hier["losses"], jlosses, rtol=1e-5, err_msg=f"rank {rank}")
        _close(hier["params"], jstate.params, 1e-4, 1e-6, f"params rank {rank}")
        _close(hier["vel"], jstate.opt_state, 1e-4, 1e-6, f"velocities rank {rank}")
        np.testing.assert_allclose(hier["losses"], flat["losses"], rtol=1e-5)
        _close(hier["params"], flat["params"], 1e-4, 1e-6, f"hier vs psum rank {rank}")
        for a, b in zip(jax.tree_util.tree_leaves(hier["params"]),
                        jax.tree_util.tree_leaves(ranks[0]["hier"]["params"])):
            np.testing.assert_array_equal(a, b)


def test_hier_int8_ef_in_buckets_tracks_the_exact_run(training_results):
    ranks, _, _ = training_results
    for rank, res in enumerate(ranks):
        got, exact = res["hier+int8:ef+buckets"], res["psum"]
        assert got["step"] == STEPS and got["n_buckets"] == 8
        assert np.all(np.isfinite(got["losses"]))
        np.testing.assert_allclose(got["losses"], exact["losses"], rtol=0.05)
        _close(got["params"], exact["params"], 0.15, 5e-3, f"rank {rank}")
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(ranks[0]["hier+int8:ef+buckets"]["params"])):
            np.testing.assert_array_equal(a, b)
        # one shard row a bucket, each rank's own
        assert len(got["ef"]) == 8 and all(np.abs(e).max() > 0 for e in got["ef"])
    assert any(not np.array_equal(a, b) for a, b in
               zip(ranks[0]["hier+int8:ef+buckets"]["ef"], ranks[1]["hier+int8:ef+buckets"]["ef"]))


@pytest.fixture
def scratch():
    d = tempfile.mkdtemp(prefix="tmpi-test-")
    try:
        yield pathlib.Path(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("bucket_mb", [None, 0.001], ids=["one-row", "a-row-a-bucket"])
def test_the_hier_ef_rows_cross_packages_by_rank(scratch, bucket_mb):
    jm = JTinyCNN(JTinyCNN.default_recipe().replace(batch_size=8, input_shape=(16, 16, 3)))
    jeng = JBSPEngine(jm, make_multislice_mesh(N, n_slices=SLICES), strategy="hier",
                      wire_codec="int8:ef", allreduce_buckets=bucket_mb or 0.0)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    r = np.random.RandomState(3)
    jef = jax.tree_util.tree_map(lambda e: jnp.asarray(r.randn(*e.shape).astype(np.float32)),
                                 jstate.ef)
    jstate = jstate._replace(ef=jef)
    path = jckpt.save_checkpoint(str(scratch / "jax"), jstate, 0)

    tm = TTinyCNN(TTinyCNN.default_recipe().replace(batch_size=8))
    template = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    bucket_bytes = max(1, int(bucket_mb * 2 ** 20)) if bucket_mb else None
    template = template._replace(ef=tst.hier_ef_template(template.params, SIZES, bucket_bytes))
    layouts = tm.param_layouts(template.params)
    flat = tckpt.load_checkpoint(path)
    want = [np.asarray(e) for e in jax.tree_util.tree_leaves(jef)]
    rows = []
    for rank in range(N):
        state = bridge.state_from_flat(flat, template, layouts, rank=rank, world=N)
        got = [e.numpy() for e in (state.ef if bucket_mb else (state.ef,))]
        assert [g.shape for g in got] == [w.shape[1:] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[rank])
        rows.append(state.ef)
    # the port's rows -> the reference's [n, seg] template, bit for bit
    shifted = [jax.tree_util.tree_map(lambda e: e + 1.0, row) for row in rows]
    port_path = tckpt.save_checkpoint(
        str(scratch / "port"), bridge.state_to_flat(template, layouts, ef_ranks=shifted), 0)
    restored, _ = jckpt.load_checkpoint(port_path, jstate)
    for a, w in zip(jax.tree_util.tree_leaves(restored.ef), want):
        np.testing.assert_array_equal(np.asarray(a), w + 1.0)


def test_the_refusals_match_the_reference():
    model = torch_exchange_rank_fns._alexnet(8)
    with pytest.raises(ValueError, match="needs a multislice mesh") as got:
        BSPEngine(model, 1, "cpu", strategy="hier")
    assert "--slices N with N > 1" in str(got.value)
    with pytest.raises(ValueError, match="needs a multi-slice run"):
        tst.get_strategy("hier", 4, layouts=default_layouts)
    for name in ("ring", "ring_bf16", "ring_int8", "asa16"):
        with pytest.raises(ValueError) as want:
            jst.get_strategy(name, AXES, 4)
        with pytest.raises(ValueError) as got:
            tst.get_strategy(name, 4, layouts=default_layouts, axis_sizes=SIZES)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    tst.get_strategy("ring", 4, layouts=default_layouts, axis_sizes=(1, 4))  # one slice
    with pytest.raises(ValueError, match="4 ranks do not divide into 3 slices"):
        slice_topology(4, 3)
    with pytest.raises(ValueError, match="do not multiply to the 8 ranks"):
        tst.bucketed("hier", 8, 1.0, layouts=default_layouts, axis_sizes=SIZES)
    assert slice_topology(4, None) == (1, 4) and slice_topology(4, 2) == SIZES
