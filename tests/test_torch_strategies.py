"""The port's gradient-exchange strategies (``parallel/strategies.py``)
against the JAX package's, at n = 2, 3 and 4 ranks.

Each n runs once as n gloo ranks (``spawn_ranks``, one process each, a
``file://`` rendezvous), every rank feeding every strategy its own
gradient tree; the reference runs the same per-rank trees on
``Mesh(devices[:n], ("data",))`` under ``shard_map``. The tree holds a
conv kernel (carried across with the bridge), a 1-element leaf and odd
lengths, so the ring's zero pad and the reference's flat order matter.

Tolerances. The ring family (ring, ring_bf16, ring_int8, ring with the
int8 codec) is bit-identical: the port packs in the reference's order,
cuts the same segments, adds in the same hop order and takes the mean
as the reference's compiled ``* fl(1/n)``. The psum family (psum,
psum with the int8 codec, with and without error feedback) sums through
gloo's allreduce in another order than XLA's: rtol 1e-6 (plus atol
1e-7 for sums that cancel). psum_bf16 reduces in bf16 on both sides, so
a different sum order may round differently: within 2 bf16 ulps of the
result's magnitude. Error-feedback residuals ``r' = x - Q(x)`` (x the
gradient plus the carried residual) are within 1 ulp of x: the jitted
reference contracts ``x - vals * scale`` into one fused multiply-add on
the CPU, where the port (like the eager reference, which
tests/test_torch_codec.py holds bit for bit) rounds the product first.
On every rank the synced result is the same (the replicas stay
identical).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from theanompi_tpu.parallel import strategies as jst
from theanompi_tpu_torch.bridge import default_layouts
from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.parallel import strategies as tst

import torch_rank_fns
from torch_rank_fns import LM_STRATEGY_CASES, STRATEGY_CASES

RING_FAMILY = ("ring", "ring_bf16", "ring_int8", "ring+int8")


def _grads(n, seed=0):
    """Per-rank gradient trees in the reference layout, stacked [n, ...]."""
    r = np.random.RandomState(seed)
    return {
        "conv": {"w": (r.randn(n, 3, 3, 4, 6) * 0.1).astype(np.float32),
                 "b": r.randn(n, 1).astype(np.float32)},
        "fc": {"w": (r.randn(n, 20, 33) * np.exp(r.randn(n, 20, 1))).astype(np.float32),
               "b": r.randn(n, 7).astype(np.float32)},
    }


def _residuals(n):
    return jax.tree_util.tree_map(lambda a: (a * 0.01).astype(np.float32), _grads(n, seed=1))


def _unstack(tree, n):
    return [jax.tree_util.tree_map(lambda a: a[i], tree) for i in range(n)]


def _reference(n, case, grads=None, residuals=None):
    """The reference strategy on the n-device CPU mesh -> (stacked
    synced grads, stacked residuals or ()); ``grads`` / ``residuals``
    default to ``_grads(n)`` / ``_residuals(n)``."""
    name, codec = STRATEGY_CASES[case]
    strat = jst.get_strategy(name, "data", n, codec=codec)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    grads = jax.tree_util.tree_map(jnp.asarray, _grads(n) if grads is None else grads)
    if getattr(strat, "stateful", False):
        residuals = _residuals(n) if residuals is None else residuals
        ef = (jax.tree_util.tree_map(jnp.asarray, residuals)
              if codec.endswith(":ef") else ())

        def f(g, e):
            out, e = strat(jax.tree_util.tree_map(lambda a: a[0], g), e)
            return jax.tree_util.tree_map(lambda a: a[None], out), e

        fn = jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")), check_vma=False)
        out, ef = jax.jit(fn)(grads, ef)
        return jax.tree_util.tree_map(np.asarray, out), jax.tree_util.tree_map(np.asarray, ef)

    def g(t):
        out = strat(jax.tree_util.tree_map(lambda a: a[0], t))
        return jax.tree_util.tree_map(lambda a: a[None], out)

    fn = jax.shard_map(g, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
                       check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(grads)), ()


_PORT: dict = {}


@pytest.fixture
def port_results(monkeypatch):
    """Every strategy case at n ranks, run once per n for the module."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def get(n):
        if n not in _PORT:
            _PORT[n] = spawn_ranks(torch_rank_fns.strategies_rank, n,
                                   (_unstack(_grads(n), n), _unstack(_residuals(n), n)),
                                   device="cpu", timeout=240)
        return _PORT[n]

    return get


@pytest.mark.parametrize("case", list(STRATEGY_CASES))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_strategy_matches_reference(port_results, n, case):
    ranks = port_results(n)
    ref_out, ref_ef = _reference(n, case)
    for rank, res in enumerate(ranks):
        out, ef = res[case]
        got = jax.tree_util.tree_leaves(out)
        want = [a[rank] for a in jax.tree_util.tree_leaves(ref_out)]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.shape == b.shape
            if case in RING_FAMILY:
                np.testing.assert_array_equal(a, b, err_msg=f"{case} n={n} rank {rank}")
            elif case == "psum_bf16":
                np.testing.assert_allclose(a, b, rtol=0, atol=2 * 2.0 ** -8 * np.abs(b).max(),
                                           err_msg=f"{case} n={n} rank {rank}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{case} n={n} rank {rank}")
        if case.endswith(":ef"):
            # x = v + r per leaf; the residual x - Q(x) within 1 ulp of x
            xs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda g, r: g[rank] + r[rank], _grads(n), _residuals(n)))
            for a, b, x in zip(jax.tree_util.tree_leaves(ef),
                               jax.tree_util.tree_leaves(ref_ef), xs):
                np.testing.assert_allclose(a, b[rank], rtol=0,
                                           atol=2.0 ** -23 * np.abs(x).max())
        # replicas: every rank holds the same synced gradient
        for a, b in zip(got, jax.tree_util.tree_leaves(ranks[0][case][0])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,codec", [
    ("psum", None), ("psum", "int8"), ("psum", "int8:ef"), ("psum", "bf16:ef"),
    ("ring", "int8"), ("ring", "bf16"), ("ring", "int8:ef"), ("ring_int8", "int8"),
    ("asa16", "bf16"), ("psum_bf16", "int8"), ("nccl16", None), ("asa32", "int8"),
    ("ar", "int8:ef"), ("cudaaware", None), ("copper", None), ("fancy", None),
])
def test_aliases_and_refusals_match_the_reference(name, codec):
    """Every (strategy, codec) pair builds in both packages or is refused
    by both; built ones agree on being stateful (error feedback)."""
    try:
        ref = jst.get_strategy(name, "data", 4, codec=codec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tst.get_strategy(name, 4, codec=codec, layouts=default_layouts)
        assert str(got.value).split(";")[0].split(" —")[0] == str(e).split(";")[0].split(" —")[0]
        return
    port = tst.get_strategy(name, 4, codec=codec, layouts=default_layouts)
    assert getattr(port, "stateful", False) == getattr(ref, "stateful", False)


def test_unknown_strategy_with_a_codec_is_refused():
    """The reference builds an int8 RING for any unknown name paired with
    an active codec (``theanompi_tpu/parallel/strategies.py:820-828``
    assume every such pair is 'ring'); the port refuses the name."""
    with pytest.raises(ValueError, match="unknown exchange strategy 'fancy'"):
        tst.get_strategy("fancy", 4, codec="int8", layouts=default_layouts)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ranks_agree_only_on_what_they_share(port_results, n):
    """``assert_same_across_processes`` passes on a value every rank holds
    and raises on every rank for one that differs."""
    for res in port_results(n):
        assert res["_distributed"] == {"multiprocess": True, "caught_difference": True}


def test_initialize_distributed_from_the_reference_env_names(tmp_path, monkeypatch):
    """TMPI_COORDINATOR / TMPI_NUM_PROCESSES / TMPI_PROCESS_ID (the
    reference's names) bootstrap the group; nothing set is a no-op; a
    partial set is refused."""
    import torch.distributed as dist

    from theanompi_tpu_torch.parallel.distributed import initialize_distributed, is_multiprocess

    for k in ("TMPI_COORDINATOR", "TMPI_NUM_PROCESSES", "TMPI_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    monkeypatch.setenv("TMPI_NUM_PROCESSES", "1")
    with pytest.raises(ValueError, match="coordinator, num_processes AND process_id"):
        initialize_distributed()
    monkeypatch.setenv("TMPI_COORDINATOR", f"file://{tmp_path / 'rendezvous'}")
    monkeypatch.setenv("TMPI_PROCESS_ID", "0")
    try:
        assert initialize_distributed() is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert not is_multiprocess()
    finally:
        dist.destroy_process_group()


def test_hier_is_refused_until_ported():
    """hier is ported (tests/test_torch_hier.py); outside a multi-slice
    run it is refused, as the reference refuses it on a 1-D mesh."""
    with pytest.raises(ValueError, match="needs a multi-slice run"):
        tst.get_strategy("hier", 4, layouts=default_layouts)
    with pytest.raises(ValueError, match="needs a 2-axis"):
        jst.get_strategy("hier", "data", 4)


def _lm_grads(n, seed=2):
    """Per-rank LM gradient trees (the reference's layout, stacked [n, ...]):
    a 4-D ``qkv`` of 768 elements (six int8 blocks) with magnitudes that
    vary along every axis, so any other flat order changes the blocks'
    scales and the ring's segments."""
    r = np.random.RandomState(seed)

    def leaf(*shape):
        x = r.randn(n, *shape)
        for ax in range(1, x.ndim):
            x = x * np.exp(r.randn(*[s if i == ax else 1 for i, s in enumerate(x.shape)]))
        return x.astype(np.float32)

    return {
        "blocks": [{"qkv": leaf(16, 3, 2, 8), "proj": leaf(2, 8, 16), "mlp_in": leaf(16, 24),
                    "mlp_out": leaf(24, 16), "ln1": leaf(16), "ln2": leaf(16)}],
        "head": leaf(16, 20), "pos_emb": leaf(12, 16), "tok_emb": leaf(20, 16),
    }


_LM_PORT: dict = {}


@pytest.fixture
def lm_port_results(monkeypatch):
    """Every LM case on 2 gloo ranks, run once for the module."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if not _LM_PORT:
        n = 2
        grads = _lm_grads(n)
        res = jax.tree_util.tree_map(lambda a: a * 0.01, _lm_grads(n, seed=3))
        ranks = spawn_ranks(torch_rank_fns.lm_strategies_rank, n,
                            (_unstack(grads, n), _unstack(res, n)), device="cpu", timeout=240)
        _LM_PORT["run"] = (n, grads, res, ranks)
    return _LM_PORT["run"]


@pytest.mark.parametrize("case", list(LM_STRATEGY_CASES))
def test_lm_gradients_keep_their_layout_through_the_exchange(lm_port_results, case):
    """LM gradients, whose ``qkv`` is 4-D but no conv kernel, through the
    exchange as BSPEngine builds it (the model's layout tags) on 2 gloo
    ranks: the port keeps every leaf in the reference's shape, and the
    result matches the reference strategy on the 2-device mesh (ring_int8
    bit for bit; psum + int8:ef as ``test_strategy_matches_reference``)."""
    n, grads, res, ranks = lm_port_results
    ref_out, ref_ef = _reference(n, case, grads, res)
    ref_shapes = [a.shape[1:] for a in jax.tree_util.tree_leaves(grads)]
    for rank, got in enumerate(ranks):
        assert [tuple(s) for s in jax.tree_util.tree_leaves(
            got["_shapes"], is_leaf=lambda x: isinstance(x, tuple))] == ref_shapes
        out, ef = got[case]
        for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref_out)):
            if case == "ring_int8":
                np.testing.assert_array_equal(a, b[rank], err_msg=f"{case} rank {rank}")
            else:
                np.testing.assert_allclose(a, b[rank], rtol=1e-6, atol=1e-7,
                                           err_msg=f"{case} rank {rank}")
        if case.endswith(":ef"):
            xs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda g, r: g[rank] + r[rank], grads, res))
            for a, b, x in zip(jax.tree_util.tree_leaves(ef),
                               jax.tree_util.tree_leaves(ref_ef), xs):
                np.testing.assert_allclose(a, b[rank], rtol=0, atol=2.0 ** -23 * np.abs(x).max())
