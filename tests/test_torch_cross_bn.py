"""Cross-replica BatchNorm of the port (``nn/layers.py::BatchNorm`` with
an ``axis_name``, ``parallel/mesh.py``'s axis groups and ``pmean``)
against the JAX package's, which averages the batch statistics with
``lax.pmean`` inside ``shard_map`` (classic AD: the transpose of the
``psum`` is a ``psum``).

1. The layer alone in training on 2 and 4 gloo ranks (fp32; bf16 on 2)
   against the reference's on a ``("data",)`` mesh: outputs, new
   statistics, and the gradients of ``sum(y * ct)`` with respect to x,
   scale and bias, which reach every rank's input through the averaged
   statistics. Under ``--slices 2`` on 4 ranks, ``"data"`` averages
   within a slice only, ``"dcn"`` across slices and ``("dcn", "data")``
   over the world, each against the reference on
   ``make_multislice_mesh(4, 2)``. Limits: fp32 outputs and statistics
   rtol 1e-5 + atol 1e-6 (PyTorch and XLA sum the batch in other
   orders), gradients rtol 1e-4 + atol 1e-5 of the largest (the x
   gradient is a difference of two such sums); bf16 outputs and x
   gradients within 2 bf16 ulps of the largest value (a statistic one
   fp32 ulp off can move a bf16 rounding), statistics rtol 1e-3, and the
   scale and bias gradients, sums of bf16 products that each package
   rounds at its own points, in relative norm 1e-1 as
   ``tests/test_torch_zoo_layers.py`` holds ResNet-50's bf16 BN (read:
   3.0e-2 at worst).
2. An unknown axis name raises ``NameError`` on every rank, and one rank
   outside a bound run raises ``NameError`` as the reference's
   unbound ``pmean`` does.
3. Two steps of WRN-16-4 with ``bn_axis_name="data"`` on 2 gloo ranks
   against the reference's 2-device ``BSPEngine``, at the limits of
   ``tests/test_torch_zoo_state.py``'s 2-rank WRN test (losses rtol
   1e-5; params' change, velocities and statistics in relative norm
   1e-1), replicas bit-identical, and statistics that differ from a run
   without the axis (the mechanism is on).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.model_zoo.wrn import WRN_16_4 as JWRN_16_4
from theanompi_tpu.nn.layers import BatchNorm as JBatchNorm
from theanompi_tpu.parallel.bsp import BSPEngine as JBSPEngine
from theanompi_tpu.parallel.mesh import make_multislice_mesh
from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.nn.layers import BatchNorm

import torch_exchange_rank_fns
import torch_zoo_rank_fns

B, H, W, C = 3, 4, 4, 5  # a rank's rows


def _case(n, axis, slices=None, dtype="float32", seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(n, B, H, W, C) * 2 + r.randn(n, 1, 1, 1, C)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return {"axis": axis, "slices": slices, "dtype": dtype, "x": x,
            "ct": r.randn(n, B, H, W, C).astype(np.float32),
            "params": {"scale": (1 + 0.1 * r.randn(C)).astype(np.float32),
                       "bias": (0.1 * r.randn(C)).astype(np.float32)},
            "state": {"mean": (0.1 * r.randn(C)).astype(np.float32),
                      "var": (1 + 0.1 * r.rand(C)).astype(np.float32)}}


def _reference(case):
    """The reference's layer on the case's mesh -> per-device outputs."""
    n = case["x"].shape[0]
    if case["slices"]:
        mesh, axes = make_multislice_mesh(n, n_slices=case["slices"]), ("dcn", "data")
    else:
        mesh, axes = Mesh(np.array(jax.devices()[:n]), ("data",)), "data"
    axis = tuple(case["axis"]) if isinstance(case["axis"], list) else case["axis"]
    bn = JBatchNorm(axis_name=axis)
    dtype = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    state = jax.tree_util.tree_map(jnp.asarray, case["state"])

    def local(x, ct, params):
        def loss(x, params):
            y, new = bn.apply(params, state, x, train=True)
            return jnp.sum(y.astype(jnp.float32) * ct), (y, new)

        (_, (y, new)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            x, params)
        return (y.astype(jnp.float32), gx.astype(jnp.float32), new["mean"][None],
                new["var"][None], gp["scale"][None], gp["bias"][None])

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(axes), P(axes), P()),
                       out_specs=(P(axes),) * 6, check_vma=False)
    x = jnp.asarray(case["x"].reshape(n * B, H, W, C), dtype)
    ct = jnp.asarray(case["ct"].reshape(n * B, H, W, C))
    y, gx, mean, var, gs, gb = (np.asarray(a) for a in jax.jit(fn)(x, ct, params))
    return {"y": y.reshape(n, B, H, W, C), "gx": gx.reshape(n, B, H, W, C), "mean": mean,
            "var": var, "gscale": gs, "gbias": gb}


CASES = {
    2: [_case(2, "data"), _case(2, "data", dtype="bfloat16", seed=1)],
    4: [_case(4, "data", seed=2), _case(4, "data", slices=2, seed=3),
        _case(4, "dcn", slices=2, seed=4), _case(4, ["dcn", "data"], slices=2, seed=5)],
}
_PORT: dict = {}


@pytest.fixture
def bn_results(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def get(n):
        if n not in _PORT:
            _PORT[n] = spawn_ranks(torch_exchange_rank_fns.bn_rank, n, (CASES[n],),
                                   device="cpu", timeout=240)
        return _PORT[n]

    return get


def _label(case):
    return f"{case['axis']}/{case['slices']} slices/{case['dtype']}"


@pytest.mark.parametrize("n,i", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)],
                         ids=["2-data", "2-data-bf16", "4-data", "4-slices-data",
                              "4-slices-dcn", "4-slices-world"])
def test_cross_replica_batchnorm_matches_the_reference(bn_results, n, i):
    case = CASES[n][i]
    ref = _reference(case)
    bf16 = case["dtype"] == "bfloat16"
    for rank, res in enumerate(bn_results(n)):
        got = res["cases"][i]
        msg = f"{_label(case)} rank {rank}"
        for key in ("y", "gx"):
            want = ref[key][rank]
            if bf16:
                np.testing.assert_allclose(got[key], want, rtol=0,
                                           atol=2 * 2.0 ** -8 * np.abs(want).max(), err_msg=msg)
            elif key == "y":
                np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-6, err_msg=msg)
            else:
                np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                           atol=1e-5 * np.abs(want).max(), err_msg=msg)
        for key in ("mean", "var"):
            np.testing.assert_allclose(got[key], ref[key][rank], rtol=1e-3 if bf16 else 1e-5,
                                       atol=1e-6, err_msg=f"{key} {msg}")
        for key in ("gscale", "gbias"):
            want = ref[key][rank]
            if bf16:
                rel = np.linalg.norm(got[key] - want) / np.linalg.norm(want)
                assert rel < 1e-1, (key, msg, rel)
            else:
                np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                           atol=1e-5 * np.abs(want).max(), err_msg=f"{key} {msg}")


def test_the_data_axis_under_slices_averages_within_a_slice(bn_results):
    """Under ``--slices 2`` the two ranks of a slice share their
    statistics, which differ from the other slice's; across slices
    (``dcn``) ranks 0 and 2 share theirs; over the world all four."""
    ranks = bn_results(4)
    data, dcn, world = (np.stack([r["cases"][i]["mean"] for r in ranks]) for i in (1, 2, 3))
    np.testing.assert_array_equal(data[0], data[1])
    np.testing.assert_array_equal(data[2], data[3])
    assert not np.array_equal(data[0], data[2])
    np.testing.assert_array_equal(dcn[0], dcn[2])
    np.testing.assert_array_equal(dcn[1], dcn[3])
    assert not np.array_equal(dcn[0], dcn[1])
    for r in range(1, 4):
        np.testing.assert_array_equal(world[r], world[0])


def test_an_unknown_or_unbound_axis_name_raises(bn_results):
    for res in bn_results(2) + bn_results(4):
        assert res["unknown"].startswith("unknown mesh axis name 'model'")
    # one rank: the axis is unbound, in the reference as in the port
    case = _case(1, "data")
    bn, jbn = BatchNorm(axis_name="data"), JBatchNorm(axis_name="data")
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    state = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    with pytest.raises(NameError, match="unbound axis name"):
        bn.apply(params, state, torch.from_numpy(case["x"][0]), train=True)
    with pytest.raises(NameError, match="unbound axis name"):
        jax.jit(lambda x: jbn.apply(case["params"], case["state"], x, train=True))(case["x"][0])
    # evaluation reads the running statistics: no collective, no name
    y, _ = bn.apply(params, state, torch.from_numpy(case["x"][0]), train=False)
    assert y.shape == (B, H, W, C)


SMALL = dict(batch_size=4, sched_kwargs={"lr": 0.01, "boundaries": [60, 120, 160],
                                         "factor": 0.2})


def _batches(n, batch=4):
    r = np.random.RandomState(0)
    return [(r.randn(batch, 32, 32, 3).astype(np.float32),
             r.randint(0, 10, batch).astype(np.int32)) for _ in range(n)]


def test_two_steps_of_wrn_with_cross_replica_bn_match_the_reference(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPI_PALLAS", "0")
    kw = dict(SMALL, bn_axis_name="data")
    jm = JWRN_16_4(JWRN_16_4.default_recipe().replace(**kw))
    engine = JBSPEngine(jm, Mesh(np.array(jax.devices()[:2]), ("data",)), strategy="psum",
                        fused_update=True)
    jstate = engine.init_state(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    batches = _batches(2)
    args = (np_state.params, np_state.model_state, np_state.opt_state, batches)
    ranks = spawn_ranks(torch_zoo_rank_fns.wrn_bsp_rank, 2, (*args, kw), device="cpu",
                        timeout=240)
    per_replica = spawn_ranks(torch_zoo_rank_fns.wrn_bsp_rank, 2, (*args, SMALL),
                              device="cpu", timeout=240)
    jlosses = []
    for x, y in batches:
        jstate, m = engine.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(1))
        jlosses.append(float(m["loss"]))
    jstats = [np.asarray(s) for s in jax.tree_util.tree_leaves(jstate.model_state)]

    def rel_norm(got, want):
        return max(float(np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b)))
                   for a, b in zip(got, want))

    p0 = jax.tree_util.tree_leaves(np_state.params)
    for rank, res in enumerate(ranks):
        assert res["step"] == 2
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, err_msg=f"rank {rank}")
        change = rel_norm([a - c for a, c in zip(jax.tree_util.tree_leaves(res["params"]), p0)],
                          [np.asarray(b) - c for b, c in
                           zip(jax.tree_util.tree_leaves(jstate.params), p0)])
        vel = rel_norm(jax.tree_util.tree_leaves(res["vel"]),
                       jax.tree_util.tree_leaves(jstate.opt_state))
        stats = rel_norm(res["stats"], jstats)
        print(f"[rank {rank}] losses {res['losses']} vs {jlosses}; params' change "
              f"{change:.3g}, velocities {vel:.3g}, BN stats {stats:.3g} in relative norm")
        assert change < 1e-1 and vel < 1e-1 and stats < 1e-1
        for key in ("params", "vel", "stats"):
            for a, b in zip(jax.tree_util.tree_leaves(res[key]),
                            jax.tree_util.tree_leaves(ranks[0][key])):
                np.testing.assert_array_equal(a, b)
    # the statistics of the second step differ from per-replica BN's
    assert not all(np.array_equal(a, b) for a, b in zip(ranks[0]["stats"],
                                                         per_replica[0]["stats"]))
    assert ranks[0]["losses"][1] != per_replica[0]["losses"][1]
