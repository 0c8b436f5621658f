"""EASGD and GoSGD of the port on a model with BatchNorm, WRN-16-4 at
16x16 (no dropout), against the JAX package's engines, in single-rank
workers and in worker groups.

The port runs 2 workers as 2 gloo CPU ranks, or as 4 ranks in groups of
2 (``group_size=2``: the gradients' mean and the BN statistics over the
group's ``"data"`` axis, the exchange or round over the ``"worker"``
axis); the reference runs the same 2 workers on 2 devices of the
8-device CPU mesh, or on a 2x2 ``make_worker_group_mesh`` of 4 devices,
with ``bn_axis_name="data"`` when grouped, as its ``run_training``
sets. Both start from the reference's worker (params, BN statistics,
velocities; EASGD's center a copy) and read the same per-worker batches
(each rank of a group its half). 2 steps:

- EASGD with ``avg_freq=1``: two exchanges, each refreshing the center's
  BN statistics with the workers' mean; validation on the center.
- GoSGD with ``p_push=0.5`` and the reference's own draws, recovered as
  ``tests/test_gosgd.py`` recovers them and fed through the port's
  ``draws``: round 1 worker 0 pushes alone, round 2 worker 1 (one-way
  rounds, so the shares move); validation on the consensus with the
  workers' mean BN statistics.

Each rank's worker is held against the reference's stacked row, and
EASGD's center and its BN statistics against the reference's. The local
steps are not bit for bit (XLA and PyTorch sum the convolutions and the
BN statistics in other orders), and WRN-16-4 at these batches of 8 (4 a
rank in a group) amplifies such differences: the reference's own run
with every input one ulp up parts from it by 1.1e-2 to 1.4e-2 in the
params' and the center's change and 1.7e-2 to 2.8e-2 in the velocities
(computed in the test). So each compared quantity, a relative norm over
its whole stack (the params' change from the start, the velocities, the
BN statistics, the center's change and its BN statistics), must lie
within the larger of 1e-3 and twice that spread, as
``tests/test_torch_zoo.py`` holds WRN's trajectory. Read: the changes and
velocities at most 6.4e-3 (EASGD in groups), GoSGD's single-rank workers
5.3e-6, every BN statistic at most 1.7e-7 (limit 1e-3). The losses and
the validation metrics rtol 1e-4; GoSGD's shares exactly (dyadic: 1/4
and 3/4, then 5/8 and 3/8). Within a group the ranks agree bit
for bit. Each of these faults fails the test: BN and the
gradients' mean over all 4 ranks instead of the group (both grouped
cases), EASGD's center BN statistics a worker's own rather than the
workers' mean, GoSGD's validation on a worker's own BN statistics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from theanompi_tpu.models.model_zoo.wrn import WRN_16_4 as JWRN_16_4
from theanompi_tpu.parallel.easgd import EASGDEngine as JEASGD
from theanompi_tpu.parallel.gosgd import GOSGDEngine as JGOSGD
from theanompi_tpu.parallel.mesh import put_global_batch
from theanompi_tpu_torch.launch.session import spawn_ranks

import torch_rule_rank_fns

WORKERS = 2
PER = 8  # the per-worker batch
STEPS = 2
RECIPE = {"batch_size": PER, "input_shape": (16, 16, 3),
          "sched_kwargs": {"lr": 0.05, "boundaries": [10 ** 9]}}
# GoSGD's step keys: worker 0 pushes alone in the first round, worker 1
# in the second (the reference's draws at p = 0.5)
GOSSIP_KEYS = (42, 54)
KW = {"easgd": {"avg_freq": 1}, "gosgd": {"p_push": 0.5}}
# the limits' floor: each quantity's limit is the larger of this and
# twice the reference's own spread when every input moves one ulp
FLOOR = 1e-3


def _batches(seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(WORKERS * PER, 16, 16, 3).astype(np.float32),
             r.randint(0, 10, WORKERS * PER).astype(np.int32)) for _ in range(STEPS + 1)]


def _draws(rng, n, p):
    """The reference's shift and pushes of the round its step ``rng``
    draws (``gosgd.py``'s split / randint / fold_in / bernoulli)."""
    _, gossip_rng = jax.random.split(rng)
    hop_key, push_base = jax.random.split(gossip_rng)
    hop = int(jax.random.randint(hop_key, (), 1, n))
    return hop, [bool(jax.random.bernoulli(jax.random.fold_in(push_base, i), p))
                 for i in range(n)]


def _leaves(tree):
    return [np.asarray(a, dtype=np.float64) for a in jax.tree_util.tree_leaves(tree)]


def _rel(got, want) -> float:
    """Relative norm of ``got - want`` over a whole list of leaves."""
    num = sum(np.sum((a - b) ** 2) for a, b in zip(got, want))
    return float(np.sqrt(num / sum(np.sum(b ** 2) for b in want)))


def _reference(rule, group_size, ulp=False):
    """The reference's 2 steps -> the worker's first row at the start,
    its losses, its validation metrics and its final state (numpy);
    ``ulp``: every input one ulp up."""
    recipe = JWRN_16_4.default_recipe().replace(
        **RECIPE, bn_axis_name="data" if group_size > 1 else None)
    mesh = Mesh(np.array(jax.devices()[:WORKERS * group_size]), ("data",))
    if rule == "easgd":
        eng = JEASGD(JWRN_16_4(recipe), mesh, group_size=group_size, **KW[rule])
        keys = [jax.random.PRNGKey(i) for i in range(STEPS)]
    else:
        eng = JGOSGD(JWRN_16_4(recipe), mesh, group_size=group_size, **KW[rule])
        keys = [jax.random.PRNGKey(k) for k in GOSSIP_KEYS]
    state = eng.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], state.workers)
    *batches, val = _batches()
    if ulp:
        batches = [(np.nextafter(x, np.float32(np.inf)), y) for x, y in batches]
    put = lambda a: put_global_batch(eng.mesh, jnp.asarray(a))  # noqa: E731
    losses = []
    for (x, y), key in zip(batches, keys):
        state, m = eng.train_step(state, put(x), put(y), key)
        losses.append(float(m["loss"]))
        if rule == "easgd":
            state = eng.exchange(state)
    val = {k: float(v) for k, v in eng.eval_step(state, put(val[0]), put(val[1])).items()}
    return row0, losses, val, jax.tree_util.tree_map(np.asarray, state)


def _quantities(rule, p0, worker, center=None):
    """The compared quantities of one worker (and EASGD's center), each a
    list of float64 leaves: ``worker`` / ``center`` as
    ``{params, vel, stats}`` / ``{params, stats}``."""
    out = {"params' change": [a - b for a, b in zip(_leaves(worker["params"]), p0)],
           "velocities": _leaves(worker["vel"]), "BN statistics": _leaves(worker["stats"])}
    if rule == "easgd":
        out["center's change"] = [a - b for a, b in zip(_leaves(center["params"]), p0)]
        out["center's BN statistics"] = _leaves(center["stats"])
    return out


def _ref_quantities(rule, p0, state, w):
    row = lambda t: [a[w] for a in _leaves(t)]  # noqa: E731
    center = ({"params": state.center_params, "stats": state.center_model_state}
              if rule == "easgd" else None)
    return _quantities(rule, p0, {"params": row(state.workers.params),
                                  "vel": row(state.workers.opt_state),
                                  "stats": row(state.workers.model_state)}, center)


@pytest.mark.parametrize("group_size", [1, 2])
@pytest.mark.parametrize("rule", ["easgd", "gosgd"])
def test_workers_with_batchnorm_match_the_reference(monkeypatch, rule, group_size):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = WORKERS * group_size
    rounds = None
    if rule == "gosgd":
        rounds = [_draws(jax.random.PRNGKey(k), WORKERS, 0.5) for k in GOSSIP_KEYS]
        assert [push for _, push in rounds] == [[True, False], [False, True]]
    row0, jlosses, jval, ref = _reference(rule, group_size)
    _, _, _, ref_ulp = _reference(rule, group_size, ulp=True)
    p0 = _leaves(row0.params)
    *batches, val = _batches()
    ranks = spawn_ranks(torch_rule_rank_fns.wrn_rule_rank, n,
                        (rule, group_size, (row0.params, row0.model_state, row0.opt_state),
                         batches, val, RECIPE, KW[rule], rounds), device="cpu", timeout=300)
    worst, spread = {}, {}
    for w in range(WORKERS):
        want = _ref_quantities(rule, p0, ref, w)
        for key, v in _ref_quantities(rule, p0, ref_ulp, w).items():
            spread[key] = max(spread.get(key, 0.0), _rel(v, want[key]))
    for r, res in enumerate(ranks):
        w = r // group_size
        assert res["comm_rounds"] == STEPS
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4, err_msg=f"rank {r}")
        for k, v in jval.items():
            np.testing.assert_allclose(res["val"][k], v, rtol=1e-4, err_msg=f"rank {r} val {k}")
        want = _ref_quantities(rule, p0, ref, w)
        got = _quantities(rule, p0, res, {"params": res.get("center"),
                                          "stats": res.get("center_stats")})
        for key, v in got.items():
            worst[key] = max(worst.get(key, 0.0), _rel(v, want[key]))
        if rule == "gosgd":
            assert res["alpha"] == ref.alpha[w], (r, res["alpha"], ref.alpha)
    limits = {k: max(FLOOR, 2 * v) for k, v in spread.items()}
    print(f"[{rule}, groups of {group_size}] relative norms against the reference {worst}; "
          f"the reference's own one-ulp spread {spread}")
    assert all(worst[k] < limits[k] for k in worst), (worst, limits)
    if rule == "gosgd":  # round 1: worker 0 pushes 1/4; round 2: worker 1 pushes 3/8
        assert ref.alpha.tolist() == [0.625, 0.375]
    # the BN statistics moved, and the two workers differ
    assert _rel(_leaves(ranks[0]["stats"]), _leaves(row0.model_state)) > 1e-2
    assert not np.array_equal(_leaves(ranks[0]["stats"])[0], _leaves(ranks[-1]["stats"])[0])
    # within a group the ranks agree bit for bit
    for r in range(0, n, group_size):
        for q in range(r + 1, r + group_size):
            for key in ("params", "vel", "stats"):
                for a, b in zip(_leaves(ranks[r][key]), _leaves(ranks[q][key])):
                    np.testing.assert_array_equal(a, b, err_msg=f"ranks {r} {q} {key}")
