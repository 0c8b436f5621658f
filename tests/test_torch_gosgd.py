"""GoSGD of the port (``parallel/gosgd.py``) against the JAX package's
(``theanompi_tpu/parallel/gosgd.py``), on 2 or 4 gloo CPU ranks, one
worker a rank; the reference on the first devices of the 8-device CPU
mesh.

1. A gossip round: p = 0.9 on 4 workers whose params are the MLP's
   perturbed per worker, lr 0 (the local step leaves the params as they
   are, which isolates the gossip). The reference's draws are recovered
   as ``tests/test_gosgd.py`` recovers them (split, ``randint``,
   ``fold_in``, ``bernoulli``) and fed to the port's engine through its
   ``draws`` argument. Codec ``none``, 3 rounds: the shares bit for bit
   after every round; the params bit for bit after the first round,
   where every share is a power of two and the reference's fused
   multiply-add ``keep·w + recv`` rounds as the port's two ops, then
   within 4 ulps of their largest value (later shares such as 3/16 make
   the products inexact, and the fused and the separate rounding part).
   Codec ``int8``, one round: params and shares bit for bit (the port's
   block codec is the reference's, bit for bit: `tests/test_torch_quant_multi.py`).
2. ``sum(alpha) == 1`` after each of 8 rounds (p = 0.5, 4 workers, the
   port's own draws; rtol 1e-6); ``p = 0`` is pure local SGD (shares stay
   ``1/n``, the run equals one with no round, bit for bit; the workers
   part); one worker is the
   identity (no round runs, the share stays 1); ``gossip_every = 2``
   runs a round after every second step only.
3. The loop: ``run_training(rule="gosgd", device="cpu")`` on 2 ranks
   with ``int8:ef`` and ``p_push=1``: distinct worker digests, shares
   summing to 1, a round a step; ``steps_per_dispatch=3`` equals the
   per-step run bit for bit; an interrupted and resumed run equals an
   uninterrupted one bit for bit (its draw generators restored).
4. The checkpoint: a file the port writes loads in the reference's
   ``load_checkpoint`` for its ``GOSGDState`` leaf for leaf, and a file
   the reference writes restores on the port's ranks.
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from theanompi_tpu.models.mlp import MLP as JMLP
from theanompi_tpu.parallel.gosgd import GOSGDEngine as JGOSGD
from theanompi_tpu.parallel.mesh import put_global_batch
from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch.launch.session import spawn_ranks

import torch_rule_rank_fns

PER = 8
MLP = ("theanompi_tpu_torch.models.mlp", "MLP")


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _batches(n, steps, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(n * PER, 16, 16, 3).astype(np.float32),
             r.randint(0, 10, n * PER).astype(np.int32)) for _ in range(steps)]


def _draws(rng, n, p):
    """The reference's shift and pushes of the round its step ``rng``
    draws (``gosgd.py``'s split / randint / fold_in / bernoulli)."""
    _, gossip_rng = jax.random.split(rng)
    hop_key, push_base = jax.random.split(gossip_rng)
    hop = int(jax.random.randint(hop_key, (), 1, n))
    return hop, [bool(jax.random.bernoulli(jax.random.fold_in(push_base, i), p))
                 for i in range(n)]


@pytest.mark.parametrize("codec,rounds", [("none", 3), ("int8", 1)])
def test_gossip_rounds_match_the_reference(monkeypatch, codec, rounds):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n, p = 4, 0.9
    mesh = _mesh(n)
    model = JMLP(JMLP.default_recipe().replace(batch_size=PER, sched_kwargs={"lr": 0.0}))
    eng = JGOSGD(model, mesh, p_push=p, wire_codec=codec)
    state = eng.init_state(jax.random.PRNGKey(0))
    noise = np.random.RandomState(0)
    state = state._replace(workers=state.workers._replace(params=jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * noise.randn(*a.shape).astype(np.float32)),
        state.workers.params)))
    rows = [jax.tree_util.tree_map(lambda a: np.asarray(a)[i], state.workers.params)
            for i in range(n)]
    alphas = np.asarray(state.alpha).tolist()
    x, y = _batches(n, 1)[0]
    xg, yg = put_global_batch(mesh, jnp.asarray(x)), put_global_batch(mesh, jnp.asarray(y))
    keys = [jax.random.PRNGKey(42 + i) for i in range(rounds)]
    draws = [_draws(k, n, p) for k in keys]
    assert any(not all(push) for _, push in draws) or rounds == 1
    want = []
    for k in keys:
        state, _ = eng.train_step(state, xg, yg, k)
        want.append(jax.tree_util.tree_map(np.asarray, state))
    ranks = spawn_ranks(torch_rule_rank_fns.gosgd_round_rank, n,
                        (rows, alphas, codec, draws, (x, y)), device="cpu", timeout=240)
    for r, res in enumerate(ranks):
        assert res["comm_rounds"] == rounds
        for i, (got, ref) in enumerate(zip(res["rounds"], want)):
            assert got["alpha"] == ref.alpha[r], (r, i)
            for a, b in zip(_leaves(got["params"]), _leaves(ref.workers.params)):
                ulps = 0.0 if i == 0 else 4 * float(np.spacing(np.abs(b[r]).max()))
                np.testing.assert_allclose(a, b[r], rtol=0, atol=ulps,
                                           err_msg=f"{codec} rank {r} round {i}")
    for got in zip(*(res["rounds"] for res in ranks)):
        assert sum(g["alpha"] for g in got) == pytest.approx(1.0, rel=1e-6)


@pytest.fixture(scope="module")
def cadence():
    os.environ["OMP_NUM_THREADS"] = "1"
    out = {}
    out[4] = spawn_ranks(torch_rule_rank_fns.gosgd_cadence_rank, 4,
                         (_batches(4, 8), [{"p_push": 0.5}]), device="cpu", timeout=240)
    out[2] = spawn_ranks(torch_rule_rank_fns.gosgd_cadence_rank, 2,
                         (_batches(2, 3), [{"p_push": 0.0}, {"p_push": 1.0, "gossip_every": 2},
                                           {"p_push": 1.0}, {"p_push": 1.0, "gossip_every": 9}]),
                         device="cpu", timeout=240)
    return out


def test_shares_sum_to_one_after_every_round(cadence):
    ranks = cadence[4]
    assert all(r[0]["comm_rounds"] == 8 for r in ranks)
    per_round = list(zip(*(r[0]["alphas"] for r in ranks)))
    assert len(per_round) == 8
    for shares in per_round:
        assert sum(shares) == pytest.approx(1.0, rel=1e-6)
    assert any(s != 0.25 for shares in per_round for s in shares)  # the gossip moved them


def test_p_zero_is_local_sgd_and_gossip_every_skips_rounds(cadence):
    ranks = cadence[2]
    local, every2, every1, none = (tuple(r[i] for r in ranks) for i in range(4))
    # p = 0: every round runs (a zero share still travels, as the reference's
    # ppermute) and moves nothing: the run equals one with no round at all
    assert all(r["alphas"] == [0.5] * 3 and r["comm_rounds"] == 3 for r in local)
    assert all(r["comm_rounds"] == 0 for r in none)
    for a, b in zip(local, none):
        np.testing.assert_array_equal(a["w0"], b["w0"])
    assert not np.array_equal(local[0]["w0"], local[1]["w0"])  # distinct batches, workers part
    assert all(r["comm_rounds"] == 1 for r in every2)  # after step 2 of 3
    assert all(r["comm_rounds"] == 3 for r in every1)


def test_one_worker_is_the_identity():
    import torch

    from theanompi_tpu_torch.models.mlp import MLP as TMLP
    from theanompi_tpu_torch.parallel.gosgd import GOSGDEngine

    model = TMLP(TMLP.default_recipe().replace(batch_size=PER, sched_kwargs={"lr": 0.0}))
    eng = GOSGDEngine(model, 1, "cpu", p_push=1.0, gossip_every=2)
    state = eng.init_state(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in jax.tree_util.tree_leaves(state.worker.params)]
    x, y = _batches(1, 1)[0]
    for _ in range(3):
        state, m = eng.train_step(state, torch.from_numpy(x), torch.from_numpy(y), None)
    assert float(state.alpha) == 1.0 and eng.comm_rounds == 0 and eng.codec.name == "none"
    for a, b in zip(jax.tree_util.tree_leaves(state.worker.params), before):
        assert torch.equal(a, b)


def _training_runs(root):
    data = {"dataset": "synthetic", "dataset_kwargs": {"n_train": 96, "n_val": 32},
            "recipe_overrides": {"batch_size": PER}, "print_freq": 0, "seed": 5}
    gosgd = dict(data, rule="gosgd", p_push=1.0, wire_codec="int8:ef")
    ck = lambda name: os.path.join(root, name)  # noqa: E731
    return [
        ("eager", *MLP, dict(gosgd, max_steps=7, ckpt_dir=ck("eager"), async_checkpoint=False)),
        ("grouped", *MLP, dict(gosgd, max_steps=7, steps_per_dispatch=3, ckpt_dir=ck("grouped"),
                               async_checkpoint=False)),
        ("cut", *MLP, dict(gosgd, max_steps=3, ckpt_dir=ck("resumed"), async_checkpoint=False)),
        ("resumed", *MLP, dict(gosgd, max_steps=7, ckpt_dir=ck("resumed"), resume=True,
                               async_checkpoint=False)),
        ("half", *MLP, dict(gosgd, p_push=0.5, max_steps=4, print_freq=2)),
        ("alpha", *MLP, dict(gosgd, alpha=0.1, expect_error=True)),
    ]


@pytest.fixture(scope="module")
def loop_results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gosgd"))
    os.environ["OMP_NUM_THREADS"] = "1"
    res = spawn_ranks(torch_rule_rank_fns.training_rank, 2, (_training_runs(root),),
                      device="cpu", timeout=300)[0]
    return root, res


def _newest(d):
    return max(glob.glob(os.path.join(d, "ckpt_*.npz")),
               key=lambda p: int(p.rsplit("_", 1)[1][:-4]))


def test_the_loop_gossips_every_step(loop_results):
    _, res = loop_results
    s = res["eager"]
    assert s["rule"] == "gosgd" and s["n_workers"] == 2 and s["p_push"] == 1.0
    assert s["global_batch"] == 2 * PER and s["steps"] == 7
    assert s["comm_rounds_per_rank"] == [7, 7]
    assert sum(s["alpha_per_rank"]) == pytest.approx(1.0, rel=1e-6)
    assert len(set(s["worker_digest_per_rank"])) == 2
    assert len(set(s["ef_digest_per_rank"])) == 2 and all(v > 0 for v in s["ef_norm_per_rank"])
    assert all(np.isfinite(s["losses"])) and np.isfinite(s["val"]["loss"])
    half = res["half"]
    assert sum(half["alpha_per_rank"]) == pytest.approx(1.0, rel=1e-6)
    assert "unexpected options ['alpha']" in res["alpha"]


def test_step_groups_and_resume_equal_the_per_step_run(loop_results):
    root, res = loop_results
    eager, grouped, resumed = res["eager"], res["grouped"], res["resumed"]
    assert resumed["resumed_from_step"] == 3
    assert res["cut"]["losses"] + resumed["losses"] == eager["losses"]
    assert grouped["losses"] == eager["losses"]
    for key in ("worker_digest_per_rank", "alpha_per_rank", "ef_digest_per_rank"):
        assert grouped[key] == eager[key] == resumed[key], key
    files = [np.load(_newest(os.path.join(root, d))) for d in ("eager", "grouped", "resumed")]
    assert all(sorted(f.files) == sorted(files[0].files) for f in files)
    for k in files[0].files:
        if k != "__integrity__":
            for f in files[1:]:
                np.testing.assert_array_equal(f[k], files[0][k], err_msg=k)


def test_a_port_checkpoint_loads_in_the_reference(loop_results):
    root, _ = loop_results
    path = _newest(os.path.join(root, "eager"))
    eng = JGOSGD(JMLP(JMLP.default_recipe()), _mesh(2), p_push=1.0, wire_codec="int8:ef")
    tmpl = eng.init_state(jax.random.PRNGKey(0))
    restored, _ = jckpt.load_checkpoint(path, tmpl)
    flat = np.load(path)
    assert {k for k in flat.files if not k.startswith("__")} == set(
        jckpt._flatten_with_paths(tmpl))
    for key, leaf in jckpt._flatten_with_paths(restored).items():
        np.testing.assert_array_equal(leaf, flat[key], err_msg=key)
    assert np.asarray(restored.alpha).sum() == pytest.approx(1.0, rel=1e-6)
    ranks = spawn_ranks(torch_rule_rank_fns.restore_rank, 2,
                        ("gosgd", path, {"wire_codec": "int8:ef"}), device="cpu", timeout=240)
    for r, res in enumerate(ranks):
        assert res["step"] == 7 and res["alpha"] == np.asarray(restored.alpha)[r]
        np.testing.assert_array_equal(res["ef"], np.asarray(restored.ef)[r])
        for a, b in zip(_leaves(res["params"]), _leaves(restored.workers.params)):
            np.testing.assert_array_equal(a, np.asarray(b)[r])


def test_a_reference_checkpoint_restores_on_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    mesh = _mesh(2)
    eng = JGOSGD(JMLP(JMLP.default_recipe().replace(batch_size=PER)), mesh, p_push=1.0,
                 wire_codec="int8:ef")
    state = eng.init_state(jax.random.PRNGKey(0))
    x, y = _batches(2, 1)[0]
    state, _ = eng.train_step(state, put_global_batch(mesh, jnp.asarray(x)),
                              put_global_batch(mesh, jnp.asarray(y)), jax.random.PRNGKey(1))
    path = jckpt.save_checkpoint(str(tmp_path), state, 1)
    ranks = spawn_ranks(torch_rule_rank_fns.restore_rank, 2,
                        ("gosgd", path, {"wire_codec": "int8:ef"}), device="cpu", timeout=240)
    st = jax.tree_util.tree_map(np.asarray, state)
    for r, res in enumerate(ranks):
        assert res["step"] == 1 and res["alpha"] == st.alpha[r]
        np.testing.assert_array_equal(res["ef"], st.ef[r])
        for got, want in ((res["params"], st.workers.params), (res["vel"], st.workers.opt_state)):
            for a, b in zip(_leaves(got), _leaves(want)):
                np.testing.assert_array_equal(a, b[r])
