"""EASGD of the port (``parallel/easgd.py``) against the JAX package's
(``theanompi_tpu/parallel/easgd.py``), on 2 gloo CPU ranks, one worker a
rank; the reference on 2 devices of the 8-device CPU mesh.

1. Training: 4 steps of the MLP (momentum, no dropout) at a per-worker
   batch of 16 from the reference's weights and the same per-worker
   batches, exchanging after steps 2 and 4 (``avg_freq=2``), with no
   codec and with ``int8:ef``. Each rank's worker params, velocities and
   residual are held against the reference's stacked row, and the
   center against its center. The exchange's sum of two is independent
   of order, but the local steps are not bit for bit (XLA and PyTorch
   sum the dense products in other orders): losses rtol 1e-5, params,
   velocities and center rtol 1e-4 + atol 1e-6 (``tests/test_torch_bsp.py``'s
   limits). Under ``int8:ef`` an elastic difference may quantize one
   level apart where the two packages' inputs differ in their last
   bits (seen: 1 element of 98,304 one level apart); the center and the
   params are held within two quanta of the codec, 4 times the
   reference's largest residual (a residual is at most half a quantum),
   the residual in relative norm 5e-2.
2. The exchange alone from the same worker rows, center and residuals:
   at ``alpha = 0.25`` (a power of two: ``a·(w − c)`` is exact, so XLA's
   contraction of ``w − a·(w − c)`` and of ``a·(w − c) + r`` into fused
   multiply-adds rounds as the port's separate ops) with codec ``none``,
   ``int8`` and ``int8:ef``, bit for bit against the reference's
   exchange (worker and center; the residual ``x − q`` within 1 ulp of
   x, which XLA contracts into one fused multiply-add: ROADMAP §3, the
   codec's two references) and, without a codec, against the
   closed form ``w − a(w − c)``, ``c + Σ a(w − c)`` in numpy float32; at
   ``alpha = 0.3`` without a codec, bit for bit against the closed form
   and within 1 ulp of w against the reference (its fused multiply-add).
3. The loop: ``run_training(rule="easgd", device="cpu")`` on 2 ranks
   gives distinct worker digests and one center, the exchanges at every
   ``avg_freq``-th step, the per-worker batch semantics in the summary;
   ``steps_per_dispatch=3`` equals the per-step run bit for bit; an
   interrupted and resumed run equals an uninterrupted one bit for bit;
   the CLI trains ``EASGD 2``; ``bsp`` refuses the rule options and
   EASGD a strategy other than psum.
4. The checkpoint: a file the port writes loads in the reference's
   ``load_checkpoint`` for its ``EASGDState`` leaf for leaf, and a file
   the reference writes restores on the port's ranks; another worker
   count is refused by name.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from theanompi_tpu.models.mlp import MLP as JMLP
from theanompi_tpu.parallel.easgd import EASGDEngine as JEASGD
from theanompi_tpu.parallel.mesh import put_global_batch
from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch.launch.session import spawn_ranks

import torch_rule_rank_fns

N = 2
PER = 16
STEPS = 4
AVG = 2
MLP = ("theanompi_tpu_torch.models.mlp", "MLP")


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("data",))


def _batches(steps=STEPS, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(N * PER, 16, 16, 3).astype(np.float32),
             r.randint(0, 10, N * PER).astype(np.int32)) for _ in range(steps)]


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _reference(codec):
    mesh = _mesh()
    eng = JEASGD(JMLP(JMLP.default_recipe().replace(batch_size=PER)), mesh, avg_freq=AVG,
                 wire_codec=codec)
    state = eng.init_state(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], state.workers)
    losses = []
    for i, (x, y) in enumerate(_batches(), 1):
        state, m = eng.train_step(state, put_global_batch(mesh, jnp.asarray(x)),
                                  put_global_batch(mesh, jnp.asarray(y)), jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        if i % AVG == 0:
            state = eng.exchange(state)
    return init, losses, jax.tree_util.tree_map(np.asarray, state)


_RUNS: dict = {}


def _port(codec, init):
    if codec not in _RUNS:
        _RUNS[codec] = spawn_ranks(
            torch_rule_rank_fns.easgd_rank, N,
            (init.params, init.opt_state, _batches(), AVG, codec), device="cpu", timeout=240)
    return _RUNS[codec]


@pytest.mark.parametrize("codec", [None, "int8:ef"])
def test_two_workers_match_the_reference(monkeypatch, codec):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    init, jlosses, jstate = _reference(codec)
    ranks = _port(codec, init)
    # int8:ef: two quanta, 4x the reference's largest residual
    atol = 1e-6 if codec is None else 4 * max(np.abs(e).max() for e in _leaves(jstate.ef))
    for r, res in enumerate(ranks):
        assert res["step"] == STEPS and res["exchanges"] == STEPS // AVG
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, err_msg=f"rank {r}")
        for name, got, want in (("params", res["params"], jstate.workers.params),
                                ("vel", res["vel"], jstate.workers.opt_state),
                                ("center", res["center"], jstate.center_params)):
            for a, b in zip(_leaves(got), _leaves(want)):
                b = b if name == "center" else b[r]
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol,
                                           err_msg=f"{codec} {name} rank {r}")
        if codec == "int8:ef":
            for a, b in zip(_leaves(res["ef"]), _leaves(jstate.ef)):
                assert np.any(a != 0)
                rel = np.linalg.norm(a - b[r]) / np.linalg.norm(b[r])
                assert rel < 5e-2, (r, rel)
    # workers differ, the center is one
    assert not np.array_equal(_leaves(ranks[0]["params"])[0], _leaves(ranks[1]["params"])[0])
    for a, b in zip(_leaves(ranks[0]["center"]), _leaves(ranks[1]["center"])):
        np.testing.assert_array_equal(a, b)


def _exchange_inputs():
    """Worker rows, center and residual rows of the MLP's tree, drawn
    with numpy."""
    r = np.random.RandomState(7)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, JMLP(JMLP.default_recipe()).init(jax.random.PRNGKey(0))[0])
    draw = lambda scale: jax.tree_util.tree_map(  # noqa: E731
        lambda s: (scale * r.randn(*s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    rows = [draw(0.1) for _ in range(N)]
    return rows, draw(0.1), [draw(1e-3) for _ in range(N)]


@pytest.mark.parametrize("codec,alpha", [("none", 0.25), ("int8", 0.25), ("int8:ef", 0.25),
                                         ("none", 0.3)])
def test_the_exchange_matches_the_closed_form_and_the_reference(monkeypatch, codec, alpha):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows, center, efs = _exchange_inputs()
    use_ef = codec == "int8:ef"
    ranks = spawn_ranks(torch_rule_rank_fns.easgd_exchange_rank, N,
                        (rows, center, efs if use_ef else None, codec, alpha), device="cpu",
                        timeout=240)
    # the reference's exchange on the same stacked state
    mesh = _mesh()
    eng = JEASGD(JMLP(JMLP.default_recipe()), mesh, avg_freq=1, alpha=alpha, wire_codec=codec)
    tmpl = eng.init_state(jax.random.PRNGKey(0))
    stack = lambda trees: jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)  # noqa: E731
    state = tmpl._replace(
        workers=tmpl.workers._replace(params=stack(rows)), center_params=center,
        ef=stack(efs) if use_ef else tmpl.ef)
    out = jax.tree_util.tree_map(np.asarray,
                                 eng.exchange(jax.tree_util.tree_map(jnp.asarray, state)))
    a = np.float32(alpha)
    cl = _leaves(center)
    diffs = [[a * (w - c) for w, c in zip(_leaves(row), cl)] for row in rows]
    for r, res in enumerate(ranks):
        for i, (got, want, w) in enumerate(zip(_leaves(res["params"]),
                                               _leaves(out.workers.params),
                                               _leaves(rows[r]))):
            if codec == "none":  # the closed form, in numpy float32
                np.testing.assert_array_equal(got, w - diffs[r][i])
            # XLA contracts w - a*(w - c) into one fma: exact at a = 0.25
            ulp = float(np.spacing(np.abs(w).max())) if alpha != 0.25 else 0.0
            np.testing.assert_allclose(got, want[r], rtol=0, atol=ulp,
                                       err_msg=f"{codec} params rank {r} leaf {i}")
        for i, (got, want) in enumerate(zip(_leaves(res["center"]), _leaves(out.center_params))):
            if codec == "none":
                np.testing.assert_array_equal(got, cl[i] + (diffs[0][i] + diffs[1][i]))
            np.testing.assert_array_equal(got, want, err_msg=f"{codec} center leaf {i}")
        if use_ef:
            for i, (got, want) in enumerate(zip(_leaves(res["ef"]), _leaves(out.ef))):
                # XLA contracts x - q = x - vals*scale into one fma: 1 ulp of x
                x = diffs[r][i] + _leaves(efs[r])[i]
                np.testing.assert_allclose(got, want[r], rtol=0,
                                           atol=float(np.spacing(np.abs(x).max())),
                                           err_msg=f"residual rank {r} leaf {i}")
                assert np.any(got != 0)


def _training_runs(root):
    data = {"dataset": "synthetic", "dataset_kwargs": {"n_train": 192, "n_val": 64},
            "recipe_overrides": {"batch_size": PER}, "print_freq": 0, "seed": 3}
    easgd = dict(data, rule="easgd", avg_freq=2, wire_codec="int8:ef")
    ck = lambda name: os.path.join(root, name)  # noqa: E731
    return [
        ("eager", *MLP, dict(easgd, max_steps=7, ckpt_dir=ck("eager"), async_checkpoint=False)),
        ("grouped", *MLP, dict(easgd, max_steps=7, steps_per_dispatch=3, ckpt_dir=ck("grouped"),
                               async_checkpoint=False)),
        ("cut", *MLP, dict(easgd, max_steps=3, ckpt_dir=ck("resumed"), async_checkpoint=False)),
        ("resumed", *MLP, dict(easgd, max_steps=7, ckpt_dir=ck("resumed"), resume=True,
                               async_checkpoint=False)),
        ("bsp-kwargs", *MLP, dict(data, rule="bsp", avg_freq=4, expect_error=True)),
        ("strategy", *MLP, dict(easgd, strategy="ring", expect_error=True)),
        ("unknown", *MLP, dict(easgd, p_push=0.5, expect_error=True)),
    ]


@pytest.fixture(scope="module")
def loop_results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("easgd"))
    os.environ["OMP_NUM_THREADS"] = "1"
    res = spawn_ranks(torch_rule_rank_fns.training_rank, N, (_training_runs(root),),
                      device="cpu", timeout=300)[0]
    return root, res


def _newest(d):
    return max(glob.glob(os.path.join(d, "ckpt_*.npz")),
               key=lambda p: int(p.rsplit("_", 1)[1][:-4]))


def test_the_loop_runs_workers_and_exchanges(loop_results):
    _, res = loop_results
    s = res["eager"]
    # 192 examples / a global batch of 2 x 16 = 6 steps an epoch; 7 steps
    assert s["rule"] == "easgd" and s["n_workers"] == N and s["group_size"] == 1
    assert s["per_worker_batch"] == PER and s["global_batch"] == N * PER
    assert s["steps"] == 7 and s["avg_freq"] == 2 and s["alpha"] == pytest.approx(0.45)
    assert s["comm_rounds_per_rank"] == [3, 3]
    assert len(set(s["worker_digest_per_rank"])) == N
    assert len(set(s["center_digest_per_rank"])) == 1
    assert len(set(s["ef_digest_per_rank"])) == N and all(v > 0 for v in s["ef_norm_per_rank"])
    assert all(t > 0 for t in s["comm_ms_per_rank"] + s["local_step_ms_per_rank"])
    assert all(np.isfinite(s["losses"])) and np.isfinite(s["val"]["loss"])


def test_step_groups_and_resume_equal_the_per_step_run(loop_results):
    root, res = loop_results
    eager, grouped, resumed = res["eager"], res["grouped"], res["resumed"]
    assert grouped["steps_per_dispatch"] == 3 and grouped["comm_rounds_per_rank"] == [3, 3]
    assert resumed["resumed_from_step"] == 3
    assert res["cut"]["losses"] + resumed["losses"] == eager["losses"]
    for key in ("losses", "worker_digest_per_rank", "center_digest_per_rank",
                "ef_digest_per_rank"):
        assert grouped[key] == eager[key], key
        if key != "losses":
            assert resumed[key] == eager[key], key
    files = [np.load(_newest(os.path.join(root, d))) for d in ("eager", "grouped", "resumed")]
    keys = sorted(files[0].files)
    assert all(sorted(f.files) == keys for f in files)
    for k in keys:
        if k != "__integrity__":
            for f in files[1:]:
                np.testing.assert_array_equal(f[k], files[0][k], err_msg=k)


def test_the_loop_refuses_what_the_reference_refuses(loop_results):
    _, res = loop_results
    assert "apply to EASGD/GoSGD only" in res["bsp-kwargs"]
    assert "BSP rule only" in res["strategy"]
    assert "unexpected options ['p_push']" in res["unknown"]


def test_a_port_checkpoint_loads_in_the_reference(loop_results):
    root, _ = loop_results
    path = _newest(os.path.join(root, "eager"))
    eng = JEASGD(JMLP(JMLP.default_recipe()), _mesh(), avg_freq=2, wire_codec="int8:ef")
    tmpl = eng.init_state(jax.random.PRNGKey(0))
    restored, _ = jckpt.load_checkpoint(path, tmpl)
    flat = np.load(path)
    assert {k for k in flat.files if not k.startswith("__")} == set(
        jckpt._flatten_with_paths(tmpl))
    for key, leaf in jckpt._flatten_with_paths(restored).items():
        np.testing.assert_array_equal(leaf, flat[key], err_msg=key)
    assert int(np.asarray(restored.workers.step)[0]) == 7
    # the center and the workers' rows as the run left them
    ranks = spawn_ranks(torch_rule_rank_fns.restore_rank, N,
                        ("easgd", path, {"wire_codec": "int8:ef", "avg_freq": 2}), device="cpu",
                        timeout=240)
    for r, res in enumerate(ranks):
        assert res["step"] == 7
        for a, b in zip(_leaves(res["params"]), _leaves(restored.workers.params)):
            np.testing.assert_array_equal(a, np.asarray(b)[r])
        for a, b in zip(_leaves(res["ef"]), _leaves(restored.ef)):
            np.testing.assert_array_equal(a, np.asarray(b)[r])
        for a, b in zip(_leaves(res["center"]), _leaves(restored.center_params)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_a_reference_checkpoint_restores_on_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    mesh = _mesh()
    eng = JEASGD(JMLP(JMLP.default_recipe().replace(batch_size=PER)), mesh, avg_freq=1,
                 wire_codec="int8:ef")
    state = eng.init_state(jax.random.PRNGKey(0))
    x, y = _batches(1)[0]
    state, _ = eng.train_step(state, put_global_batch(mesh, jnp.asarray(x)),
                              put_global_batch(mesh, jnp.asarray(y)), jax.random.PRNGKey(1))
    state = eng.exchange(state)
    path = jckpt.save_checkpoint(str(tmp_path), state, 1)
    ranks = spawn_ranks(torch_rule_rank_fns.restore_rank, N,
                        ("easgd", path, {"wire_codec": "int8:ef"}), device="cpu", timeout=240)
    st = jax.tree_util.tree_map(np.asarray, state)
    for r, res in enumerate(ranks):
        assert res["step"] == 1
        for got, want in ((res["params"], st.workers.params), (res["vel"], st.workers.opt_state),
                          (res["ef"], st.ef)):
            for a, b in zip(_leaves(got), _leaves(want)):
                np.testing.assert_array_equal(a, b[r])
        for a, b in zip(_leaves(res["center"]), _leaves(st.center_params)):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(_leaves(ranks[0]["params"])[0], _leaves(ranks[1]["params"])[0])
    # a file of another worker count is refused by name
    with pytest.raises(RuntimeError, match=r"'\.workers/\.params/01_fc1/b' stacks 2 workers; "
                                           r"this run has 4"):
        spawn_ranks(torch_rule_rank_fns.restore_rank, 4, ("easgd", path, {}), device="cpu",
                    timeout=240)


def test_the_cli_trains_easgd_and_refuses_bsp_options(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    base = [sys.executable, "-m", "theanompi_tpu_torch.cli"]
    args = [*MLP, "--synthetic", "--device", "cpu", "--max-steps", "4", "--batch-size", "8",
            "--dataset-arg", "n_train=64", "--dataset-arg", "n_val=16", "--print-freq", "0"]
    out = subprocess.run([*base, "EASGD", "2", *args, "--avg-freq", "2", "--alpha", "0.25"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    s = json.loads(out.stdout.strip().splitlines()[-1])
    assert s["rule"] == "easgd" and s["alpha"] == 0.25 and s["comm_rounds_per_rank"] == [2, 2]
    assert s["global_batch"] == 16 and len(set(s["worker_digest_per_rank"])) == 2
    bad = subprocess.run([*base, "BSP", "2", *args, "--avg-freq", "2"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert bad.returncode != 0 and "apply to EASGD/GoSGD only" in bad.stderr
