"""BatchNorm state through the step's paths that carry ``model_state``,
with WRN-16-4 (26 BN statistics), against the JAX package:

1. the checkpoint file (``bridge.state_to_flat`` / ``state_from_flat``,
   ``utils/checkpoint.py``): a port file loads in the reference and a
   reference file in the port, every BN mean and var bit for bit;
2. the captured step's write-back (``graphs.write_back``): the BN
   statistics a step returns land in the state's own tensors;
3. the ranks (``parallel/bsp.py``): 2 gloo ranks of WRN-16-4 against the
   reference's 2-device ``BSPEngine``, which averages the statistics
   across replicas after every step (``lax.pmean``) as the port does
   (``mean_across_ranks``). Limits: losses rtol 1e-5 (read: 8.7e-6 at
   worst); the params' change, the velocities and the BN statistics per
   leaf in relative norm 1e-1, GoogLeNet's trajectory limit (read: 2.4e-2,
   3.3e-2, 4.3e-5; the worst leaves are stage 0's BN scales and biases,
   whose gradients are sums over a rank's 2 x 32 x 32 positions that
   cancel to a small share of their terms; a one-ulp change of the
   reference's own input moves its params' change by 5.5e-3 and its
   velocities by 8.2e-3); every rank's params, velocities and statistics
   bit-identical.
"""

import pathlib
import shutil
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from theanompi_tpu.models.model_zoo.wrn import WRN_16_4 as JWRN_16_4
from theanompi_tpu.parallel.bsp import BSPEngine as JBSPEngine
from theanompi_tpu.train import init_train_state as j_init_state
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch import bridge, graphs
from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.models.model_zoo.wrn import WRN_16_4 as TWRN_16_4
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import make_train_step as t_train_step
from theanompi_tpu_torch.tree import tree_leaves
from theanompi_tpu_torch.utils import checkpoint as tckpt

import torch_zoo_rank_fns

# the recipe's schedule at lr 0.01: at 0.1 a batch of 4 moves the loss
# from 2.5 to 3.1 in one step, where rounding grows fastest
SMALL = dict(batch_size=4, sched_kwargs={"lr": 0.01, "boundaries": [60, 120, 160],
                                         "factor": 0.2})


@pytest.fixture
def scratch():
    d = tempfile.mkdtemp(prefix="tmpi-test-")
    try:
        yield pathlib.Path(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _batches(n, batch=4):
    r = np.random.RandomState(0)
    return [(r.randn(batch, 32, 32, 3).astype(np.float32),
             r.randint(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _trained_port_state(steps=2):
    """A port TrainState after ``steps`` eager steps: BN means and vars
    that are no longer the init's zeros and ones, Nesterov velocities."""
    tm = TWRN_16_4(TWRN_16_4.default_recipe().replace(**SMALL))
    state = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    step = t_train_step(tm, fused_update=True)
    for x, y in _batches(steps):
        state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y), None)
    return tm, state


def test_a_port_checkpoint_loads_in_the_reference_bn_stats_bit_for_bit(scratch):
    tm, state = _trained_port_state()
    stats = tree_leaves(state.model_state)
    assert len(stats) == 26 and not any(torch.equal(s, torch.zeros_like(s)) or
                                        torch.equal(s, torch.ones_like(s)) for s in stats)
    layouts = tm.param_layouts(state.params)
    path = tckpt.save_checkpoint(str(scratch), bridge.state_to_flat(state, layouts),
                                 int(state.step))
    assert jckpt.verify_checkpoint(path)
    jm = JWRN_16_4(JWRN_16_4.default_recipe().replace(**SMALL))
    restored, _ = jckpt.load_checkpoint(path, j_init_state(jm, jax.random.PRNGKey(0)))
    got = jax.tree_util.tree_leaves_with_path(restored.model_state)
    want = bridge._paths(state.model_state, "")
    assert [jax.tree_util.keystr(p, simple=True, separator="/") for p, _ in got] == \
        [k[1:] for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(restored.params),
                    jax.tree_util.tree_leaves(bridge.params_to_jax(state.params, layouts))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(restored.step) == 2


def test_a_reference_checkpoint_loads_in_the_port_bn_stats_bit_for_bit(scratch):
    jm = JWRN_16_4(JWRN_16_4.default_recipe().replace(**SMALL))
    jstate = j_init_state(jm, jax.random.PRNGKey(0))
    step = jax.jit(j_train_step(jm, fused_update=True))
    for x, y in _batches(2):
        jstate, _ = step(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
    path = jckpt.save_checkpoint(str(scratch), jstate, int(jstate.step),
                                 rng=jax.random.PRNGKey(3))
    tm = TWRN_16_4(TWRN_16_4.default_recipe().replace(**SMALL))
    template = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    layouts = tm.param_layouts(template.params)
    state = bridge.state_from_flat(tckpt.load_checkpoint(path), template, layouts)
    want = [np.asarray(s) for s in jax.tree_util.tree_leaves(jstate.model_state)]
    got = tree_leaves(state.model_state)
    assert len(got) == len(want) == 26
    for a, b, t in zip(got, want, tree_leaves(template.model_state)):
        assert a.dtype == t.dtype and not a.requires_grad
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tree_leaves(state.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        ref = bridge.tree_to_jax({"w": a}, {"w": "conv" if a.dim() == 4 else "plain"})["w"]
        np.testing.assert_array_equal(ref, np.asarray(b))
    vel = jax.tree_util.tree_leaves(bridge.tree_to_jax(state.opt_state,
                                                       {"vel": layouts}))
    for a, b in zip(vel, jax.tree_util.tree_leaves(jstate.opt_state)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_write_back_copies_the_bn_stats_a_step_returns():
    """What a captured step does with the state it returns: the step
    replaces every BN statistic with a new tensor (params and fused
    velocities are updated in place), and ``write_back`` copies each
    into the tensor the graph holds. The state's structure and the
    tensors' identity stay."""
    tm, state = _trained_port_state(steps=1)
    step = t_train_step(tm, fused_update=True)
    old = tree_leaves(state)
    held = list(old)
    before = [t.detach().clone() for t in tree_leaves(state.model_state)]
    x, y = _batches(1)[0]
    new_state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y), None)
    new = tree_leaves(new_state)
    stats_new = tree_leaves(new_state.model_state)
    assert all(a is b for a, b in zip(tree_leaves(new_state.params), tree_leaves(state.params)))
    assert not any(a is b for a, b in zip(stats_new, tree_leaves(state.model_state)))
    assert not any(torch.equal(a, b) for a, b in zip(stats_new, before))
    with torch.no_grad():
        graphs.write_back(old, new)
    assert all(a is b for a, b in zip(old, held))
    for a, b in zip(tree_leaves(state.model_state), stats_new):
        assert torch.equal(a, b)
    assert int(state.step) == int(new_state.step) == 2


def test_two_rank_bsp_matches_the_reference_with_averaged_bn_stats(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPI_PALLAS", "0")
    jm = JWRN_16_4(JWRN_16_4.default_recipe().replace(**SMALL))
    engine = JBSPEngine(jm, Mesh(np.array(jax.devices()[:2]), ("data",)), strategy="psum",
                        fused_update=True)
    jstate = engine.init_state(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    batches = _batches(3)
    ranks = spawn_ranks(torch_zoo_rank_fns.wrn_bsp_rank, 2,
                        (np_state.params, np_state.model_state, np_state.opt_state, batches, SMALL),
                        device="cpu", timeout=240)
    jlosses = []
    for x, y in batches:
        jstate, m = engine.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(1))
        jlosses.append(float(m["loss"]))
    jstats = [np.asarray(s) for s in jax.tree_util.tree_leaves(jstate.model_state)]
    assert not any(np.array_equal(s, b) for s, b in
                   zip(jstats, jax.tree_util.tree_leaves(np_state.model_state)))

    def rel_norm(got, want):
        return max(float(np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b)))
                   for a, b in zip(got, want))

    for rank, res in enumerate(ranks):
        assert res["step"] == 3
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, err_msg=f"rank {rank}")
        p0 = jax.tree_util.tree_leaves(np_state.params)
        change = rel_norm([a - c for a, c in zip(jax.tree_util.tree_leaves(res["params"]), p0)],
                          [np.asarray(b) - c for b, c in
                           zip(jax.tree_util.tree_leaves(jstate.params), p0)])
        vel = rel_norm(jax.tree_util.tree_leaves(res["vel"]),
                       jax.tree_util.tree_leaves(jstate.opt_state))
        stats = rel_norm(res["stats"], jstats)
        print(f"[rank {rank}] losses {res['losses']} vs {jlosses}; params' change "
              f"{change:.3g}, velocities {vel:.3g}, BN stats {stats:.3g} in relative norm")
        assert change < 1e-1 and vel < 1e-1 and stats < 1e-1
        # the replicas, their velocities and their averaged stats agree bit for bit
        for key in ("params", "vel", "stats"):
            for a, b in zip(jax.tree_util.tree_leaves(res[key]),
                            jax.tree_util.tree_leaves(ranks[0][key])):
                np.testing.assert_array_equal(a, b)
