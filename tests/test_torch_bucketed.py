"""The bucketed exchange of the port (``--allreduce-buckets``,
``parallel/strategies.py::BucketedOverlapSync``) against the JAX
package's (``tests/test_bucketed.py``).

1. Geometry: ``assign_buckets`` equals the reference's, index for index,
   on AlexNet's 16 and GoogLeNet's 128 leaves at 0.001, 1, 4 and 25 MB,
   and on the reference test's four leaves; ``bucket_overlap_frac``.
2. Two gloo ranks of the 67x67 no-dropout AlexNet (fp32), 3 steps from
   the reference's weights, 4 MB buckets (8 buckets, some of several
   leaves): buckets are bit-identical to the single psum (a sum of two
   does not depend on the order), with and without the fused update;
   the bf16 codec's buckets (in the backward) and int8:ef's (after it,
   residuals keyed to each bucket's leaves) bit-identical to
   ``codec_psum_mean``, residuals too; fused groups of 2 steps (2 + 1),
   eager on the CPU, equal to the steps one at a time. The bucketed fused run
   against the reference's 2-device bucketed step at the trajectory
   limits of ``tests/test_torch_bsp.py``: losses rtol 1e-5, params and
   velocities rtol 1e-4 + atol 1e-6.
3. The refusals, with the reference's words: a ring with buckets, a
   bucket size that is not positive, in-backward buckets with
   ``accum_steps`` > 1 (``:ef`` buckets compose), buckets under another
   rule, and gloo ranks grouping steps on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.parallel import strategies as jst
from theanompi_tpu.parallel.bsp import BSPEngine as JBSPEngine
from theanompi_tpu_torch.bridge import default_layouts
from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.parallel import strategies as tst
from theanompi_tpu_torch.parallel.bsp import BSPEngine, check_fused_ranks
from theanompi_tpu_torch.tools.update_variants import leaf_specs
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import loss_and_grads, make_train_step
from theanompi_tpu_torch.tree import tree_leaves

import torch_exchange_rank_fns

BUCKET_MB = 4.0
STEPS = 3
GLOBAL_BATCH = 4

RUNS = {
    "psum": {},
    "buckets": {"allreduce_buckets": BUCKET_MB},
    "psum-fused": {"fused_update": True},
    "buckets-fused": {"fused_update": True, "allreduce_buckets": BUCKET_MB},
    "grouped": {"fused_update": True, "allreduce_buckets": BUCKET_MB, "group": 2},
    "bf16": {"wire_codec": "bf16"},
    "bf16-buckets": {"wire_codec": "bf16", "allreduce_buckets": BUCKET_MB},
    "int8ef": {"wire_codec": "int8:ef"},
    "int8ef-buckets": {"wire_codec": "int8:ef", "allreduce_buckets": BUCKET_MB},
}
PAIRS = [("psum", "buckets"), ("psum-fused", "buckets-fused"), ("buckets-fused", "grouped"),
         ("bf16", "bf16-buckets"), ("int8ef", "int8ef-buckets")]


class JAlexNetNoDropout(JAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, jnn.Dropout):
                layer.rate = 0.0
        return net


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("model", ["alexnet", "googlenet"])
def test_bucket_boundaries_match_the_reference(model):
    shapes = [s for s, _ in leaf_specs(model)]
    assert len(shapes) == {"alexnet": 16, "googlenet": 128}[model]
    for mb in (0.001, 1.0, 4.0, 25.0):
        budget = max(1, int(mb * 2 ** 20))
        want = jst.assign_buckets([_Shape(s) for s in shapes], budget)
        assert tst.assign_buckets([torch.empty(s, device="meta") for s in shapes],
                                  budget) == want
    leaves = [torch.zeros(s) for s in ((100,), (10,), (200,), (5,))]
    assert tst.assign_buckets(leaves, 600) == [[3], [2], [1, 0]]
    assert tst.assign_buckets(leaves, 10 ** 9) == [[3, 2, 1, 0]]
    for n in (0, 1, 4):
        assert tst.bucket_overlap_frac(n) == jst.bucket_overlap_frac(n)


def _batches(n):
    r = np.random.RandomState(0)
    return [(r.randn(GLOBAL_BATCH, 67, 67, 3).astype(np.float32),
             r.randint(0, 10, GLOBAL_BATCH).astype(np.int32)) for _ in range(n)]


def _reference_engine(**kw):
    jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(
        input_shape=(67, 67, 3), num_classes=10, batch_size=GLOBAL_BATCH,
        compute_dtype=jnp.float32))
    return JBSPEngine(jm, Mesh(np.array(jax.devices()[:2]), ("data",)), **kw)


_PORT: dict = {}


@pytest.fixture
def port_runs(monkeypatch):
    """Every run of RUNS on 2 gloo ranks from the reference's weights,
    once for the module, and the reference's bucketed fused trajectory."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if not _PORT:
        engine = _reference_engine(fused_update=True, allreduce_buckets=BUCKET_MB)
        jstate = engine.init_state(jax.random.PRNGKey(0))
        params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
        vel0 = jax.tree_util.tree_map(np.asarray, jstate.opt_state)
        batches = _batches(STEPS)
        _PORT["ranks"] = spawn_ranks(torch_exchange_rank_fns.exchange_rank, 2,
                                     (params0, vel0, batches, RUNS), device="cpu", timeout=400)
        losses = []
        for x, y in batches:
            jstate, m = engine.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                          jax.random.PRNGKey(1))
            losses.append(float(m["loss"]))
        _PORT["ref"] = (losses, jstate)
    return _PORT


def _assert_same(a, b, what):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=what)


@pytest.mark.parametrize("plain,bucketed", PAIRS, ids=[b for _, b in PAIRS])
def test_buckets_are_bit_identical_to_one_exchange_on_two_ranks(port_runs, plain, bucketed):
    for rank, res in enumerate(port_runs["ranks"]):
        a, b = res[plain], res[bucketed]
        assert a["step"] == b["step"] == STEPS
        if "group" not in RUNS[bucketed]:
            assert b["n_buckets"] == 8 and a["n_buckets"] is None
        assert a["losses"] == b["losses"], (rank, a["losses"], b["losses"])
        for key in ("params", "vel", "ef"):
            _assert_same(a[key], b[key], f"{bucketed} {key} rank {rank}")
    # the replicas agree, and only error feedback keeps a residual per rank
    r0, r1 = (r[bucketed] for r in port_runs["ranks"])
    _assert_same(r0["params"], r1["params"], f"{bucketed} replicas")
    assert bool(r0["ef"]) == ("int8ef" in bucketed)
    if r0["ef"]:
        assert any(not np.array_equal(x, y) for x, y in zip(r0["ef"], r1["ef"]))


def test_bucketed_fused_run_matches_the_reference(port_runs):
    jlosses, jstate = port_runs["ref"]
    for rank, res in enumerate(port_runs["ranks"]):
        got = res["buckets-fused"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, err_msg=f"rank {rank}")
        for mine, ref in ((got["params"], jstate.params), (got["vel"], jstate.opt_state)):
            for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def _small_model():
    return torch_exchange_rank_fns._alexnet(GLOBAL_BATCH)


def test_buckets_are_posted_from_inside_the_backward():
    """Each bucket's exchange is posted when its last gradient is made,
    while the backward still has the earlier layers' gradients to make:
    in the order the backward completes them (a layer's bias before its
    weight), the same on every rank (one rank here: the exchange is the
    identity, so the gradients are the local ones, bit for bit)."""
    model = _small_model()
    state = t_init_state(model, torch.Generator().manual_seed(0), "cpu")
    sync = tst.bucketed("psum", 1, BUCKET_MB, layouts=model.param_layouts)
    x = torch.from_numpy(_batches(1)[0][0])
    y = torch.from_numpy(_batches(1)[0][1])
    rounds = []

    def begin(params):
        rounds.append(sync.begin(params))
        return rounds[-1]

    _, _, _, grads = loss_and_grads(model, state.params, state.model_state, x, y, None, begin)
    _, _, _, local = loss_and_grads(model, state.params, state.model_state, x, y, None)
    posts = rounds[0].posts
    assert sorted(b for b, _ in posts) == list(range(8))
    # pending gradients at each post: the last bucket's post finds none left
    assert posts[0][1] > 0 and posts[-1][1] == 0
    assert [p for _, p in posts] == sorted((p for _, p in posts), reverse=True)
    assert not rounds[0].handles  # the hooks are gone
    for a, b in zip(tree_leaves(grads), tree_leaves(local)):
        assert torch.equal(a, b)


def test_the_refusals_match_the_reference():
    layouts = default_layouts
    for name in ("ring", "ring_bf16", "asa32"):
        with pytest.raises(ValueError, match="needs strategy 'psum' or 'hier'") as got:
            tst.bucketed(name, 4, 8.0, layouts=layouts)
        with pytest.raises(ValueError) as want:
            jst.bucketed(name, "data", 4, 8.0)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="positive bucket size"):
        tst.bucketed("psum", 4, 0.0, layouts=layouts)
    with pytest.raises(ValueError, match="already compresses"):
        tst.bucketed("ring_int8", 4, 8.0, codec="int8", layouts=layouts)
    # stateless codecs ride the backward; :ef syncs after it, as in the reference
    for codec in (None, "bf16", "int8", "int8:ef"):
        mine = tst.bucketed("psum", 4, 8.0, codec=codec, layouts=layouts)
        ref = jst.bucketed("psum", "data", 4, 8.0, codec=codec)
        assert (mine.in_backward, mine.stateful) == (ref.in_backward, ref.stateful)
    model = _small_model()
    sync = tst.bucketed("psum", 2, 8.0, layouts=model.param_layouts)
    with pytest.raises(ValueError, match="accum_steps=2 needs ONE sync"):
        make_train_step(model, accum_steps=2, grad_sync=sync)
    make_train_step(model, accum_steps=2,
                    grad_sync=tst.bucketed("psum", 2, 8.0, codec="int8:ef",
                                           layouts=model.param_layouts))
    # one rank validates the names and has no collective
    with pytest.raises(ValueError, match="needs strategy 'psum' or 'hier'"):
        BSPEngine(model, 1, "cpu", strategy="ring", allreduce_buckets=8.0)
    assert BSPEngine(model, 1, "cpu", allreduce_buckets=8.0).grad_sync is None
    from theanompi_tpu_torch.launch.worker import run_training

    with pytest.raises(ValueError, match="buckets the BSP in-step gradient allreduce only"):
        run_training("easgd", type(model), 1, device="cpu", allreduce_buckets=8.0)


def test_gloo_ranks_grouping_steps_on_a_card_are_refused():
    """An argument check here; with a card, two gloo ranks on it try a
    fused group and must raise."""
    card = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo's collectives of CUDA tensors cannot be "
                                         "captured"):
        check_fused_ranks(2, 2, card, "gloo")
    check_fused_ranks(2, 2, card, "nccl")
    if not torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cannot be captured"):
        spawn_ranks(torch_exchange_rank_fns.exchange_rank, 2,
                    (None, None, _batches(2), {"grouped": {"group": 2}}),
                    device="cuda:0", backend="gloo", timeout=400)
