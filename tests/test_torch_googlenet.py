"""The port's GoogLeNet (theanompi_tpu_torch/models/googlenet.py) against
the JAX reference (theanompi_tpu/models/googlenet.py): the full channel
table at 128x128x3 (the reference's own smoke size), 10 classes, batch 2,
the same weights carried across by theanompi_tpu_torch/bridge.py, every
dropout rate 0 (the reference's masks come from JAX's PRNG). Each check
runs with the inception pool branches on the pool kernel's route
(``pool_kernel=True`` here, ``TMPI_PALLAS_POOL=1`` there, its Pallas
kernels in interpret mode) and off it (``F.max_pool2d`` here,
select-and-scatter there), and a control crosses the two routes.

Tolerances, fp32 (the convolutions and matmuls sum in other orders in
XLA and in PyTorch's CPU kernels, a few fp32 ulps a layer over ~22
layers): main and aux logits and the loss rtol 1e-5 (read: 7e-7);
per-leaf gradients |a - b| <= 1e-4 |b| + 1e-5 max|b| (read: 5e-7 of
max|b| beyond the rtol); over 3 momentum steps, losses rtol 1e-5 at each
step, and the params' changes and velocities in relative norm 1e-1 (the
trajectory flips pool routings after its first step: see the test).
bf16 compute: both packages
round every layer's output to bf16 at their own points: logits within
2^-5 of their largest value, the loss rtol 2e-2 (read: 4x and 6x below).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.googlenet import GoogLeNet as JGoogLeNet
from theanompi_tpu.train import TrainState as JTrainState
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.models.googlenet import GoogLeNet as TGoogLeNet
from theanompi_tpu_torch.models.lm import TransformerLMModel
from theanompi_tpu_torch.nn.layers import CONV_KERNEL
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import make_eval_step as t_eval_step
from theanompi_tpu_torch.train import make_train_step as t_train_step
from theanompi_tpu_torch.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
SMALL = dict(input_shape=(128, 128, 3), num_classes=10, batch_size=BATCH)
ROUTES = {"on": True, "off": False}


class JGoogLeNetNoDropout(JGoogLeNet):
    def build(self):
        super().build()
        for seq in (self.head, self.aux1.net, self.aux2.net):
            for layer in seq.layers:
                if isinstance(layer, jnn.Dropout):
                    layer.rate = 0.0


class TGoogLeNetNoDropout(TGoogLeNet):
    def build(self):
        super().build()
        for seq in (self.head, *self.aux.values()):
            for layer in seq.layers:
                if isinstance(layer, tnn.Dropout):
                    layer.rate = 0.0


def _jmodel(dtype=jnp.float32, **kw):
    return JGoogLeNetNoDropout(JGoogLeNet.default_recipe().replace(compute_dtype=dtype,
                                                                   **{**SMALL, **kw}))


def _tmodel(route: bool, dtype=torch.float32, **kw):
    return TGoogLeNetNoDropout(TGoogLeNet.default_recipe().replace(compute_dtype=dtype,
                                                                   **{**SMALL, **kw}),
                               pool_kernel=route)


@pytest.fixture(scope="module")
def weights():
    """The port's He-normal init, in the reference's layout (numpy), and
    the layout tags; both packages start from these."""
    tm = _tmodel(True)
    params, _ = tm.init_tree(torch.Generator().manual_seed(0))
    layouts = tm.param_layouts(params)
    return bridge.params_to_jax(params, layouts), layouts


@pytest.fixture(scope="module")
def batches():
    r = np.random.RandomState(0)
    return [(r.randn(BATCH, 128, 128, 3).astype(np.float32),
             r.randint(0, 10, BATCH).astype(np.int32)) for _ in range(3)]


def _set_route(monkeypatch, route: bool):
    monkeypatch.setenv("TMPI_PALLAS_POOL", "1" if route else "0")
    monkeypatch.setenv("TMPI_PALLAS", "1")


def _reference_fwd_bwd(jparams, x, y, route, monkeypatch, dtype=jnp.float32):
    """(loss, [main, aux1, aux2] logits, per-leaf grads) of the reference;
    the route is read while the function is traced."""
    _set_route(monkeypatch, route)
    jm = _jmodel(dtype)

    def f(p, xx, yy):
        out, _ = jm.apply(p, {}, xx, train=True, rng=jax.random.PRNGKey(0))
        return jm.loss(out, yy), out

    (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jparams, jnp.asarray(x), jnp.asarray(y))
    return (float(loss), [np.asarray(o, dtype=np.float32) for o in out],
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _port_fwd_bwd(jparams, layouts, x, y, route, dtype=torch.float32):
    tm = _tmodel(route, dtype)
    params = bridge.params_from_jax(jparams, layouts=layouts)
    out, _ = tm.apply(params, {}, torch.from_numpy(x), train=True)
    loss = tm.loss(out, torch.from_numpy(y))
    leaves = tree_leaves(params)
    flat = torch.autograd.grad(loss, leaves)
    # the fused optimizer kernel needs each gradient in its leaf's strides
    assert all(g.stride() == p.stride() for g, p in zip(flat, leaves))
    it = iter(flat)
    grads = bridge.tree_to_jax(tree_map(lambda _: next(it), params), layouts)
    return (float(loss.detach()), [o.detach().float().numpy() for o in out],
            jax.tree_util.tree_leaves(grads))


def _grad_excess(got, want) -> float:
    """Worst leaf's max(|a - b| - 1e-4 |b|) / (1e-5 max|b|): <= 1 passes."""
    return max(float((np.abs(a - b) - 1e-4 * np.abs(b)).max() / (1e-5 * np.abs(b).max()))
               for a, b in zip(got, want))


@pytest.fixture(scope="module")
def reference_runs(weights, batches):
    """The reference's loss, logits and grads on both routes (two jits)."""
    x, y = batches[0]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, route in ROUTES.items():
            out[name] = _reference_fwd_bwd(weights[0], x, y, route, mp)
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_logits_loss_and_grads_match_the_reference(route, weights, batches, reference_runs):
    x, y = batches[0]
    loss, logits, grads = _port_fwd_bwd(*weights, x, y, ROUTES[route])
    jloss, jlogits, jgrads = reference_runs[route]
    assert len(logits) == 3 and all(o.shape == (BATCH, 10) for o in logits)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name, a, b in zip(("main", "aux1", "aux2"), logits, jlogits):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=name)
    assert len(grads) == len(jgrads) == 128
    assert _grad_excess(grads, jgrads) <= 1.0


def test_crossing_the_routes_is_caught(weights, batches, reference_runs):
    """Control: the port on the all-maxima route against the reference on
    select-and-scatter's (and the reverse) fails the gradient check by
    far: the inception pools' inputs are full of ReLU zeros, so their
    windows tie and the two rules send the gradient to other places."""
    x, y = batches[0]
    on = _port_fwd_bwd(*weights, x, y, True)[2]
    off = _port_fwd_bwd(*weights, x, y, False)[2]
    assert _grad_excess(on, reference_runs["off"][2]) > 100
    assert _grad_excess(off, reference_runs["on"][2]) > 100


def _rel_norm(got, want) -> float:
    """Worst leaf's ||a - b|| / ||b||."""
    return max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got, want))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_three_momentum_steps_match_the_reference(route, weights, batches, monkeypatch):
    """The recipe's momentum SGD (0.9, weight decay 1e-4, poly schedule)
    through the fused update on both sides, with lr 0.001 (the recipe's
    0.04 sends a 2-image batch's loss past 100). Every step's loss agrees
    to rtol 1e-5 and its lr to 1e-7: the loss moves from 4.75 to 12.3 in
    one step, so it carries the update rule. The params' changes and the
    velocities after 3 steps are held per leaf in relative norm, to 1e-1:
    past the first step the trajectory is not continuous in the weights —
    a window's maximum (or, on the all-maxima route, a tie among ReLU
    zeros) flips under a 1-ulp change of the pool's input and sends a
    gradient element elsewhere. Noise of 1e-7 on the port's own weights
    moves its velocities after 3 steps by up to 5.1e-2 (route on) and
    2.1e-3 (off) in norm; the two packages read 3.4e-2 and 9.5e-3."""
    jparams, layouts = weights
    sched = {"lr": 0.001, "total_steps": 60, "power": 0.5}
    _set_route(monkeypatch, ROUTES[route])
    jm = _jmodel(sched_kwargs=sched)
    tm = _tmodel(ROUTES[route], sched_kwargs=sched)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jstate = JTrainState(jp, {}, jm.optimizer().init(jp), jnp.zeros((), jnp.int32))
    tstate = t_init_state(tm, torch.Generator().manual_seed(1), "cpu")
    tstate = TrainState(bridge.params_from_jax(jparams, layouts=layouts), {},
                        tstate.opt_state, tstate.step)
    jstep = jax.jit(j_train_step(jm, fused_update=True))
    tstep = t_train_step(tm, fused_update=True)
    for i, (x, y) in enumerate(batches):
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
        tstate, tmet = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y), None)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tmet["error"]), float(jmet["error"]))
    p0 = jax.tree_util.tree_leaves(jparams)
    tp = jax.tree_util.tree_leaves(bridge.params_to_jax(tstate.params, layouts))
    jpl = [np.asarray(b) for b in jax.tree_util.tree_leaves(jstate.params)]
    tv = jax.tree_util.tree_leaves(bridge.tree_to_jax(tstate.opt_state["vel"], layouts))
    jv = [np.asarray(b) for b in jax.tree_util.tree_leaves(jstate.opt_state["vel"])]
    assert _rel_norm([a - c for a, c in zip(tp, p0)], [b - c for b, c in zip(jpl, p0)]) < 1e-1
    assert _rel_norm(tv, jv) < 1e-1


def test_bf16_logits_and_loss_match_the_reference(weights, batches, monkeypatch):
    """bf16 compute, route on, at He-normal weights: the loss is 4.7
    against ln 10 = 2.3 for uniform logits, so it depends on the weights
    (a loss at ln V would say nothing). Both packages round each layer's
    output to bf16, at their own points; limits: logits 2^-5 of their
    largest value (read: 3.7e-3 to 7.5e-3), loss rtol 2e-2 (read:
    3.5e-3)."""
    x, y = batches[0]
    jloss, jlogits, _ = _reference_fwd_bwd(weights[0], x, y, True, monkeypatch, jnp.bfloat16)
    loss, logits, _ = _port_fwd_bwd(*weights, x, y, True, torch.bfloat16)
    assert abs(jloss - math.log(10)) > 1.0
    np.testing.assert_allclose(loss, jloss, rtol=2e-2)
    for name, a, b in zip(("main", "aux1", "aux2"), logits, jlogits):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -5 * np.abs(b).max(), err_msg=name)


def test_param_tree_and_init_distributions_match_the_recipe():
    """Full width (224x224x3, 1000 classes): the reference's 128 leaves
    with its shapes; conv and aux-fc kernels He-normal (std sqrt(2 /
    fan_in)), the logit layers Glorot-uniform, biases zero."""
    tm = TGoogLeNet()
    params, _ = tm.init_tree(torch.Generator().manual_seed(0))
    layouts = tm.param_layouts(params)
    jshapes = jax.eval_shape(JGoogLeNet().init, jax.random.PRNGKey(0))[0]
    got = bridge.params_to_jax(params, layouts)
    jl, tl = jax.tree_util.tree_leaves_with_path(jshapes), jax.tree_util.tree_leaves_with_path(got)
    assert len(tl) == len(jl) == 128
    for (pj, a), (pt, b) in zip(jl, tl):
        assert pj == pt and a.shape == b.shape, (pj, pt)
    assert sum(1 for t in tree_leaves(layouts) if t == CONV_KERNEL) == 59
    for path, leaf in tl:
        names = [str(getattr(k, "key", k)) for k in path]
        if names[-1] == "b":
            assert not leaf.any(), names
            continue
        if leaf.ndim == 4:  # HWIO
            std = math.sqrt(2.0 / (leaf.shape[0] * leaf.shape[1] * leaf.shape[2]))
        elif names[-2].endswith("_fc"):
            std = math.sqrt(2.0 / leaf.shape[0])
        else:  # U(+-sqrt(6 / (fan_in + fan_out))) has std limit / sqrt(3)
            limit = math.sqrt(6.0 / (leaf.shape[0] + leaf.shape[1]))
            assert np.abs(leaf).max() <= limit, names
            std = limit / math.sqrt(3.0)
        # >= 1,024 draws a leaf: the sample std is within ~2.2% (1 sigma)
        assert abs(leaf.std() / std - 1) < 0.12, names
        assert abs(leaf.mean()) < 0.15 * std, names


def test_the_pool_kernel_flag_never_silently_does_nothing():
    assert TGoogLeNet(pool_kernel=True).kernel_pools() == [
        f"{b}.bp" for b in ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b")]
    assert TGoogLeNet().kernel_pools() == []
    # 4096x4096 inputs give the inception maps above 64x64: none routes
    big = TGoogLeNet.default_recipe().replace(input_shape=(4096, 4096, 3))
    with pytest.raises(ValueError, match="pool_kernel=True would do nothing"):
        TGoogLeNet(big, pool_kernel=True)
    with pytest.raises(ValueError, match="pool_kernel=True would do nothing"):
        TAlexNet(pool_kernel=True)
    with pytest.raises(ValueError, match="pool_kernel=True would do nothing"):
        TransformerLMModel(pool_kernel=True)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_and_eval_steps_take_the_tuple_of_logits(accum):
    """The training forward returns (main, aux1, aux2): the step detaches
    each, the metrics read the main head; the eval forward returns the
    main logits alone. 96x96 is the smallest input whose aux heads see a
    5x5 map."""
    tm = _tmodel(True, input_shape=(96, 96, 3), batch_size=4)
    state = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randn(4, 96, 96, 3).astype(np.float32))
    y = torch.from_numpy(r.randint(0, 10, 4).astype(np.int32))
    state, met = t_train_step(tm, fused_update=True, accum_steps=accum)(state, x, y, None)
    assert set(met) == {"loss", "error", "top5_error", "lr"}
    assert all(math.isfinite(float(v)) for v in met.values())
    vm = t_eval_step(tm)(state, x, y)
    logits = tm.apply(state.params, {}, x, train=False)[0]
    assert isinstance(logits, torch.Tensor) and logits.shape == (4, 10)
    np.testing.assert_allclose(float(vm["loss"]), float(tm.loss(logits, y)), rtol=1e-6)


def test_cli_trains_googlenet_on_cpu_with_the_pool_kernel():
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "1", "googlenet",
           "GoogLeNet", "--synthetic", "--pool-kernel", "--fused-update", "--device", "cpu",
           "--max-steps", "2", "--batch-size", "4", "--print-freq", "1",
           "--recipe-arg", "input_shape=[96,96,3]", "--recipe-arg", "num_classes=10",
           "--dataset-arg", "n_train=8", "--dataset-arg", "n_val=4"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["model"] == "googlenet" and summary["pool_kernel"] is True
    assert summary["steps"] == 2 and summary["device"] == "cpu"
    assert len(summary["losses"]) == 2 and all(math.isfinite(v) for v in summary["losses"])
    assert set(summary["val"]) == {"loss", "error", "top5_error"}
    # on the CPU the wrappers take their plain versions: no kernel launched
    assert not any(summary["kernel_launches_per_rank"][0].values())


def test_each_forward_runs_the_nine_inception_pools_on_contiguous_nhwc(monkeypatch):
    """With the route on, a forward calls the pool kernel's forward once
    for each inception, on the contiguous NHWC tensor the kernel takes
    (the card's wrapper raises on any other), and each backward the
    kernel's backward once for each; with the route off, never."""
    from theanompi_tpu_torch.ops import pool as tpool

    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = tpool.maxpool3x3_fwd, tpool.maxpool3x3_bwd

    def spy_fwd(x):
        calls["fwd"].append(x.is_contiguous())
        return fwd(x)

    def spy_bwd(x, y, g):
        calls["bwd"] += 1
        assert x.is_contiguous() and y.is_contiguous() and g.is_contiguous()
        return bwd(x, y, g)

    monkeypatch.setattr(tpool, "maxpool3x3_fwd", spy_fwd)
    monkeypatch.setattr(tpool, "maxpool3x3_bwd", spy_bwd)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 96, 96, 3).astype(np.float32))
    for route, want in ((True, 9), (False, 0)):
        calls["fwd"], calls["bwd"] = [], 0
        tm = _tmodel(route, input_shape=(96, 96, 3))
        params, _ = tm.init(torch.Generator().manual_seed(0))
        out, _ = tm.apply(params, {}, x, train=True)
        torch.autograd.grad(tm.loss(out, torch.tensor([1, 2])), tree_leaves(params))
        assert calls["fwd"] == [True] * want and calls["bwd"] == want
