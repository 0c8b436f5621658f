"""The rest of the port's CNN zoo (``models/mlp.py``, ``models/cifar10.py``,
``models/model_zoo/{wrn,resnet50,vgg}.py``) against the JAX package's
models, and the zoo's registries (``models/__init__.py::MODEL_REGISTRY``,
``models/zoo.py::zoo_entry``).

Each model at the full channel table on a small input, batch 2 (the MLP
4), every dropout rate 0 (the reference's masks come from JAX's PRNG):
the port's He-normal / Glorot weights carried into the reference by
``bridge.params_to_jax`` with the model's layout tags, the same numpy
batches from a seed. ResNet-50 runs at 64x64x3 with 10 classes, VGG16 at
32x32x3 with 10 classes, WRN-16-4, the cifar10 CNN and the MLP at their
recipes' inputs.

Tolerances, fp32, ``tests/test_torch_googlenet.py``'s: logits and loss
rtol 1e-5 (logits also atol 1e-5 of their largest value); gradients and
BN statistics ``|a - b| <= 1e-4 |b| + 1e-5 max|b|``. The whole network's
gradient is not continuous where a ReLU sits at its kink (VGG16 has one
pre-activation 1.3e-6 from zero), so per-leaf gradients are held
elementwise layer by layer, each layer fed the reference's own input
(``tests/test_torch_zoo_layers.py``), and the whole network's in
relative norm per leaf: 1e-4 where no kink is crossed (MLP, cifar10,
WRN-16-4), GoogLeNet's 1e-1 for VGG16 and ResNet-50. Trajectories per
leaf in relative norm, within twice the reference's own spread under a
one-ulp change of the input and never looser than needed: the larger of
1e-4 and that control. ResNet-50's fp32 forward amplifies rounding
(a one-ulp change of its input moves its logits by 1.7e-4 of their
largest value), so its whole-network figures are held against that
control of the reference's own. bf16 (VGG16's recipe here, ResNet-50's
BN bf16 branch layer by layer there): GoogLeNet's bf16 limits, 2^-5 of the
largest value, the loss rtol 2e-2. Readings are in each test's
docstring.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu import nn as jnn
from theanompi_tpu.models import get_model as j_get_model
from theanompi_tpu.models.cifar10 import Cifar10_model as JCifar10
from theanompi_tpu.models.mlp import MLP as JMLP
from theanompi_tpu.models.model_zoo.resnet50 import ResNet50 as JResNet50
from theanompi_tpu.models.model_zoo.vgg import VGG16 as JVGG16
from theanompi_tpu.models.model_zoo.wrn import WRN_16_4 as JWRN_16_4
from theanompi_tpu.models.zoo import zoo_entry as j_zoo_entry
from theanompi_tpu.train import TrainState as JTrainState
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.launch.session import resolve_model
from theanompi_tpu_torch.models import MODEL_REGISTRY
from theanompi_tpu_torch.models.cifar10 import Cifar10_model as TCifar10
from theanompi_tpu_torch.models.mlp import MLP as TMLP
from theanompi_tpu_torch.models.model_zoo.resnet50 import ResNet50 as TResNet50
from theanompi_tpu_torch.models.model_zoo.vgg import VGG16 as TVGG16
from theanompi_tpu_torch.models.model_zoo.wrn import WRN_16_4 as TWRN_16_4
from theanompi_tpu_torch.models.zoo import zoo_entry
from theanompi_tpu_torch.nn.layers import CONV_KERNEL, to_reference_layout
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import make_train_step as t_train_step
from theanompi_tpu_torch.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_dropout_j(cls):
    class NoDropout(cls):
        def build(self):
            net = super().build()
            for layer in net.layers:
                if isinstance(layer, jnn.Dropout):
                    layer.rate = 0.0
            return net
    return NoDropout


def _no_dropout_t(cls):
    class NoDropout(cls):
        def build(self):
            net = super().build()
            for layer in net.layers:
                if isinstance(layer, tnn.Dropout):
                    layer.rate = 0.0
            return net
    return NoDropout


# name -> (reference class, port class, recipe overrides, lr for the 3
# steps, whether the per-layer check (tests/test_torch_zoo_layers.py)
# runs the reference op by op: a block holds ReLUs inside, and its
# gradients hold elementwise only where both packages round the block's
# ops alike enough to keep every ReLU on its side, which the op-by-op
# reference does and its jitted fusions need not)
CASES = {
    "mlp": (JMLP, TMLP, dict(batch_size=4), 0.01, False),
    "cifar10": (_no_dropout_j(JCifar10), _no_dropout_t(TCifar10), dict(batch_size=2), 0.01,
                False),
    "wrn_16_4": (JWRN_16_4, TWRN_16_4, dict(batch_size=2), 0.01, True),
    "resnet50": (JResNet50, TResNet50,
                 dict(batch_size=2, input_shape=(64, 64, 3), num_classes=10), 0.001, True),
    "vgg16": (_no_dropout_j(JVGG16), _no_dropout_t(TVGG16),
              dict(batch_size=2, input_shape=(32, 32, 3), num_classes=10), 0.001, False),
}


def _models(name, dtype="float32", lr=None):
    jcls, tcls, kw, _, _ = CASES[name]
    kw = dict(kw)
    if lr is not None:
        base = tcls.default_recipe().sched_kwargs
        kw["sched_kwargs"] = {**base, "lr": lr}
    jm = jcls(jcls.default_recipe().replace(compute_dtype=getattr(jnp, dtype), **kw))
    tm = tcls(tcls.default_recipe().replace(compute_dtype=getattr(torch, dtype), **kw))
    return jm, tm


_WEIGHTS = {}


def _weights(name):
    """The port's init in the reference's layout (numpy), the layout tags
    and the BN state (the init's ones and zeros); cached per model."""
    if name not in _WEIGHTS:
        _, tm = _models(name)
        params, state = tm.init_tree(torch.Generator().manual_seed(0))
        layouts = tm.param_layouts(params)
        _WEIGHTS[name] = (bridge.params_to_jax(params, layouts), layouts,
                          bridge.tree_to_jax(state))
    return _WEIGHTS[name]


def _batches(name, n=3):
    jm, _ = _models(name)
    r = np.random.RandomState(0)
    b, shape, k = jm.recipe.batch_size, jm.recipe.input_shape, jm.recipe.num_classes
    return [(r.randn(b, *shape).astype(np.float32), r.randint(0, k, b).astype(np.int32))
            for _ in range(n)]


def _reference_fwd_bwd(name, x, y, dtype="float32"):
    """(loss, logits, per-leaf grads, new BN state leaves) of the reference."""
    jm, _ = _models(name, dtype)
    jparams, _, jstate = _weights(name)

    def f(p, s, xx, yy):
        out, ns = jm.apply(p, s, xx, train=True, rng=jax.random.PRNGKey(0))
        return jm.loss(out, yy), (out, ns)

    fn = jax.jit(jax.value_and_grad(f, has_aux=True))
    (loss, (out, ns)), grads = fn(jparams, jstate, jnp.asarray(x), jnp.asarray(y))
    return (float(loss), np.asarray(out, dtype=np.float32),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
            [np.asarray(s) for s in jax.tree_util.tree_leaves(ns)])


def _port_fwd_bwd(name, x, y, dtype="float32"):
    _, tm = _models(name, dtype)
    jparams, layouts, jstate = _weights(name)
    params = bridge.params_from_jax(jparams, layouts=layouts)
    state = bridge.tree_from_jax(jstate)
    out, ns = tm.apply(params, state, torch.from_numpy(x), train=True)
    loss = tm.loss(out, torch.from_numpy(y))
    leaves = tree_leaves(params)
    flat = torch.autograd.grad(loss, leaves)
    # the fused optimizer kernel needs each gradient in its leaf's strides
    assert all(g.stride() == p.stride() for g, p in zip(flat, leaves))
    it = iter(flat)
    grads = bridge.tree_to_jax(tree_map(lambda _: next(it), params), layouts)
    return (float(loss.detach()), out.detach().float().numpy(),
            jax.tree_util.tree_leaves(grads), [s.numpy() for s in tree_leaves(ns)])


def _excess(got, want) -> float:
    """Worst leaf's max(|a - b| - 1e-4 |b|) / (1e-5 max|b|): <= 1 passes."""
    return max(float((np.abs(a - b) - 1e-4 * np.abs(b)).max() / (1e-5 * np.abs(b).max()))
               for a, b in zip(got, want))


def _rel_norm(got, want) -> float:
    """Worst leaf's ||a - b|| / ||b||."""
    return max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# registries and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,expected_m,tol", [
    ("alexnet", 60.97, 0.1), ("vgg16", 138.36, 0.1), ("resnet50", 25.56, 0.1),
    ("wrn", 36.48, 0.2),
])
def test_param_counts_at_the_canonical_sizes_on_the_meta_device(name, expected_m, tol):
    """``tests/test_zoo.py``'s counts and tolerances, at the recipes'
    inputs, drawn on the meta device (shapes only)."""
    model = resolve_model(name, MODEL_REGISTRY[name][1])()
    with torch.device("meta"):
        params, _ = model.net.init(None, model.input_shape)
    leaves = tree_leaves(params)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    count_m = sum(t.numel() for t in leaves) / 1e6
    assert abs(count_m - expected_m) < tol, f"{name}: {count_m:.2f}M vs {expected_m}M"


@pytest.mark.parametrize("name,n_leaves,n_state,n_conv", [
    ("mlp", 6, 0, 0), ("cifar10", 10, 0, 2), ("wrn", 80, 50, 28), ("wrn_16_4", 44, 26, 16),
    ("resnet50", 161, 106, 53), ("vgg16", 32, 0, 13),
])
def test_param_and_state_trees_are_the_references(name, n_leaves, n_state, n_conv):
    """At the recipe's full size, every param and BN-state leaf sits at
    the reference's path with the reference's shape once mapped by its
    layout tag (a conv kernel OIHW here, HWIO there), and exactly the conv
    kernels carry ``CONV_KERNEL``: without the blocks' own
    ``param_layouts`` a kernel would cross untransposed."""
    if name == "mlp":
        tcls, jcls = TMLP, JMLP
    else:
        tcls = resolve_model(name, MODEL_REGISTRY[name][1])
        jcls = j_get_model(name)
    tm, jm = tcls(), jcls()
    with torch.device("meta"):
        params, state = tm.net.init(None, tm.input_shape)
    layouts = tm.param_layouts(params)
    jparams, jstate = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    for tree, lays, jtree in ((params, layouts, jparams), (state, None, jstate)):
        want = jax.tree_util.tree_leaves_with_path(jtree)
        got = bridge._paths(tree, "")
        tags = tree_leaves(lays) if lays is not None else ["plain"] * len(got)
        assert [jax.tree_util.keystr(p, simple=True, separator="/") for p, _ in want] == \
            [k[1:] for k, _ in got]
        for (_, a), (k, t), lay in zip(want, got, tags):
            assert tuple(a.shape) == tuple(to_reference_layout(t, lay).shape), k
    assert len(tree_leaves(params)) == n_leaves and len(tree_leaves(state)) == n_state
    assert sum(t == CONV_KERNEL for t in tree_leaves(layouts)) == n_conv
    assert all(t.dim() == 4 for t, lay in zip(tree_leaves(params), tree_leaves(layouts))
               if lay == CONV_KERNEL)


def test_zoo_entry_and_the_registry_resolve_every_name():
    """``zoo_entry`` gives the reference's classes (by name) and batches;
    ``MODEL_REGISTRY`` holds the reference's names but the MoE LM, whose
    port waits for its engine (ROADMAP queue 1 item 4)."""
    for name in ("mlp", "alexnet", "googlenet", "resnet50", "vgg16", "wrn", "transformer_lm"):
        cls, batch = zoo_entry(name)
        jcls, jbatch = j_zoo_entry(name)
        assert cls.__name__ == jcls.__name__ and batch == jbatch, name
        assert cls.__module__.startswith("theanompi_tpu_torch.")
    with pytest.raises(ValueError, match="unknown bench model"):
        zoo_entry("nope")
    from theanompi_tpu.models import MODEL_REGISTRY as J_REGISTRY

    assert set(MODEL_REGISTRY) == set(J_REGISTRY) - {"moe_lm"}
    for name, (module, cls_name) in MODEL_REGISTRY.items():
        assert resolve_model(name, cls_name).__name__ == J_REGISTRY[name][1]
        assert module.startswith("theanompi_tpu_torch.models")


def test_batchnorm_with_an_axis_name_is_refused():
    """Cross-replica BN is ported (``tests/test_torch_cross_bn.py``):
    outside a run of several ranks its axis is unbound, so a training
    step is refused with ``NameError``, as the reference's unbound
    ``pmean`` is; evaluation reads the running statistics and runs."""
    bn = tnn.BatchNorm(axis_name="data")
    params, state = bn.init(None, (2, 3))
    with pytest.raises(NameError, match="unbound axis name"):
        bn.apply(params, state, torch.randn(2, 3), train=True)
    assert bn.apply(params, state, torch.randn(2, 3), train=False)[0].shape == (2, 3)
    model = TWRN_16_4(TWRN_16_4.default_recipe().replace(bn_axis_name="data"))
    params, state = model.init_tree(torch.Generator().manual_seed(0))
    with pytest.raises(NameError, match="unbound axis name: 'data'"):
        model.apply(params, state, torch.randn(2, 32, 32, 3), train=True)
    assert TResNet50(TResNet50.default_recipe().replace(
        bn_axis_name="data")).recipe.bn_axis_name == "data"
    assert tnn.BatchNorm().axis_name is None
    assert TWRN_16_4.default_recipe().bn_axis_name is None


def test_the_new_modules_load_no_jax():
    code = (
        "import sys\n"
        "import theanompi_tpu_torch.models.mlp, theanompi_tpu_torch.models.cifar10\n"
        "import theanompi_tpu_torch.models.model_zoo.wrn\n"
        "import theanompi_tpu_torch.models.model_zoo.resnet50\n"
        "import theanompi_tpu_torch.models.model_zoo.vgg, theanompi_tpu_torch.models.zoo\n"
        "from theanompi_tpu_torch.models.zoo import zoo_entry\n"
        "[zoo_entry(n) for n in ('mlp', 'resnet50', 'vgg16', 'wrn')]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'theanompi_tpu'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _ulp_control(name, x):
    """How far a one-ulp change of the input (each element times 1 +-
    2^-24, three seeded draws) moves the reference's own logits and BN
    statistics, as a share of their largest value (worst draw, worst
    leaf): the yardstick of a model whose fp32 forward amplifies rounding
    (ResNet-50)."""
    jm, _ = _models(name)
    jparams, _, jstate = _weights(name)
    f = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, train=True))
    out0, st0 = f(jparams, jstate, jnp.asarray(x))
    r = np.random.RandomState(7)
    worst_logits = worst_stats = 0.0
    for _ in range(3):
        xn = (x * (1 + r.choice([-1, 1], x.shape) * 2.0 ** -24)).astype(np.float32)
        out, st = f(jparams, jstate, jnp.asarray(xn))
        worst_logits = max(worst_logits, float(jnp.abs(out - out0).max() / jnp.abs(out0).max()))
        for a, b in zip(jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(st0)):
            worst_stats = max(worst_stats, float(jnp.abs(a - b).max() / jnp.abs(b).max()))
    return worst_logits, worst_stats


@pytest.mark.parametrize("name", sorted(CASES))
def test_training_forward_matches_the_reference(name):
    """Logits, loss and the BN statistics a training forward writes, the
    whole network at once. fp32 limits (module docstring); read: logits
    3.7e-7 (mlp), 1.2e-6 (cifar10), 9.2e-7 (wrn_16_4), 1.3e-6 (vgg16) of
    their largest value beyond nothing, WRN's stats at 0.035 of the
    gradient-style limit. ResNet-50's fp32 forward amplifies rounding: a
    one-ulp change of the input moves the reference's own logits by up to
    1.7e-4 of their largest value (``_ulp_control``). There the two
    packages are held to 4x that control (read: 2.6e-4, 1.5x), the
    loss to twice the largest logit difference (softmax cross-entropy
    moves at most that much), the stats to 4x their own control; each
    layer is held at the fp32 limits by ``tests/test_torch_zoo_layers.py``."""
    x, y = _batches(name)[0]
    jloss, jlogits, _, jstats = _reference_fwd_bwd(name, x, y)
    loss, logits, _, stats = _port_fwd_bwd(name, x, y)
    assert len(stats) == len(jstats) and (len(stats) > 0) == (name in ("wrn_16_4", "resnet50"))
    if name != "resnet50":
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(logits, jlogits, rtol=1e-5,
                                   atol=1e-5 * np.abs(jlogits).max())
        if stats:
            assert _excess(stats, jstats) <= 1.0
        return
    c_logits, c_stats = _ulp_control(name, x)
    d_logits = float(np.abs(logits - jlogits).max())
    print(f"[resnet50] control logits {c_logits:.3g} stats {c_stats:.3g}; port - reference "
          f"logits {d_logits / np.abs(jlogits).max():.3g}, loss {abs(loss - jloss):.3g}")
    assert 0 < c_logits < 1e-3 and 0 < c_stats < 1e-2
    assert d_logits <= 4 * c_logits * np.abs(jlogits).max()
    assert abs(loss - jloss) <= 2 * d_logits + 1e-5 * abs(jloss)
    for a, b in zip(stats, jstats):
        assert np.abs(a - b).max() <= 4 * c_stats * np.abs(b).max() + 1e-5 * np.abs(b).max()


# the whole network's gradient, worst leaf's relative norm: 1e-4 where no
# ReLU kink is crossed, GoogLeNet's 1e-1 where one is (VGG16) or the
# forward amplifies rounding (ResNet-50)
GRAD_LIMITS = {"mlp": 1e-4, "cifar10": 1e-4, "wrn_16_4": 1e-4, "vgg16": 1e-1, "resnet50": 1e-1}


@pytest.mark.parametrize("name", sorted(CASES))
def test_whole_network_gradients_match_the_reference(name):
    """The gradient of the whole loss, leaf by leaf, in relative norm
    (``GRAD_LIMITS``). Elementwise it holds where no ReLU sits near its
    kink: in VGG16 one pre-activation of ``conv3_2`` is 1.3e-6 from zero
    and rounds to the other side of it in the other package, so every
    leaf before it reads 1e3-8e3 times the elementwise limit while the
    later ones stay within 0.16 of it. Read: relative norm 4.3e-7 (mlp),
    1.1e-6 (cifar10), 6.1e-6 (wrn_16_4), 1.7e-2 (vgg16), 5.5e-2
    (resnet50, whose forward amplifies rounding)."""
    x, y = _batches(name)[0]
    _, _, jgrads, _ = _reference_fwd_bwd(name, x, y)
    _, _, grads, _ = _port_fwd_bwd(name, x, y)
    assert len(grads) == len(jgrads)
    print(f"[{name}] whole-network grads rel norm {_rel_norm(grads, jgrads):.3g}, "
          f"elementwise excess {_excess(grads, jgrads):.3g}")
    assert _rel_norm(grads, jgrads) < GRAD_LIMITS[name]


def _reference_steps(name, lr, noise_seeds=(None,)):
    """3 steps of the reference's recipe rule (fused update, jnp route)
    from the shared weights, once per entry of ``noise_seeds`` (one
    compile) -> per run (losses, params, velocities, BN stats) as numpy
    leaf lists. A seed multiplies each batch's images by 1 +- 2^-24
    first (the one-ulp control); ``None`` runs the batches as they are."""
    jm, _ = _models(name, lr=lr)
    jparams, _, jstate0 = _weights(name)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js = jax.tree_util.tree_map(jnp.asarray, jstate0)
    step = jax.jit(j_train_step(jm, fused_update=True))
    runs = []
    for seed in noise_seeds:
        state = JTrainState(jp, js, jm.optimizer().init(jp), jnp.zeros((), jnp.int32))
        r = np.random.RandomState(seed) if seed is not None else None
        losses = []
        for x, y in _batches(name):
            if r is not None:
                x = (x * (1 + r.choice([-1, 1], x.shape) * 2.0 ** -24)).astype(np.float32)
            state, met = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
            losses.append(float(met["loss"]))
        leaves = [[np.asarray(t) for t in jax.tree_util.tree_leaves(tree)]
                  for tree in (state.params, state.opt_state["vel"], state.model_state)]
        runs.append((losses, *leaves))
    return runs


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_of_the_recipes_rule_match_the_reference(name, monkeypatch):
    """3 steps of the recipe's rule (Nesterov for WRN, momentum for the
    others; weight decay) through the fused update in both packages, the
    reference on its jnp route (``TMPI_PALLAS=0``), against the
    reference's own spread: the same 3 steps with each image times 1 +-
    2^-24 (``_reference_steps``, 3 noise seeds, the worst draw). Per
    leaf, the params' change, the velocities and the BN statistics in
    relative norm within the larger of 1e-4 and twice that control. Read
    (port; control): mlp 9.8e-7 / 2.9e-7 (8.1e-7 / 2.9e-7); cifar10
    2.7e-6 / 9.0e-7 (2.7e-6 / 1.6e-6); wrn_16_4 7.7e-3 / 1.3e-2 / 5.3e-6
    (7.7e-3 / 1.3e-2 / 5.2e-6); vgg16 1.3e-2 / 9.6e-3 (1.5e-2 / 1.2e-2).
    WRN-16-4's and VGG16's readings are one ReLU crossing its kink after
    a step, the same that one of the reference's own one-ulp draws shows
    (its other two read 5e-5 / 2e-6); BN scales near 1 move by a few
    hundred ulps of their value, so one ulp of rounding is already 1e-3
    of their change. Every loss rtol 1e-5 (read: 3e-7 at worst), but
    ResNet-50's: at batch 2 and lr 1e-3 it is chaotic in the reference
    itself (a one-ulp change of its input moves its own losses by up to
    0.60 by the second step), so each loss is held within 2x the
    control's distance from the reference's plus rtol 1e-5 (read: 1.09 /
    1.53 / 0.26 against 1.27 / 1.72 / 0.26)."""
    monkeypatch.setenv("TMPI_PALLAS", "0")
    lr = CASES[name][3]
    _, tm = _models(name, lr=lr)
    jparams, layouts, jstate0 = _weights(name)
    (jl, jpl, jv, jst), *noisy = _reference_steps(name, lr, (None, 7, 8, 9))
    tstate = t_init_state(tm, torch.Generator().manual_seed(1), "cpu")
    tstate = TrainState(bridge.params_from_jax(jparams, layouts=layouts),
                        bridge.tree_from_jax(jstate0), tstate.opt_state, tstate.step)
    tstep = t_train_step(tm, fused_update=True)
    tl = []
    for x, y in _batches(name):
        tstate, tmet = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y), None)
        tl.append(float(tmet["loss"]))
    p0 = jax.tree_util.tree_leaves(jparams)
    tp = jax.tree_util.tree_leaves(bridge.params_to_jax(tstate.params, layouts))
    tv = jax.tree_util.tree_leaves(bridge.tree_to_jax(tstate.opt_state["vel"], layouts))
    ts = [s.numpy() for s in tree_leaves(tstate.model_state)]
    assert len(tp) == len(jpl) and len(tv) == len(jv) and len(ts) == len(jst)

    def dist(params, vels, stats):
        d = {"change": _rel_norm([a - c for a, c in zip(params, p0)],
                                 [b - c for b, c in zip(jpl, p0)]),
             "vel": _rel_norm(vels, jv)}
        if stats:
            d["stats"] = _rel_norm(stats, jst)
        return d

    got = dist(tp, tv, ts)
    # the reference's own spread under one-ulp input changes, worst of 3
    spread = [max(abs(run[0][i] - jl[i]) for run in noisy) for i in range(3)]
    control = {k: max(dist(*run[1:])[k] for run in noisy) for k in got}
    print(f"[{name}] losses {tl} vs {jl}; {got}; control: loss spread {spread}; {control}")
    assert len(set(jl)) == 3  # the steps moved the loss
    assert all(got[k] <= max(1e-4, 2 * control[k]) for k in got), (got, control)
    if name != "resnet50":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        return
    for a, b, c in zip(tl, jl, spread):
        assert abs(a - b) <= 2 * c + 1e-5 * abs(b)


def test_bf16_vgg16_logits_and_loss_match_the_reference():
    """VGG16 at its recipe's bf16 compute, the whole network: both
    packages round every layer's output to bf16 at their own points;
    GoogLeNet's bf16 limits: logits within 2^-5 of their largest value,
    the loss rtol 2e-2."""
    x, y = _batches("vgg16")[0]
    jloss, jlogits, _, _ = _reference_fwd_bwd("vgg16", x, y, "bfloat16")
    loss, logits, _, _ = _port_fwd_bwd("vgg16", x, y, "bfloat16")
    print(f"[vgg16 bf16] loss {loss} vs {jloss}; logits "
          f"{np.abs(logits - jlogits).max() / np.abs(jlogits).max():.3g} of max")
    np.testing.assert_allclose(loss, jloss, rtol=2e-2)
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=2.0 ** -5 * np.abs(jlogits).max())


def test_the_numeric_policy_asks_cudnn_for_deterministic_algorithms():
    """A resumed or captured run equals the eager uninterrupted one bit for
    bit only if no cuDNN algorithm sums with atomics (WRN-28-10's fp32
    weight gradients did): ``resolve_device`` sets the policy."""
    from theanompi_tpu_torch.device import resolve_device

    torch.backends.cudnn.deterministic = False
    resolve_device("cpu")
    assert torch.backends.cudnn.deterministic is True


def test_the_flop_count_takes_strided_and_padded_convolutions():
    """``utils/flops.py`` over one WRN-16-4 training step (CPU, batch 2):
    its strided 3x3 convolutions take ``F.pad``'s asymmetric SAME pads and
    its 1x1 projections are strided VALID; the count must equal the sum
    over every conv and dense layer of ``2 * N * out_positions * k * k *
    cin * cout`` for the forward, the same for the weight gradient, and
    the same for the input gradient of every layer but the first."""
    from theanompi_tpu_torch.models.model_zoo.wrn import PreActBlock
    from theanompi_tpu_torch.utils.flops import count_step_flops

    tm = TWRN_16_4(TWRN_16_4.default_recipe().replace(batch_size=2))
    state = t_init_state(tm, torch.Generator().manual_seed(0), "cpu")
    x, y = (torch.from_numpy(a) for a in _batches("wrn_16_4")[0])
    _, flops = count_step_flops(t_train_step(tm, fused_update=True), state, x, y, None)

    def conv(layer, in_shape):
        n, oh, ow, cout = layer.out_shape(in_shape)
        kh, kw = layer.kernel
        return 2 * n * oh * ow * cout * kh * kw * in_shape[-1]

    want, shape, first = 0, tm.input_shape, True
    for layer in tm.net.layers:
        if isinstance(layer, PreActBlock):
            parts = [(layer.conv1, shape), (layer.conv2, layer.conv1.out_shape(shape))]
            if layer.proj is not None:
                parts.append((layer.proj, shape))
            fwd = [conv(c, s) for c, s in parts]
        elif isinstance(layer, tnn.Conv):
            fwd = [conv(layer, shape)]
        elif isinstance(layer, tnn.Dense):
            fwd = [2 * shape[0] * shape[-1] * layer.out_features]
        else:
            fwd = []
        for f in fwd:
            want += f * (2 if first else 3)
            first = False
        shape = layer.out_shape(shape)
    assert any(isinstance(l, PreActBlock) and l.conv1.stride == (2, 2) for l in tm.net.layers)
    assert flops == want, (flops, want)
