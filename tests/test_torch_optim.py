"""Optimizer registry and LR schedules of the PyTorch port against the
JAX reference (theanompi_tpu/ops/{optimizers,lr_schedules}.py), on the
same numpy inputs.

Tolerance: rtol 1e-6 / atol 1e-7 (fp32). The expressions are the same
on both sides, op for op; the reference is compiled by XLA, which may
contract a multiply-add or evaluate pow/sqrt/cos to a different last
bit, and three chained steps carry that forward.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.ops import lr_schedules as jsched
from theanompi_tpu.ops import optimizers as jopt
from theanompi_tpu_torch.ops import lr_schedules as tsched
from theanompi_tpu_torch.ops import optimizers as topt
from theanompi_tpu_torch.tree import tree_leaves

RTOL, ATOL = 1e-6, 1e-7


def _tree(seed):
    r = np.random.RandomState(seed)
    return {"layer": {"w": r.randn(7, 5).astype(np.float32), "b": r.randn(5).astype(np.float32)},
            "s": r.randn(3).astype(np.float32)}


def _to_t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _close(j, t):
    jl = jax.tree_util.tree_leaves(j)
    tl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x.numpy(), t))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {}),
    ("sgd", {"weight_decay": 0.01}),
    ("momentum", {"momentum": 0.9, "weight_decay": 5e-4}),
    ("nesterov", {"momentum": 0.95, "weight_decay": 0.01}),
    ("rmsprop", {"decay": 0.9, "eps": 1e-8, "weight_decay": 0.001}),
    ("adam", {"b1": 0.9, "b2": 0.999, "eps": 1e-8}),
    ("adam", {"weight_decay": 0.01}),
])
def test_registry_optimizer_matches_reference(name, kwargs):
    jo, to = jopt.get_optimizer(name, **kwargs), topt.get_optimizer(name, **kwargs)
    assert to.name == jo.name and to.apply is None
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = _to_t(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _tree(10 + i)
        lr = 0.05 / (i + 1)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jnp.float32(lr))
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(_to_t(g), ts, tp, torch.tensor(lr))
        same = topt.apply_updates(tp, tu)
        assert same is tp  # in place
        _close(ju, tu)
    _close(jp, tp)
    _close(js, ts)


def test_accumulators_are_fp32_for_bf16_params():
    tp = {"w": torch.zeros(3, 2, dtype=torch.bfloat16)}
    for name in ("momentum", "nesterov", "rmsprop", "adam"):
        st = topt.get_optimizer(name).init(tp)
        leaves = [x for x in tree_leaves(st) if x.dim() > 0]
        assert leaves and all(x.dtype == torch.float32 for x in leaves)


def test_get_optimizer_refuses_unknown_and_fused_only_knobs():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("lamb")
    with pytest.raises(ValueError, match="clip_norm"):
        topt.get_optimizer("momentum", clip_norm=1.0)


STEPS = [0, 1, 2, 5, 29.5, 30, 31, 49, 50, 64.9, 65, 70, 99, 100, 250]


@pytest.mark.parametrize("name,kwargs", [
    ("constant", {"lr": 0.01}),
    ("step", {"lr": 0.01, "boundaries": [30, 50, 65], "factor": 0.1}),
    ("step", {"lr": 0.1, "boundaries": [65, 30], "factor": 0.5}),
    ("exp", {"lr": 0.1, "decay": 0.97, "every": 3}),
    ("poly", {"lr": 0.1, "total_steps": 100, "power": 2.0, "end_lr": 0.001}),
    ("warmup_cosine", {"lr": 0.2, "warmup_steps": 10, "total_steps": 200, "end_lr": 0.0}),
])
def test_schedule_matches_reference(name, kwargs):
    js, ts = jsched.get_schedule(name, **kwargs), tsched.get_schedule(name, **kwargs)
    for s in STEPS:
        jv = float(js(jnp.float32(s)))
        tv = ts(torch.tensor(s, dtype=torch.float32))
        assert tv.dtype == torch.float32 and tv.dim() == 0
        np.testing.assert_allclose(float(tv), jv, rtol=RTOL, atol=ATOL, err_msg=f"step {s}")
    # integer step counters (the train state's) work the same
    np.testing.assert_allclose(float(ts(torch.tensor(31, dtype=torch.int32))),
                               float(js(jnp.int32(31))), rtol=RTOL, atol=ATOL)


def test_get_schedule_refuses_unknown():
    with pytest.raises(ValueError, match="unknown schedule"):
        tsched.get_schedule("cyclic", lr=0.1)
