"""Fused optimizer epilogue of the PyTorch port (theanompi_tpu_torch/
ops/fused_update.py) against the JAX reference (ops/pallas_update.py,
whose Pallas kernels run in interpret mode on the CPU).

On the CPU the port's wrappers run their plain versions; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.

Tolerances (stated per check; ulps at the leaf's scale, see assert_ulp):
- one step of one leaf, fp32 params and the fp32 velocity: 1 fp32 ulp.
  Both sides compute the same expression chain in the same order; the
  reference is a different XLA program, which may contract a multiply-add.
- bf16 params: 1 bf16 ulp (both round p + step once to bf16, but the
  fp32 value rounded may itself differ by an fp32 ulp).
- chained steps and clipped updates: a few ulps more, as stated at the
  check (errors carry from step to step; the clip coefficient is a global
  sum taken in a different order on each side).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.ops import pallas_update as jfu
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.ops import fused_update as tfu

LR = 0.05
SHAPES = [(37, 129), (13,), (1,)]  # awkward for the TPU's lane layout


def _arr(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def assert_ulp(ref, got, maxulp, bf16=False):
    """|ref - got| <= maxulp units in the last place at the leaf's scale
    (the ulp of its largest magnitude; bf16 ulps for bf16). A contracted
    multiply-add errs by an ulp of its OPERANDS, so a result that cancels
    to near zero is held to the leaf's scale, not to its own ulp."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    scale = np.float32(np.max(np.abs(ref))) if ref.size else np.float32(0)
    ulp = np.spacing(scale) * (2.0 ** 16 if bf16 else 1.0)
    err = float(np.max(np.abs(ref - got))) if ref.size else 0.0
    assert err <= maxulp * ulp, f"max |err| {err} > {maxulp} ulp ({ulp}) at scale {scale}"


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd,coef", [(0.0, 1.0), (0.01, 1.0), (0.01, 0.37)])
def test_momentum_leaf_matches_reference(shape, dtype, nesterov, wd, coef):
    p, v, g = _arr(0, shape), _arr(1, shape, 0.1), _arr(2, shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jp, jv = jfu.fused_update_leaf(
        _to_jax(p, jdt), jnp.asarray(v), _to_jax(g, jdt), jnp.float32(LR), jnp.float32(coef),
        momentum=0.9, weight_decay=wd, nesterov=nesterov,
    )
    tp, tv, tg = _to_torch(p, tdt), torch.from_numpy(v.copy()), _to_torch(g, tdt)
    out_p, out_v = tfu.fused_update_leaf(
        tp, tv, tg, tfu.scalars(LR, coef, "cpu"),
        momentum=0.9, weight_decay=wd, nesterov=nesterov,
    )
    assert out_p is tp and out_v is tv  # in place
    assert tp.dtype == tdt and tv.dtype == torch.float32
    assert_ulp(np.asarray(jv), _np(tv), 1)
    assert_ulp(np.asarray(jp.astype(jnp.float32)), _np(tp), 1, bf16=dtype == "bfloat16")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_leaf_matches_reference(shape, dtype):
    p, g = _arr(3, shape), _arr(4, shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jp = jfu.fused_sgd_leaf(_to_jax(p, jdt), _to_jax(g, jdt), jnp.float32(LR),
                            jnp.float32(0.5), weight_decay=0.02)
    tp = _to_torch(p, tdt)
    tfu.fused_sgd_leaf(tp, _to_torch(g, tdt), tfu.scalars(LR, 0.5, "cpu"), weight_decay=0.02)
    assert_ulp(np.asarray(jp.astype(jnp.float32)), _np(tp), 1, bf16=dtype == "bfloat16")


def _tree(seed, dtype=np.float32):
    r = np.random.RandomState(seed)
    return {"w": r.randn(37, 129).astype(dtype), "b": r.randn(13).astype(dtype),
            "s": r.randn(1).astype(dtype)}


def _run_both(name, kwargs, grads_np, steps=3, param_dtype="float32"):
    """``steps`` fused applies on both sides from the same params."""
    params_np = _tree(0)
    jdt, tdt = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    jo = jfu.fuse_optimizer(name, **kwargs)
    to = tfu.fuse_optimizer(name, **kwargs)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), params_np)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), grads_np)
    js = jo.init(jp)
    tp = {k: _to_torch(a, tdt) for k, a in params_np.items()}
    tg = {k: _to_torch(a, tdt) for k, a in grads_np.items()}
    ts = to.init(tp)
    for _ in range(steps):
        jp, js = jo.apply(jg, js, jp, jnp.float32(LR))
        tp, ts = to.apply(tg, ts, tp, torch.tensor(LR))
    return jp, js, tp, ts


@pytest.mark.parametrize("name,kwargs", [
    ("momentum", {"momentum": 0.9, "weight_decay": 5e-4}),
    ("nesterov", {"momentum": 0.95, "weight_decay": 0.01}),
    ("sgd", {"weight_decay": 0.02}),
    ("momentum", {"momentum": 0.9, "weight_decay": 0.01, "clip_norm": 2.0}),
])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_fused_builders_match_reference(name, kwargs, param_dtype):
    jp, js, tp, ts = _run_both(name, kwargs, _tree(1), param_dtype=param_dtype)
    assert to_names(ts) == to_names(js)
    # 3 chained steps: each step's input may already differ by an ulp;
    # with a clip, the global-norm coefficient is summed in a different
    # order on each side and differs by a few fp32 ulps besides
    ulps = 6 if "clip_norm" in kwargs else 3
    for k in tp:
        assert_ulp(np.asarray(jp[k].astype(jnp.float32)), _np(tp[k]), ulps,
                   bf16=param_dtype == "bfloat16")
    if name != "sgd":
        for k in tp:
            assert_ulp(np.asarray(js["vel"][k]), _np(ts["vel"][k]), ulps)


def to_names(state):
    return sorted(state) if isinstance(state, dict) else state


@pytest.mark.parametrize("name,kwargs", [
    ("momentum", {"momentum": 0.9, "weight_decay": 0.01}),
    ("nesterov", {"momentum": 0.9, "clip_norm": 1.0}),
    ("sgd", {"weight_decay": 0.02, "clip_norm": 3.0}),
])
def test_fused_update_reference_math_matches(name, kwargs):
    """``update`` (the tree-map oracle) agrees with the reference's."""
    params, grads = _tree(2), _tree(3)
    jo, to = jfu.fuse_optimizer(name, **kwargs), tfu.fuse_optimizer(name, **kwargs)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {k: torch.from_numpy(a.copy()) for k, a in params.items()}
    ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), jo.init(jp), jp, jnp.float32(LR))
    tu, ts = to.update({k: torch.from_numpy(a.copy()) for k, a in grads.items()},
                       to.init(tp), tp, torch.tensor(LR))
    # the clip coefficient's global sum runs in a different order on
    # each side: a few fp32 ulps on top of the 1-ulp expression bar
    ulps = 4 if "clip_norm" in kwargs else 1
    for k in params:
        assert_ulp(np.asarray(ju[k]), _np(tu[k]), ulps)


def test_clip_zero_norm_is_identity_and_finite():
    zeros = {k: np.zeros_like(a) for k, a in _tree(0).items()}
    coef = tfu.clip_coefficient({k: torch.from_numpy(a) for k, a in zeros.items()}, 1.0)
    assert coef.dtype == torch.float32 and float(coef) == 1.0
    jcoef = jfu.clip_coefficient(jax.tree_util.tree_map(jnp.asarray, zeros), 1.0)
    assert float(jcoef) == float(coef)
    # zero grads, no decay: params untouched, nothing NaN'd
    to = tfu.fused_momentum_sgd(momentum=0.9, clip_norm=1.0)
    params = {k: torch.from_numpy(a.copy()) for k, a in _tree(1).items()}
    before = {k: t.clone() for k, t in params.items()}
    to.apply({k: torch.from_numpy(a) for k, a in zeros.items()}, to.init(params), params,
             torch.tensor(LR))
    assert all(torch.equal(params[k], before[k]) for k in params)


def test_clip_norm_above_limit_scales_globally():
    grads = _tree(1)
    gnorm = float(np.sqrt(sum(np.sum(np.square(a)) for a in grads.values())))
    clip = gnorm / 3.0
    tcoef = tfu.clip_coefficient({k: torch.from_numpy(a) for k, a in grads.items()}, clip)
    jcoef = jfu.clip_coefficient(jax.tree_util.tree_map(jnp.asarray, grads), clip)
    # reductions summed in different orders: a few fp32 ulps
    np.testing.assert_allclose(float(tcoef), 1.0 / 3.0, rtol=1e-5)
    np.testing.assert_allclose(float(tcoef), float(jcoef), rtol=1e-6)
    assert float(tfu.clip_coefficient({k: torch.from_numpy(a) for k, a in grads.items()},
                                      gnorm * 10)) == 1.0


def test_fuse_optimizer_refuses_unfused_rules():
    for name in ("adam", "rmsprop"):
        with pytest.raises(ValueError, match="no fused kernel"):
            tfu.fuse_optimizer(name)


def test_cpu_path_does_not_count_launches_and_other_devices_raise():
    tfu.MOMENTUM.reset()
    p, v, g = torch.ones(5), torch.zeros(5), torch.ones(5)
    tfu.fused_update_leaf(p, v, g, tfu.scalars(LR, 1.0, "cpu"), momentum=0.9,
                          weight_decay=0.0, nesterov=False)
    assert tfu.MOMENTUM.launches == 0  # the plain version ran, not the kernel
    meta = torch.empty(5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_update_leaf(meta, meta, meta, torch.empty(2, device="meta"),
                              momentum=0.9, weight_decay=0.0, nesterov=False)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_sgd_leaf(meta, meta, torch.empty(2, device="meta"), weight_decay=0.0)


def test_bridge_roundtrip_of_velocity_state():
    vel = {"00_conv": {"w": _arr(5, (3, 3, 2, 4)), "b": _arr(6, (4,))}}
    back = bridge.opt_state_to_jax(bridge.opt_state_from_jax({"vel": vel}))
    assert bridge.opt_state_from_jax({"vel": vel})["vel"]["00_conv"]["w"].shape == (4, 2, 3, 3)
    for k in ("w", "b"):
        np.testing.assert_array_equal(back["vel"]["00_conv"][k], vel["00_conv"][k])
