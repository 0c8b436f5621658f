"""The port's 3x3/stride-1 max pool (theanompi_tpu_torch/ops/pool.py)
against the reference's (theanompi_tpu/ops/pallas_pool.py): the plain
forward and all-maxima backward, bit for bit, in fp32 and bf16, on
tie-free, tie-heavy, NaN/inf and border inputs, against both of the
reference's routes — its Pallas kernels (in interpret mode, as
tests/test_pallas_pool.py runs them, ``TMPI_PALLAS_POOL=1``) and its jnp
fallback (``TMPI_PALLAS=0``). Then the routing rules, ``nn.Pool``'s
opt-in, and the route-off gradient against the reference's
select-and-scatter.

"Bit for bit" means every element's bit pattern, except that a NaN
matches any NaN (its payload is the hardware's). Every input is free of
-0.0: of +0 and -0, which the max may return is not pinned down.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu import nn as jnn
from theanompi_tpu.ops import pallas_pool as jpool
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.ops import pool as tpool

SHAPES = [(2, 8, 8, 16), (3, 7, 5, 130), (1, 14, 14, 528)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ROUTES = {"pallas": {"TMPI_PALLAS_POOL": "1", "TMPI_PALLAS": "1"},
          "jnp": {"TMPI_PALLAS_POOL": "1", "TMPI_PALLAS": "0"}}


def _input(kind: str, shape, seed=0) -> np.ndarray:
    """fp32 values; exact in bf16 for every kind but ``tie_free``."""
    r = np.random.RandomState(seed)
    if kind == "tie_free":  # all distinct
        vals = np.arange(np.prod(shape), dtype=np.float32)
        r.shuffle(vals)
        return (vals.reshape(shape) / vals.size - 0.5).astype(np.float32)
    if kind == "tie_heavy":  # post-ReLU zeros and a few levels
        return (np.maximum(np.round(r.randn(*shape) * 2) / 2, 0.0) + 0.0).astype(np.float32)
    x = r.randn(*shape).astype(np.float32)
    if kind == "nan_inf":  # sparse NaN, +inf and -inf
        u = r.rand(*shape)
        x[u < 0.02] = np.nan
        x[(u >= 0.02) & (u < 0.04)] = np.inf
        x[(u >= 0.04) & (u < 0.06)] = -np.inf
        return x
    if kind == "border":  # the frame's own value, -inf and ties along the edges
        x[:, 0, :, :] = -np.inf
        x[:, -1, :, :] = 0.0
        x[:, :, 0, :] = -3.3895313892515355e38  # -max of bf16 (above fp32's -max)
        x[:, :, -1, :] = -np.finfo(np.float32).max
        return x
    raise ValueError(kind)


def _as(x: np.ndarray, dtype: str):
    """The same values in both packages: rounded to the dtype once, by torch."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _bits(a) -> tuple:
    """(NaN mask, bit patterns with NaNs zeroed) of a torch tensor or a
    numpy/JAX array."""
    if isinstance(a, torch.Tensor):
        nan = torch.isnan(a.float()).numpy()
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
    else:
        a = np.asarray(a)
        nan = np.isnan(a.astype(np.float32))
        a = a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)
    return nan, np.where(nan, 0, a.astype(np.int64) & (0xFFFF if a.dtype.itemsize == 2 else
                                                        0xFFFFFFFF))


def _assert_bits_equal(got, want, what):
    gn, gb = _bits(got)
    wn, wb = _bits(want)
    assert gn.shape == wn.shape, what
    assert np.array_equal(gn, wn), f"{what}: NaN positions differ"
    bad = np.flatnonzero(gb != wb)
    assert bad.size == 0, f"{what}: {bad.size} elements differ, first at {bad[:5]}"


def _reference(x_j, g_j, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    y, vjp = jax.vjp(jpool.maxpool3x3_s1, x_j)
    (dx,) = vjp(g_j)
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["tie_free", "tie_heavy", "nan_inf", "border"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_pool_is_the_references_bit_for_bit(shape, kind, dtype, route, monkeypatch):
    x, x_j = _as(_input(kind, shape), dtype)
    g, g_j = _as(np.random.RandomState(1).randn(*shape).astype(np.float32), dtype)
    y_ref, dx_ref = _reference(x_j, g_j, ROUTES[route], monkeypatch)

    y = tpool.maxpool3x3_fwd_plain(x)
    dx = tpool.maxpool3x3_bwd_plain(x, y, g)
    assert y.dtype == dx.dtype == x.dtype and y.shape == dx.shape == x.shape
    _assert_bits_equal(y, y_ref, "forward")
    _assert_bits_equal(dx, dx_ref, "backward")
    # the wrappers and the autograd Function take the plain versions on the CPU
    xt = x.clone().requires_grad_(True)
    yt = tpool.maxpool3x3_s1(xt)
    (dxt,) = torch.autograd.grad(yt, xt, g)
    _assert_bits_equal(yt.detach(), y_ref, "maxpool3x3_s1 forward")
    _assert_bits_equal(dxt, dx_ref, "maxpool3x3_s1 backward")


def test_ties_send_the_gradient_to_every_maximum():
    """A constant map: every window is an all-way tie, so dx[p] is the
    sum of g over the windows that hold p (Theano's semantics)."""
    x = torch.ones(1, 4, 4, 1)
    g = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    dx = tpool.maxpool3x3_bwd_plain(x, tpool.maxpool3x3_fwd_plain(x), g)
    want = torch.nn.functional.avg_pool2d(
        g.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=True, divisor_override=1)
    torch.testing.assert_close(dx, want.permute(0, 2, 3, 1), rtol=0, atol=0)


def test_an_all_minus_inf_window_follows_the_tpu_kernel(monkeypatch):
    """Inside the map, a window of nothing but -inf gives -inf, as the TPU
    kernel computes it (its frame is -max, not an init value); at the
    border the frame's -max wins."""
    x = torch.full((1, 4, 4, 2), -float("inf"))
    monkeypatch.setenv("TMPI_PALLAS_POOL", "1")
    y_ref = np.asarray(jpool.maxpool3x3_s1(jnp.asarray(x.numpy())))
    y = tpool.maxpool3x3_fwd_plain(x)
    _assert_bits_equal(y, y_ref, "forward")
    assert torch.isneginf(y[0, 1:3, 1:3]).all()
    assert (y[0, 0] == -torch.finfo(torch.float32).max).all()


def test_routing_rules_are_the_references_without_a_switch(monkeypatch):
    monkeypatch.setenv("TMPI_PALLAS_POOL", "1")
    x_t = torch.zeros(2, 8, 8, 4)
    x_j = jnp.zeros((2, 8, 8, 4))
    big_t = torch.empty(1, 65, 64, 4, device="meta")
    big_j = jax.ShapeDtypeStruct((1, 65, 64, 4), jnp.float32)
    edge_t = torch.empty(1, 64, 64, 4, device="meta")
    edge_j = jax.ShapeDtypeStruct((1, 64, 64, 4), jnp.float32)
    cases = [
        ((3, 3), (1, 1), "SAME", True),
        ((3, 3), (1, 1), 1, True),
        ((3, 3), (1, 1), (1, 1), True),
        ((3, 3), (2, 2), "SAME", False),  # strided
        ((2, 2), (1, 1), "SAME", False),  # another window
        ((3, 3), (1, 1), "VALID", False),  # not SAME-equivalent
        ((3, 3), (1, 1), 0, False),
        ((3, 3), (1, 1), (1, 0), False),
        ((3, 3), (1, 1), 2, False),
    ]
    for window, stride, padding, want in cases:
        assert tpool.routable(window, stride, padding, x_t) is want, (window, stride, padding)
        assert jpool.routable(window, stride, padding, x_j) is want, (window, stride, padding)
    for t, j, want in ((big_t, big_j, False), (edge_t, edge_j, True)):
        assert tpool.routable((3, 3), (1, 1), "SAME", t) is want
        assert jpool.routable((3, 3), (1, 1), "SAME", j) is want
    assert not tpool.routable((3, 3), (1, 1), "SAME", torch.zeros(8, 8, 4))  # not 4-D
    # no environment switch: the port's rule holds with the reference's off
    monkeypatch.setenv("TMPI_PALLAS_POOL", "0")
    assert not jpool.routable((3, 3), (1, 1), "SAME", x_j)
    assert tpool.routable((3, 3), (1, 1), "SAME", x_t)


def _layer_grad(pool, x: np.ndarray, g: np.ndarray) -> np.ndarray:
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = pool.apply({}, {}, xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return dx.numpy()


def test_nn_pool_routes_only_when_asked(monkeypatch):
    """``kernel=True`` takes the all-maxima route (the reference's layer
    under TMPI_PALLAS_POOL=1); without it the layer keeps F.max_pool2d,
    whose first-maximum gradient is the reference's select-and-scatter
    (its layer without the switch). On tie-heavy input the two routes'
    gradients differ."""
    shape = (2, 8, 8, 16)
    x = _input("tie_heavy", shape, seed=3)
    g = np.random.RandomState(4).randn(*shape).astype(np.float32)
    on = tnn.Pool(3, stride=1, padding=1, mode="max", kernel=True)
    off = tnn.Pool(3, stride=1, padding=1, mode="max")
    assert on.routes_to_kernel(torch.from_numpy(x)) and not off.routes_to_kernel(torch.from_numpy(x))
    assert not tnn.Pool(3, stride=2, padding=1, kernel=True).routes_to_kernel(torch.from_numpy(x))
    with pytest.raises(ValueError, match="max pool"):
        tnn.Pool(3, stride=1, padding=1, mode="avg", kernel=True)

    jlayer = jnn.Pool(3, stride=1, padding=1, mode="max")

    def ref_grad():
        _, vjp = jax.vjp(lambda a: jlayer.apply({}, {}, a)[0], jnp.asarray(x))
        return np.asarray(vjp(jnp.asarray(g))[0])

    monkeypatch.setenv("TMPI_PALLAS_POOL", "1")
    want_on = ref_grad()
    monkeypatch.setenv("TMPI_PALLAS_POOL", "0")
    want_off = ref_grad()
    got_on, got_off = _layer_grad(on, x, g), _layer_grad(off, x, g)
    np.testing.assert_array_equal(got_on, want_on)
    np.testing.assert_array_equal(got_off, want_off)
    assert not np.array_equal(got_on, got_off), "the tie-heavy input shows no tie"
    # the forward is the same function on both routes
    y_on, _ = on.apply({}, {}, torch.from_numpy(x))
    y_off, _ = off.apply({}, {}, torch.from_numpy(x))
    assert torch.equal(y_on, y_off)
