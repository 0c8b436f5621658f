"""Layers of the PyTorch port (theanompi_tpu_torch/nn/layers.py) against
the JAX reference (theanompi_tpu/nn/layers.py): forward and VJP on the
same numpy inputs and cotangents, with the reference's weights carried
across by theanompi_tpu_torch/bridge.py.

Tolerance, fp32: rtol 1e-5 / atol 1e-5 — the convolutions, matmuls and
pools sum in a different order in XLA and in PyTorch's CPU kernels, so
outputs agree to a few fp32 ulps of the sums' magnitudes (O(1) here).
bf16 (the Sequential test): rtol/atol 5e-2 — both sides round every
intermediate to bf16 (8 significant bits), at different points.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu import nn as jnn
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.tree import tree_leaves

RTOL = ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _fwd_vjp_jax(layer, params, x, ct, dtype=jnp.float32):
    def f(p, xx):
        y, _ = layer.apply(p, {}, xx.astype(dtype), train=False)
        return y.astype(jnp.float32)

    @jax.jit
    def run(p, xx, c):
        y, vjp = jax.vjp(f, p, xx)
        return y, vjp(c)

    y, (gp, gx) = run(params, jnp.asarray(x), jnp.asarray(ct))
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)


def _fwd_vjp_torch(layer, params, x, ct, dtype=torch.float32):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y, _ = layer.apply(params, {}, xt.to(dtype), train=False)
    y = y.float()
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(y, [xt, *leaves], grad_outputs=torch.from_numpy(ct.copy()))
    it = iter(grads[1:])
    gp = jax.tree_util.tree_map(lambda _: next(it), params)
    return y.detach().numpy(), bridge.tree_to_jax(gp), grads[0].numpy()


def _check_layer(jlayer, tlayer, in_shape, seed=0, rtol=RTOL, atol=ATOL):
    jp, _ = jlayer.init(jax.random.PRNGKey(seed), in_shape)
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    tp = bridge.params_from_jax(jp_np)
    out_shape = jlayer.out_shape(in_shape)
    assert tlayer.out_shape(in_shape) == out_shape
    x, ct = _x(in_shape, seed + 1), _x(out_shape, seed + 2)
    yj, gpj, gxj = _fwd_vjp_jax(jlayer, jp, x, ct)
    yt, gpt, gxt = _fwd_vjp_torch(tlayer, tp, x, ct)
    assert yt.shape == tuple(out_shape)
    np.testing.assert_allclose(yt, yj, rtol=rtol, atol=atol, err_msg="forward")
    np.testing.assert_allclose(gxt, gxj, rtol=rtol, atol=atol, err_msg="input grad")
    for a, b in zip(jax.tree_util.tree_leaves(gpt), jax.tree_util.tree_leaves(gpj)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg="param grad")


@pytest.mark.parametrize("kw,in_shape", [
    # AlexNet's conv1: stride 4, VALID
    (dict(out_channels=8, kernel=11, stride=4, padding="VALID"), (2, 27, 27, 3)),
    # conv2-style grouped conv with explicit padding
    (dict(out_channels=8, kernel=5, padding=2, groups=2), (2, 9, 9, 6)),
    # groups=2, VALID: the HWIO->OIHW mapping across groups
    (dict(out_channels=6, kernel=3, padding="VALID", groups=2), (2, 7, 7, 4)),
    # SAME with stride 2 on an even size: asymmetric (0, 1) padding
    (dict(out_channels=5, kernel=3, stride=2, padding="SAME"), (2, 8, 8, 3)),
    # SAME, stride 1, even kernel: asymmetric too
    (dict(out_channels=4, kernel=4, stride=1, padding="SAME"), (1, 6, 5, 2)),
])
def test_conv_matches_reference(kw, in_shape):
    _check_layer(jnn.Conv(**kw), tnn.Conv(**kw), in_shape)


@pytest.mark.parametrize("kw,in_shape", [
    (dict(window=3, stride=2, mode="max"), (2, 9, 9, 4)),  # AlexNet's pool
    (dict(window=2, mode="max"), (2, 8, 8, 3)),
    (dict(window=3, stride=2, padding="SAME", mode="max"), (2, 8, 8, 3)),
    (dict(window=3, stride=1, padding=1, mode="max"), (1, 5, 5, 2)),
    (dict(window=3, stride=2, mode="avg"), (2, 9, 9, 4)),
    (dict(window=3, stride=1, padding=1, mode="avg"), (1, 5, 5, 2)),
    (dict(window=3, stride=2, padding="SAME", mode="avg"), (2, 8, 7, 3)),
])
def test_pool_matches_reference(kw, in_shape):
    _check_layer(jnn.Pool(**kw), tnn.Pool(**kw), in_shape)


@pytest.mark.parametrize("beta", [0.75, 0.5])
def test_lrn_matches_reference(beta):
    kw = dict(n=5, alpha=1e-2, beta=beta, k=2.0)  # alpha large enough to matter
    _check_layer(jnn.LRN(**kw), tnn.LRN(**kw), (2, 4, 4, 12))


def test_dense_and_flatten_order_match_reference():
    """Flatten runs over NHWC (h, w, c) on both sides, so a Dense after it
    takes the reference's weight rows unchanged."""
    jseq = jnn.Sequential([jnn.Flatten(), jnn.Dense(7, name="fc")])
    tseq = tnn.Sequential([tnn.Flatten(), tnn.Dense(7, name="fc")])
    _check_layer(jseq, tseq, (3, 2, 3, 4))


@pytest.mark.parametrize("fn", ["relu", "gelu", "tanh", "sigmoid", "identity"])
def test_activation_matches_reference(fn):
    _check_layer(jnn.Activation(fn), tnn.Activation(fn), (2, 3, 3, 4))


def test_gelu_in_bf16_is_the_references_bit_for_bit():
    """``jax.nn.gelu`` rounds after every op in bf16 (the LM's compute
    dtype); the port's ``gelu`` does the same, so it is the reference's to
    the bit over a wide range. (fp32 differs in the last bits, as XLA's
    tanh does: ``test_activation_matches_reference`` holds it.)"""
    r = np.random.RandomState(0)
    x = np.concatenate([r.randn(50000) * s for s in (0.3, 1.0, 3.0, 10.0)]).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tnn.layers.gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_global_avg_pool_and_batchnorm_match_reference():
    _check_layer(jnn.GlobalAvgPool(), tnn.GlobalAvgPool(), (2, 3, 3, 4))
    jbn, tbn = jnn.BatchNorm(), tnn.BatchNorm()
    jp, js = jbn.init(jax.random.PRNGKey(0), (4, 3, 3, 5))
    tp, ts = tbn.init(None, (4, 3, 3, 5))
    x = _x((4, 3, 3, 5))
    for train in (True, False):
        yj, sj = jbn.apply(jp, js, jnp.asarray(x), train=train)
        yt, st = tbn.apply(tp, ts, torch.from_numpy(x), train=train)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=RTOL, atol=ATOL)


def _narrow_alexnet(lib, ncls=10):
    """AlexNet's layer pattern at narrow widths, dropout omitted."""
    g = lib.init.gaussian
    one = lib.init.constant(1.0)
    return lib.Sequential([
        lib.Conv(8, 11, stride=4, padding="VALID", w_init=g(0.1), name="conv1"),
        lib.Activation("relu"),
        lib.LRN(n=5, alpha=1e-4, beta=0.75, k=2.0),
        lib.Pool(3, stride=2, mode="max"),
        lib.Conv(8, 5, padding=2, groups=2, w_init=g(0.1), b_init=one, name="conv2"),
        lib.Activation("relu"),
        lib.LRN(n=5, alpha=1e-4, beta=0.75, k=2.0),
        lib.Pool(3, stride=2, mode="max"),
        lib.Conv(12, 3, padding=1, w_init=g(0.1), name="conv3"),
        lib.Activation("relu"),
        lib.Conv(12, 3, padding=1, groups=2, w_init=g(0.1), b_init=one, name="conv4"),
        lib.Activation("relu"),
        lib.Conv(8, 3, padding=1, groups=2, w_init=g(0.1), b_init=one, name="conv5"),
        lib.Activation("relu"),
        lib.Pool(3, stride=2, mode="max"),
        lib.Flatten(),
        lib.Dense(16, w_init=g(0.05), b_init=one, name="fc6"),
        lib.Activation("relu"),
        lib.Dense(16, w_init=g(0.05), b_init=one, name="fc7"),
        lib.Activation("relu"),
        lib.Dense(ncls, w_init=g(0.1), name="fc8"),
    ])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_narrow_alexnet_sequential_matches_reference(dtype, tol):
    """Forward and VJP of the whole AlexNet pattern; compute in ``dtype``
    with fp32 params (the reference's bf16 recipe). fp32: 1e-4 — errors
    of each layer's sums compound over 21 layers."""
    jseq, tseq = _narrow_alexnet(jnn), _narrow_alexnet(tnn)
    in_shape = (2, 67, 67, 3)
    jp, _ = jseq.init(jax.random.PRNGKey(0), in_shape)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert sorted(tp) == sorted(jp)
    x, ct = _x(in_shape, 1), _x(jseq.out_shape(in_shape), 2)
    yj, gpj, gxj = _fwd_vjp_jax(jseq, jp, x, ct, dtype=getattr(jnp, dtype))
    yt, gpt, gxt = _fwd_vjp_torch(tseq, tp, x, ct, dtype=getattr(torch, dtype))
    scale = float(np.max(np.abs(yj)))
    np.testing.assert_allclose(yt, yj, rtol=tol, atol=tol * scale)
    for name in ("00_conv1", "04_conv2", "16_fc6", "20_fc8"):
        for k in ("w", "b"):
            a, b = gpt[name][k], np.asarray(gpj[name][k])
            assert a.dtype == np.float32  # grads come back in the param dtype
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * float(np.max(np.abs(b))),
                                       err_msg=f"{name}/{k}")


def test_bridge_roundtrip_is_exact_and_conv_layout_is_oihw():
    jseq = _narrow_alexnet(jnn)
    jp = jax.tree_util.tree_map(np.asarray, jseq.init(jax.random.PRNGKey(3), (1, 67, 67, 3))[0])
    tp = bridge.params_from_jax(jp)
    assert tuple(tp["04_conv2"]["w"].shape) == (8, 4, 5, 5)  # OIHW, I = cin/groups
    assert tp["04_conv2"]["w"].requires_grad
    back = bridge.params_to_jax(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_dropout_mask_distribution_and_eval_identity():
    layer = tnn.Dropout(0.3)
    x = torch.ones(200, 500)
    y, _ = layer.apply({}, {}, x, train=True, gen=torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    # 100k Bernoulli(0.7) draws: std of the mean ~1.4e-3
    assert abs(kept - 0.7) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.7, rtol=1e-6)
    # the same generator state gives the same mask; eval mode is the identity
    y2, _ = layer.apply({}, {}, x, train=True, gen=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    ye, _ = layer.apply({}, {}, x, train=False)
    assert ye is x
    with pytest.raises(ValueError, match="generator"):
        layer.apply({}, {}, x, train=True)


def test_conv_group_mismatch_and_even_lrn_refused():
    with pytest.raises(ValueError, match="groups"):
        tnn.Conv(6, 3, groups=4).init(torch.Generator(), (1, 5, 5, 6))
    with pytest.raises(ValueError, match="odd"):
        tnn.LRN(n=4)
