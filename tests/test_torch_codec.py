"""The port's wire codecs (``theanompi_tpu_torch/parallel/codec.py``)
against the JAX package's ``parallel/codec.py``: spec parsing and its
refusals, value-space qdq, compress with and without error feedback on
a parameter-shaped tree (a conv kernel included, carried across with the
bridge), the residuals' shape, and the gossip message packing.

Tolerance: none — int8 and bf16 quantize and dequantize in the same
order on both sides, so every output is bit-identical."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.parallel import codec as jc
from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.nn.layers import PLAIN
from theanompi_tpu_torch.parallel import codec as tc


def _tree(seed):
    """A gradient-shaped tree in the reference's layout: a conv kernel
    (HWIO), a 1-element bias, odd and multi-row leaves, with magnitudes
    spread so the int8 block scales differ."""
    r = np.random.RandomState(seed)
    return {
        "conv": {"w": (r.randn(3, 3, 4, 6) * 0.1).astype(np.float32),
                 "b": r.randn(1).astype(np.float32)},
        "fc": {"w": (r.randn(20, 33) * np.exp(r.randn(20, 1))).astype(np.float32),
               "b": r.randn(7).astype(np.float32)},
    }


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree_equal(port_tree, ref_tree):
    got = jax.tree_util.tree_leaves(bridge.tree_to_jax(port_tree))
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == np.shape(b)
        np.testing.assert_array_equal(a, np.asarray(b))


def test_get_codec_parsing_and_refusals_match_the_reference():
    for spec in (None, "none", "bf16", "int8", "bf16:ef", "int8:ef", ""):
        t, j = tc.get_codec(spec), jc.get_codec(spec)
        assert (t.name, t.error_feedback, t.spec, t.active) == (j.name, j.error_feedback,
                                                                 j.spec, j.active)
        assert t.wire_bytes_per_element == j.wire_bytes_per_element
        assert tc.get_codec(t) is t
    assert tc.CODEC_WIRE_BYTES == jc.CODEC_WIRE_BYTES
    for bad, match in (("fp4", "unknown wire codec"), ("none:ef", "meaningless"),
                       ("int8:feedback", "suffix")):
        with pytest.raises(ValueError, match=match):
            jc.get_codec(bad)
        with pytest.raises(ValueError, match=match):
            tc.get_codec(bad)


@pytest.mark.parametrize("spec", ["none", "bf16", "int8"])
def test_qdq_bit_identical(spec):
    tree = _tree(0)
    for leaf in jax.tree_util.tree_leaves(tree):
        ref = jc.get_codec(spec).qdq(jnp.asarray(leaf))
        got = tc.get_codec(spec).qdq(bridge.tree_from_jax(leaf))
        np.testing.assert_array_equal(bridge.tree_to_jax(got), np.asarray(ref))


@pytest.mark.parametrize("spec", ["bf16", "int8", "bf16:ef", "int8:ef"])
def test_compress_bit_identical_over_rounds(spec):
    """Three rounds of compress on changing gradients: the wire tree and
    (with :ef) the carried residual stay bit-identical to the reference."""
    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)
    tree0 = _tree(1)
    jef = jcodec.init_ef(_to_jax(tree0))
    tef = tcodec.init_ef(bridge.tree_from_jax(tree0))
    if tcodec.error_feedback:
        _assert_tree_equal(tef, jef)  # zeros, one f32 per leaf, each leaf's layout
        assert tef["conv"]["w"].is_contiguous(memory_format=torch.channels_last)
    else:
        assert tef == () == jef
    for rnd in range(3):
        tree = _tree(10 + rnd)
        jwire, jef = jcodec.compress(_to_jax(tree), jef)
        twire, tef = tcodec.compress(bridge.tree_from_jax(tree), tef,
                                     bridge.default_layouts(tree))
        _assert_tree_equal(twire, jwire)
        if tcodec.error_feedback:
            _assert_tree_equal(tef, jef)
        else:
            assert tef == ()


def test_compress_stacked_residual_is_the_ranks_own():
    """The reference keeps the residuals stacked [n, ...] and each device
    compresses with its [1, ...] slice; a port rank holds that slice
    unstacked. Same residual in -> same wire and residual out."""
    jcodec, tcodec = jc.get_codec("int8:ef"), tc.get_codec("int8:ef")
    tree = _tree(2)
    ef = jax.tree_util.tree_map(lambda a: (a * 0.01).astype(np.float32), _tree(3))
    jwire, jef = jcodec.compress_stacked(_to_jax(tree), jax.tree_util.tree_map(
        lambda a: jnp.asarray(a)[None], ef))
    twire, tef = tcodec.compress(bridge.tree_from_jax(tree), bridge.tree_from_jax(ef),
                                 bridge.default_layouts(tree))
    _assert_tree_equal(twire, jwire)
    _assert_tree_equal(tef, jax.tree_util.tree_map(lambda a: a[0], jef))


def test_error_feedback_telescopes():
    """v + r == Q(v + r) + r' exactly: what the quantizer discards this
    round is what rides into the next."""
    codec = tc.get_codec("int8:ef")
    r = np.random.RandomState(0)
    v = torch.from_numpy(r.randn(300).astype(np.float32) * 5.0)
    ef = torch.from_numpy(r.randn(300).astype(np.float32) * 0.01)
    q, ef2 = codec.compress_leaf(v, ef)
    assert torch.equal(q + ef2, v + ef)
    tree, ef_out = tc.get_codec("int8").compress({"w": v}, (), {"w": PLAIN})
    assert ef_out == ()
    with pytest.raises(ValueError, match="init_ef"):
        codec.compress({"w": v, "b": v}, {"w": ef}, {"w": PLAIN, "b": PLAIN})


@pytest.mark.parametrize("spec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("length", [1, 130, 700])
def test_gossip_messages_bit_identical(spec, length):
    r = np.random.RandomState(length)
    values = (r.randn(length) * 3).astype(np.float32)
    share = np.float32(0.3125 + length * 1e-3)
    jmsg = jc.gossip_encode(jc.get_codec(spec), jnp.asarray(values), jnp.asarray(share))
    tmsg = tc.gossip_encode(tc.get_codec(spec), torch.from_numpy(values.copy()),
                            torch.tensor(share))
    got = tmsg.float().numpy() if tmsg.dtype == torch.bfloat16 else tmsg.numpy()
    np.testing.assert_array_equal(got, np.asarray(jmsg, dtype=got.dtype))
    assert tc.gossip_wire_bytes(tc.get_codec(spec), length) == \
        jc.gossip_wire_bytes(jc.get_codec(spec), length) == tmsg.numel() * tmsg.element_size()
    jv, js = jc.gossip_decode(jc.get_codec(spec), jmsg, length)
    tv, ts = tc.gossip_decode(tc.get_codec(spec), tmsg, length)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ts.item() == float(js) == share  # the share rides exact


def _lm_tree(seed):
    """An LM-shaped gradient tree: ``qkv [d, 3, H, hd]`` is 4-D but no conv
    kernel, 768 elements (six int8 blocks) with magnitudes that vary
    along every axis, so another flat order changes the blocks' scales."""
    r = np.random.RandomState(seed)

    def leaf(*shape):
        x = r.randn(*shape)
        for ax in range(x.ndim):
            x = x * np.exp(r.randn(*[s if i == ax else 1 for i, s in enumerate(shape)]))
        return x.astype(np.float32)

    return {"blocks": [{"qkv": leaf(16, 3, 2, 8), "proj": leaf(2, 8, 16), "ln1": leaf(16)}],
            "head": leaf(16, 20)}


@pytest.mark.parametrize("spec", ["int8", "int8:ef"])
def test_lm_tree_compress_follows_the_models_layouts(spec):
    """The LM's leaves (held in the reference's shapes, the 4-D ``qkv``
    included) through ``compress`` with the model's layout tags, as the
    exchange passes them: bit-identical to the reference over rounds."""
    from theanompi_tpu_torch.models.lm import TransformerLMModel

    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)

    def to_torch(tree):
        return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree)

    layouts = TransformerLMModel().param_layouts(_lm_tree(0))
    jef = jcodec.init_ef(_to_jax(_lm_tree(0)))
    tef = tcodec.init_ef(to_torch(_lm_tree(0)))
    for rnd in range(3):
        tree = _lm_tree(20 + rnd)
        jwire, jef = jcodec.compress(_to_jax(tree), jef)
        twire, tef = tcodec.compress(to_torch(tree), tef, layouts)
        for got, want in ((twire, jwire), (tef, jef)):
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
                assert tuple(a.shape) == np.shape(b)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
