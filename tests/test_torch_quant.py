"""The port's int8 quantizer (``theanompi_tpu_torch/ops/quant.py``, kernels
#3–6) against the JAX package's ``ops/pallas_quant.py``, whose Pallas
kernels run in interpret mode on the CPU.

Tolerance: none. The plain versions (what the wrappers run on CPU
tensors, and what the CUDA kernels are held to on the card) are
bit-identical to the reference: int8 values, f32 scales (NaN positions
included) and dequantized values; packed wire messages byte-identical,
and each package decodes the other's."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from theanompi_tpu.ops import pallas_quant as jq
from theanompi_tpu_torch.ops import quant as tq


def _spread(rows=4096, seed=0):
    """Row magnitudes spread over e^-20 … e^5, plus a zero row, a NaN
    row and an inf row."""
    r = np.random.RandomState(seed)
    mag = np.exp(np.linspace(-20.0, 5.0, rows)).astype(np.float32)
    x = (r.randn(rows, 128).astype(np.float32) * mag[:, None]).astype(np.float32)
    x[0] = 0.0
    x[1, 5] = np.nan
    x[2, 7] = np.inf
    x[3, 9] = -np.inf
    return x


def _specials():
    """A zero row, NaN and inf rows, a row of denormal magnitudes, a row
    of mixed signs near the clamp, and a row whose values sit exactly on
    half steps of a power-of-two scale (round half to even decides)."""
    r = np.random.RandomState(1)
    x = r.randn(8, 128).astype(np.float32)
    x[0] = 0.0
    x[1, :] = np.nan
    x[2, 3] = np.inf
    x[3] = (r.randn(128) * 1e-40).astype(np.float32)  # denormals
    x[4] = np.float32(127.0) * np.sign(r.randn(128)).astype(np.float32)
    for k in range(-8, 8):  # an amax whose scale is exactly 2^k
        amax = np.float32(127.0 * 2.0 ** k)
        if np.float32(amax) * np.float32(1 / 127) == np.float32(2.0 ** k):
            break
    else:
        raise AssertionError("no exact power-of-two scale found")
    halves = (np.arange(-127, 127) + 0.5)[:127].astype(np.float32) * np.float32(2.0 ** k)
    x[5, :127] = halves
    x[5, 127] = amax
    x[6, :] = -x[5, :]
    return x


def _torch(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, copy=True))


def _same(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("data", ["spread", "specials", "small"])
def test_block_quantizer_bit_identical_to_reference(data):
    x = {"spread": _spread, "specials": _specials,
         "small": lambda: np.random.RandomState(2).randn(3, 128).astype(np.float32)}[data]()
    jv, js = jq.quantize_int8_block(jnp.asarray(x))
    tv, ts = tq.quantize_int8_block(_torch(x))
    assert tv.dtype == torch.int8 and ts.shape == (x.shape[0], 1)
    _same(tv, jv)
    _same(ts, js)  # NaN where the reference has NaN
    _same(tq.dequantize_int8_block(tv, ts), jq.dequantize_int8_block(jv, js))


def test_block_scale_is_the_reciprocal_multiply_and_values_a_true_division():
    """The reference's scale is max(amax, 1e-30) * fl(1/127) (XLA's
    rewrite of the division by 127), not the quotient: on the spread
    input the two differ on >100 rows, and the port follows the
    reference on every one of them."""
    x = _spread()
    amax = np.abs(x).max(axis=1, keepdims=True)
    quotient = np.maximum(amax, np.float32(1e-30)) / np.float32(127.0)
    _, ts = tq.quantize_int8_block(_torch(x))
    finite = np.isfinite(quotient[:, 0])
    assert (ts.numpy()[finite] != quotient[finite]).sum() > 100
    _, js = jq.quantize_int8_block(jnp.asarray(x))
    _same(ts, js)


def test_nan_and_inf_rows_as_the_reference():
    x = _specials()
    v, s = tq.quantize_int8_block(_torch(x))
    assert np.isnan(s[1, 0].item()) and np.all(v[1].numpy() == 0)
    assert np.isinf(s[2, 0].item()) and np.all(v[2].numpy() == 0)
    assert s[0, 0].item() > 0 and np.all(v[0].numpy() == 0)  # zero row: the scale floor
    back = tq.dequantize_int8_block(v, s).numpy()
    assert np.all(np.isnan(back[1])) and np.all(back[0] == 0.0)


@pytest.mark.parametrize("data", ["random", "nan"])
def test_whole_buffer_quantizer_bit_identical_to_reference(data):
    r = np.random.RandomState(3)
    x = (r.randn(37, 128) * 3.0).astype(np.float32)
    if data == "nan":
        x[5, 5] = np.nan
    jv, js = jq.quantize_int8(jnp.asarray(x))
    tv, ts = tq.quantize_int8(_torch(x))
    assert ts.shape == (1, 1)
    _same(tv, jv)
    _same(ts, js)
    _same(tq.dequantize_int8(tv, ts), jq.dequantize_int8(jv, js))


_F32 = np.float32
# the quantizer's smallest scale (the 1e-30 floor times fl(1/127)), the
# smallest normal f32, the largest, and scales whose products overflow
_SCALES = [_F32(1e-30) * _F32(1 / 127), _F32(2.0 ** -126), _F32(1.0), _F32(2.0 ** 127),
           np.finfo(_F32).max / _F32(127), np.finfo(_F32).max, _F32(np.inf), _F32(np.nan),
           _F32(0.0)]


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(0, 2 ** 31 - 1),
       st.one_of(st.sampled_from(_SCALES),
                 st.floats(min_value=2.0 ** -126, max_value=float(np.finfo(_F32).max),
                           width=32)),
       st.booleans())
def test_whole_buffer_dequantize_bit_identical_to_reference(rows, seed, scale, negative):
    """``dequantize_int8_plain`` (what the wrapper runs on CPU tensors, and
    what the card's kernel is held to bit for bit in chip_smoke's phase
    quant) against the reference's ``dequantize_int8`` over random int8
    values with +-127, +-1 and 0 in every buffer, at tiny, large,
    overflowing, inf, NaN and zero scales of either sign: one multiply,
    one rounding (a NaN matches a NaN)."""
    r = np.random.RandomState(seed)
    vals = r.randint(-127, 128, size=(rows, 128)).astype(np.int8)
    vals[0, :5] = [127, -127, 1, -1, 0]
    s = np.array([[-scale if negative else scale]], dtype=_F32)
    want = np.asarray(jq.dequantize_int8(jnp.asarray(vals), jnp.asarray(s)))
    got = tq.dequantize_int8(_torch(vals), _torch(s)).numpy()
    assert got.dtype == np.float32 and got.shape == (rows, 128)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def test_a_subnormal_scale_is_flushed_by_the_reference_and_not_by_the_port():
    """A property of the reference, not held as a fault: its compiled
    dequantize reads a subnormal scale as zero (XLA on the CPU, like the
    TPU, flushes subnormal inputs), while the port multiplies in IEEE
    arithmetic, on the CPU and on the card (built without flushing). No
    scale the quantizer makes is subnormal: its floor gives 7.9e-33."""
    vals = np.full((1, 128), 100, dtype=np.int8)
    s = np.array([[1e-40]], dtype=_F32)
    want = np.asarray(jq.dequantize_int8(jnp.asarray(vals), jnp.asarray(s)))
    got = tq.dequantize_int8(_torch(vals), _torch(s)).numpy()
    assert not want.any()
    assert (got == _F32(100) * s[0, 0]).all() and got.all()
    assert tq.quantize_int8(torch.zeros(1, 128))[1].item() >= 2.0 ** -126


@pytest.mark.parametrize("length", [1, 127, 128, 129, 4097])
def test_wire_bytes_identical_and_decode_across_packages(length):
    r = np.random.RandomState(length)
    flat = (r.randn(length) * np.exp(r.randn(length))).astype(np.float32)
    jp = np.asarray(jq.wire_encode(jnp.asarray(flat)))
    tp = tq.wire_encode(_torch(flat))
    assert tp.shape == jp.shape and tp.dtype == torch.int8
    assert tuple(tp.shape) == (sum(tq.wire_rows(length)), 128) == (sum(jq.wire_rows(length)), 128)
    _same(tp, jp)
    # a message encoded by one package decodes in the other, with and
    # without the length
    ref = np.asarray(jq.wire_decode(jnp.asarray(jp), length=length))
    _same(tq.wire_decode(_torch(jp), length=length), ref)
    _same(tq.wire_decode(_torch(jp)), jq.wire_decode(jnp.asarray(jp)))
    np.testing.assert_array_equal(np.asarray(jq.wire_decode(jnp.asarray(tp.numpy()),
                                                            length=length)), ref)


def test_wire_geometry_matches_reference():
    for length in (1, 128, 129, 4096, 4097, 128 * 33, 10 ** 6):
        assert tq.wire_rows(length) == jq.wire_rows(length)
    for n_rows in range(1, 3000):
        try:
            want = jq._rows_from_packed(n_rows)
        except ValueError:
            with pytest.raises(ValueError, match="not a packed wire message"):
                tq.rows_from_packed(n_rows)
        else:
            assert tq.rows_from_packed(n_rows) == want, n_rows
    with pytest.raises(ValueError, match="length-0"):
        tq.wire_rows(0)


def test_wrappers_take_the_plain_version_on_the_cpu_and_check_shapes():
    x = _torch(np.random.RandomState(4).randn(5, 128).astype(np.float32))
    before = {c.name: c.launches for c in (tq.QUANT_BLOCK, tq.DEQUANT_BLOCK, tq.QUANT, tq.DEQUANT)}
    v, s = tq.quantize_int8_block(x)
    pv, ps = tq.quantize_int8_block_plain(x)
    assert torch.equal(v, pv) and torch.equal(s, ps)
    tq.dequantize_int8_block(v, s)
    tq.dequantize_int8(*tq.quantize_int8(x))
    # the CPU path launches nothing, so no counter moves
    after = {c.name: c.launches for c in (tq.QUANT_BLOCK, tq.DEQUANT_BLOCK, tq.QUANT, tq.DEQUANT)}
    assert after == before
    with pytest.raises(ValueError, match=r"\(rows >= 1, 128\)"):
        tq.quantize_int8_block(torch.zeros(4, 64))
    with pytest.raises(TypeError, match="float32"):
        tq.wire_encode(torch.zeros(10, dtype=torch.float64))
    with pytest.raises(ValueError, match="implies"):
        tq.wire_decode(tq.wire_encode(torch.zeros(300)), length=5000)


def test_whole_buffer_dequantize_checks_its_arguments_off_the_cpu():
    """Off the CPU ``dequantize_int8`` checks in one pass and, when that
    fails, ``_check`` names the argument (meta tensors stand in for the
    card's: the checks run before any launch)."""
    vals = torch.empty(3, 128, dtype=torch.int8, device="meta")
    scale = torch.empty(1, 1, device="meta")
    with pytest.raises(ValueError, match="scale is on cpu, expected meta"):
        tq.dequantize_int8(vals, torch.ones(1, 1))
    with pytest.raises(ValueError, match=r"scale has shape \(1,\), expected \(1, 1\)"):
        tq.dequantize_int8(vals, scale.view(1))
    with pytest.raises(TypeError, match="vals has dtype torch.uint8"):
        tq.dequantize_int8(vals.view(torch.uint8), scale)
    with pytest.raises(ValueError, match="vals must be contiguous"):
        tq.dequantize_int8(torch.empty(128, 3, dtype=torch.int8, device="meta").t(), scale)
    with pytest.raises(TypeError, match="scale has dtype torch.float64"):
        tq.dequantize_int8(vals, scale.double())


def test_whole_buffer_quantize_checks_its_arguments_off_the_cpu():
    """Off the CPU ``quantize_int8`` checks its buffer before its one
    launch, and ``_check`` names it (meta tensors stand in for the card's:
    the checks run before any launch)."""
    with pytest.raises(TypeError, match="x has dtype torch.float64"):
        tq.quantize_int8(torch.empty(3, 128, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="x must be contiguous"):
        tq.quantize_int8(torch.empty(128, 3, device="meta").t())
    with pytest.raises(ValueError, match=r"\(rows >= 1, 128\)"):
        tq.quantize_int8(torch.empty(3, 64, device="meta"))
    with pytest.raises(ValueError, match=r"\(rows >= 1, 128\)"):
        tq.quantize_int8(torch.empty(0, 128, device="meta"))


def test_whole_buffer_quantize_variants_find_their_anchors_in_the_source():
    """``tools/quant_whole_variants.py`` builds its variants by text edits
    of ``csrc/quant.cu``: each edit's anchor must be there once."""
    from theanompi_tpu_torch.ops.kernels import CSRC_DIR
    from theanompi_tpu_torch.tools import quant_whole_variants

    src = (CSRC_DIR / "quant.cu").read_text()
    variants = quant_whole_variants._variants(src)
    assert variants["base"] == [] and len(variants) == 4
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name
