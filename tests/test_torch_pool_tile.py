"""The halo-tile launch plan of the port's 3x3/s1 max pool kernels
(theanompi_tpu_torch/ops/pool.py: ``tile_plan``; csrc/pool.cu) and the
order of work the kernels rest on, on the CPU.

- The plan at GoogLeNet's inception pool inputs (batch 512) and at edge
  shapes, in fp32 and bf16: replaying the kernel's block decode, every
  output element is covered exactly once; each tile's halo stays within
  one row and one column of it and inside its shared memory; shared
  memory, threads and the grid stay within sm_90's limits, and at the
  inception shapes 2 CTAs fit an SM in bf16 (one in fp32).
- A replay of the kernels tile by tile, from halos framed as the kernels
  frame them: the forward in the kernel's row-by-row order (three
  horizontal maxima, then their maximum) and the backward's nine adds
  from the staged y and g, bit for bit against the plain versions and the
  reference's Pallas route (interpret mode, ``TMPI_PALLAS_POOL=1``), on
  random, tie-heavy, NaN/+-inf, border and all -inf inputs (no -0.0: the
  sign of a zero maximum over +0 and -0 is not pinned down).
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from theanompi_tpu.ops import pallas_pool as jpool
from theanompi_tpu_torch.ops import pool as tpool

# GoogLeNet's nine inception pool inputs at 224x224x3, batch 512 (NHWC)
INCEPTION = [(512, 28, 28, 192), (512, 28, 28, 256), (512, 14, 14, 480), (512, 14, 14, 512),
             (512, 14, 14, 512), (512, 14, 14, 512), (512, 14, 14, 528), (512, 7, 7, 832),
             (512, 7, 7, 832)]
EDGE = [(3, 1, 1, 8), (2, 1, 40, 16), (2, 40, 1, 16), (4, 29, 31, 72), (2, 64, 64, 64),
        (2, 13, 7, 130), (1, 5, 70, 8), (1, 9, 9, 832), (2, 8, 8, 16), (1, 200, 3, 8),
        (2, 33, 33, 130), (70000, 2, 2, 8)]
ITEMSIZE = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SMS = 132  # an H100 SXM's SMs
_ids = dict(ids=lambda s: "x".join(map(str, s)))


def _tiles(N, H, W, C, plan):
    """Every CTA's tile as the kernel's ``locate`` decodes it from
    ``blockIdx.x``: (n, h0, w0, c0, rows, cols, channels)."""
    for b in range(plan["blocks"]):
        cblk, r = b % plan["cblocks"], b // plan["cblocks"]
        ct, r = r % plan["ctiles"], r // plan["ctiles"]
        band, n = r % plan["bands"], r // plan["bands"]
        h0, w0, c0 = band * plan["bh"], ct * plan["bw"], cblk << plan["cb_log2"]
        yield (n, h0, w0, c0, min(plan["bh"], H - h0), min(plan["bw"], W - w0),
               min(plan["cb"], C - c0))


def _check_plan(N, H, W, C, itemsize):
    """Coverage, halos and limits of one plan (coverage over 2 images:
    the decode is the same for every image)."""
    plan = tpool.tile_plan(N, H, W, C, itemsize)
    per_image = plan["bands"] * plan["ctiles"] * plan["cblocks"]
    assert plan["blocks"] == N * per_image <= tpool.GRID_X_MAX
    assert plan["cb"] == 1 << plan["cb_log2"] and 8 <= plan["cb"] <= tpool.MAX_CHANNELS
    assert plan["bw"] <= tpool.MAX_TILE_COLS
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= tpool.MAX_THREADS
    assert plan["smem_bwd"] == 2 * plan["smem_fwd"] <= tpool.SMEM_PER_CTA
    tile_words = (plan["bh"] + 2) * (plan["bw"] + 2) * plan["cb"]
    assert plan["smem_fwd"] == tile_words * itemsize
    n_img = min(N, 2)
    covered = np.zeros((n_img, H, W, C), np.int32)
    sub = dict(plan, blocks=n_img * per_image)
    for n, h0, w0, c0, rows, cols, chans in _tiles(n_img, H, W, C, sub):
        assert rows >= 1 and cols >= 1 and chans >= 1, (h0, w0, c0)
        covered[n, h0:h0 + rows, w0:w0 + cols, c0:c0 + chans] += 1
        # the staged halo: one row above and below, one column each side
        halo_rows, halo_cols = (h0 - 1, h0 + rows + 1), (w0 - 1, w0 + cols + 1)
        assert halo_rows[1] - halo_rows[0] == rows + 2 <= plan["bh"] + 2
        assert halo_cols[1] - halo_cols[0] == cols + 2 <= plan["bw"] + 2
        assert (rows + 2) * (cols + 2) * plan["cb"] * itemsize <= plan["smem_fwd"]
    assert (covered == 1).all(), f"{np.count_nonzero(covered != 1)} elements not covered once"
    return plan


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("shape", sorted(set(INCEPTION)) + EDGE, **_ids)
def test_plan_covers_every_output_once_within_the_limits(shape, dtype):
    _check_plan(*shape, ITEMSIZE[dtype])


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("shape", sorted(set(INCEPTION)), **_ids)
def test_plan_fits_two_ctas_an_sm_at_the_inception_shapes(shape, dtype):
    """bf16 (the main path): at least 2 forward and 2 backward CTAs an SM
    by shared memory and threads, and at least 2 waves over the card's
    SMs; fp32 needs only to fit one backward CTA."""
    plan = tpool.tile_plan(*shape, ITEMSIZE[dtype])
    least = 2 if dtype == "bfloat16" else 1
    assert plan["ctas_per_sm_fwd"] >= least and plan["ctas_per_sm_bwd"] >= least
    for k in ("fwd", "bwd"):
        occupancy = plan[f"ctas_per_sm_{k}"]
        assert occupancy * (plan[f"smem_{k}"] + tpool.SMEM_RESERVED_PER_CTA) <= tpool.SMEM_PER_SM
        assert occupancy * plan["threads"] <= tpool.THREADS_PER_SM
        if dtype == "bfloat16":
            assert plan["blocks"] / (SMS * occupancy) >= 2, (k, plan)


def test_the_inception_shapes_are_the_models():
    from theanompi_tpu_torch.models.googlenet import GoogLeNet, Inception

    model = GoogLeNet(GoogLeNet.default_recipe().replace(batch_size=512), pool_kernel=True)
    blocks, _ = model.block_inputs()
    assert [tuple(s) for _, b, s in blocks if isinstance(b, Inception)] == INCEPTION


@settings(max_examples=60, deadline=None)
@given(H=st.integers(1, 80), W=st.integers(1, 80), C=st.integers(1, 300),
       itemsize=st.sampled_from([2, 4]))
def test_plan_covers_any_map(H, W, C, itemsize):
    _check_plan(2, H, W, C, itemsize)


def test_plan_refusals():
    with pytest.raises(ValueError, match="non-empty"):
        tpool.tile_plan(1, 0, 4, 8, 2)
    with pytest.raises(ValueError, match="power of two"):
        tpool.tile_plan(1, 4, 4, 96, 2, channels=48)
    with pytest.raises(ValueError, match="gridDim"):
        tpool.tile_plan(2 ** 31, 1, 1, 8, 2)
    # a band cap overrides the budget; a channel block may be set
    plan = tpool.tile_plan(2, 28, 28, 192, 2, rows=4, channels=32)
    assert (plan["bh"], plan["bands"], plan["cb"], plan["cblocks"]) == (4, 7, 32, 6)


# --------------------------------------------------------------------------
# the kernels' order of work, replayed tile by tile
# --------------------------------------------------------------------------


def _input(kind: str, shape, seed: int) -> np.ndarray:
    r = np.random.RandomState(seed)
    if kind == "tie_heavy":  # post-ReLU zeros and a few levels
        return (np.maximum(np.round(r.randn(*shape) * 2) / 2, 0.0) + 0.0).astype(np.float32)
    x = r.randn(*shape).astype(np.float32)
    if kind == "nan_inf":
        u = r.rand(*shape)
        x[u < 0.03] = np.nan
        x[(u >= 0.03) & (u < 0.06)] = np.inf
        x[(u >= 0.06) & (u < 0.12)] = -np.inf
    elif kind == "border":  # the frame's values, -inf and ties along the edges
        x[:, 0] = -np.inf
        x[:, -1] = 0.0
        x[:, :, 0] = -3.3895313892515355e38  # -max of bf16 (above fp32's -max)
        x[:, :, -1] = -np.finfo(np.float32).max
    elif kind == "minus_inf":  # interior windows of nothing but -inf
        x[:] = -np.inf
        x[:, ::4, ::3] = r.randn(*x[:, ::4, ::3].shape)
    return x


def _max_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's ``max_nan``: keep a where it is NaN or b is not a NaN
    above it; the bits are one of the two."""
    af, bf = a.float(), b.float()
    return torch.where(torch.isnan(af) | ~(torch.isnan(bf) | (bf > af)), a, b)


def _framed(t: torch.Tensor, fill: float) -> torch.Tensor:
    return F.pad(t, (0, 0, 1, 1, 1, 1), value=fill)


def _replay_fwd(x: torch.Tensor, plan: dict) -> torch.Tensor:
    """The forward kernel tile by tile: the halo framed with the dtype's
    -max, three horizontal maxima a tile row, their maximum down the band."""
    N, H, W, C = x.shape
    xp = _framed(x, -torch.finfo(x.dtype).max)
    y = torch.full_like(x, float("nan"))
    for n, h0, w0, c0, rows, cols, ch in _tiles(N, H, W, C, plan):
        tile = xp[n, h0:h0 + rows + 2, w0:w0 + cols + 2, c0:c0 + ch]
        hm = _max_nan(_max_nan(tile[:, 0:cols], tile[:, 1:cols + 1]), tile[:, 2:cols + 2])
        y[n, h0:h0 + rows, w0:w0 + cols, c0:c0 + ch] = _max_nan(
            _max_nan(hm[0:rows], hm[1:rows + 1]), hm[2:rows + 2])
    return y


def _replay_bwd(x, y, g, plan: dict) -> torch.Tensor:
    """The backward kernel tile by tile: y framed with the storage dtype's
    -max and g with 0 in the staged halos, the nine terms added in fp32
    in (di, dj) order, rounded once."""
    N, H, W, C = x.shape
    yp = _framed(y, -torch.finfo(y.dtype).max)
    gp = _framed(g, 0.0)
    dx = torch.full_like(x, float("nan"))
    for n, h0, w0, c0, rows, cols, ch in _tiles(N, H, W, C, plan):
        ty = yp[n, h0:h0 + rows + 2, w0:w0 + cols + 2, c0:c0 + ch].float()
        tg = gp[n, h0:h0 + rows + 2, w0:w0 + cols + 2, c0:c0 + ch].float()
        xf = x[n, h0:h0 + rows, w0:w0 + cols, c0:c0 + ch].float()
        acc = torch.zeros_like(xf)
        for di in range(3):
            for dj in range(3):
                acc = acc + torch.where(ty[di:di + rows, dj:dj + cols] == xf,
                                        tg[di:di + rows, dj:dj + cols], 0.0)
        dx[n, h0:h0 + rows, w0:w0 + cols, c0:c0 + ch] = acc.to(x.dtype)
    return dx


def _bits_equal(got: torch.Tensor, want) -> bool:
    """Every bit pattern equal, a NaN matching any NaN."""
    want = torch.from_numpy(np.array(want, dtype=np.float32)).to(got.dtype) \
        if not isinstance(want, torch.Tensor) else want
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    iv = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    same = got.view(iv) == want.view(iv)
    return bool(torch.equal(gn, wn) and (same | gn).all())


@pytest.mark.parametrize("rows", [None, 3], ids=["budget", "bands_of_3"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "tie_heavy", "nan_inf", "border", "minus_inf"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 7, 5, 130), (2, 11, 37, 24)], **_ids)
def test_tiled_replay_is_the_plain_and_the_reference_bit_for_bit(shape, kind, dtype, rows,
                                                                 monkeypatch):
    tdt, jdt = DTYPES[dtype]
    x = torch.from_numpy(_input(kind, shape, seed=5)).to(tdt)
    g = torch.from_numpy(np.random.RandomState(6).randn(*shape).astype(np.float32)).to(tdt)
    assert not (x.float() == 0).logical_and(torch.signbit(x.float())).any(), "a -0.0 in x"
    plan = tpool.tile_plan(*shape, x.element_size(), rows=rows)
    if rows:
        assert plan["bands"] == math.ceil(shape[1] / 3)
    y_plain = tpool.maxpool3x3_fwd_plain(x)
    y = _replay_fwd(x, plan)
    assert _bits_equal(y, y_plain), "the row-by-row order differs from the plain forward"
    dx = _replay_bwd(x, y_plain, g, plan)
    assert _bits_equal(dx, tpool.maxpool3x3_bwd_plain(x, y_plain, g)), \
        "the tiled backward differs from the plain backward"
    monkeypatch.setenv("TMPI_PALLAS_POOL", "1")
    monkeypatch.setenv("TMPI_PALLAS", "1")
    x_j = jnp.asarray(x.float().numpy()).astype(jdt)
    g_j = jnp.asarray(g.float().numpy()).astype(jdt)
    y_ref, vjp = jax.vjp(jpool.maxpool3x3_s1, x_j)
    (dx_ref,) = vjp(g_j)
    assert _bits_equal(y, np.asarray(y_ref.astype(jnp.float32))), "forward vs the reference"
    assert _bits_equal(dx, np.asarray(dx_ref.astype(jnp.float32))), "backward vs the reference"


def test_variant_edits_find_their_anchors():
    """tools/pool_variants.py edits csrc/pool.cu by text: each edit's
    anchor is in the source (``nine_way`` once: the forward's walk;
    ``decode64`` and the others in both kernels or both entry points)."""
    from theanompi_tpu_torch.ops import kernels as K
    from theanompi_tpu_torch.tools import pool_variants as pv

    src = (K.CSRC_DIR / "pool.cu").read_text()
    counts = {"nine_way": 1, "plain_loads": 1, "ctas2": 2, "minblocks4": 2, "decode64": 1,
              "lanes_fp32": 1, "minblocks3": 2, "regs96": 1, "memory_only": 1}
    variants = pv._variants(src)
    assert set(variants) == {"base", *counts}
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == counts[name], name
            assert old != new
    walk = variants["nine_way"][0][0]
    assert "hmax3" in walk and "maxpool_bwd_tile_kernel" not in walk
    assert set(pv.PLANS) == {"rows4", "rows14", "cb16", "cb32"}
    for kw in pv.PLANS.values():
        for shape in pv.SHAPES:
            tpool.tile_plan(*shape, 2, **kw)
