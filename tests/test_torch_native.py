"""The port's native input-pipeline kernels (``theanompi_tpu_torch/native``,
its own copy of ``loader.cpp`` built with g++ into ``_build/``) against
their numpy versions and the reference's numpy oracle, bit for bit: the
contract is a pure speedup, never a numerics change. Also: threads
against one thread, a failed build and bad arguments raise, and the
host-affinity helpers against the reference's."""

import os
import threading

import numpy as np
import pytest

from theanompi_tpu.data.imagenet import ImageNet_data as JImageNet_data
from theanompi_tpu.utils import hostaffinity as jaff
from theanompi_tpu_torch import native
from theanompi_tpu_torch.utils import hostaffinity as taff


def _reference_normalize(x, oy, ox, flips, c, mean, scale):
    """The reference tests' oracle (tests/test_native.py::_numpy_ref)."""
    out = JImageNet_data._numpy_crop_mirror(x, oy, ox, flips, c)
    return (out.astype(np.float32) - mean) * np.float32(scale)


def _batch(seed, n=9, h=40, w=36, crop=27):
    r = np.random.RandomState(seed)
    x = r.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    oy = r.randint(0, h - crop + 1, n).astype(np.int64)
    ox = r.randint(0, w - crop + 1, n).astype(np.int64)
    flips = r.rand(n) < 0.5
    return r, x, oy, ox, flips, crop


def test_library_is_the_ports_own_build():
    path, _ = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "theanompi_tpu_torch"
    # keyed by host (a -march=native build is host-specific) and source
    import platform

    assert f"-{platform.node() or 'local'}-" in path.name


@pytest.mark.parametrize("mean_kind", ["scalar", "channel", "plane"])
def test_crop_mirror_normalize_matches_numpy(mean_kind):
    r, x, oy, ox, flips, crop = _batch(0)
    scale = 1.0 / 58.0
    mean = {"scalar": np.float32(127.5),
            "channel": r.rand(3).astype(np.float32) * 255,
            "plane": r.rand(crop, crop, 3).astype(np.float32) * 255}[mean_kind]
    got = native.crop_mirror_normalize(x, oy, ox, flips, crop, mean, scale)
    want = _reference_normalize(x, oy, ox, flips, crop, np.asarray(mean, np.float32), scale)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, native.crop_mirror_normalize_plain(x, oy, ox, flips, crop, mean, scale))


def test_crop_mirror_u8_matches_numpy():
    _, x, oy, ox, flips, crop = _batch(5, n=11)
    got = native.crop_mirror_u8(x, oy, ox, flips, crop)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, JImageNet_data._numpy_crop_mirror(x, oy, ox, flips, crop))
    np.testing.assert_array_equal(got, native.crop_mirror_plain(x, oy, ox, flips, crop))


def test_gather_rows_matches_fancy_index(tmp_path):
    r = np.random.RandomState(2)
    src = r.randint(0, 256, (50, 8, 8, 3)).astype(np.uint8)
    np.save(tmp_path / "shard.npy", src)
    mm = np.load(tmp_path / "shard.npy", mmap_mode="r")  # the real use
    idx = r.permutation(50)[:17]
    np.testing.assert_array_equal(native.gather_rows(mm, idx), src[idx])
    np.testing.assert_array_equal(native.gather_rows_plain(mm, idx), src[idx])
    assert native.gather_rows(mm, idx[:0]).shape == (0, 8, 8, 3)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int16", "float64"])
def test_gather_rows_any_fixed_width_dtype(dtype, tmp_path):
    """float32 images and int32 token windows (and any fixed-width dtype)
    gather as bytes: numpy's fancy indexing bit for bit (NaN payloads,
    signed zeros and infinities included), in ``out`` when given, from
    an mmap too."""
    r = np.random.RandomState(5)
    if dtype.startswith("float"):
        src = r.randn(41, 6, 5, 3).astype(dtype)
        src.reshape(-1)[:4] = [np.nan, -0.0, np.inf, -np.inf]
        src.reshape(-1).view(np.uint8)[-8:] = 0xFF  # a NaN with a non-default payload
    else:
        src = r.randint(-2**15, 2**15 - 1, (41, 77)).astype(dtype)
    idx = r.randint(0, 41, 23)  # repeats
    want = src[idx]
    got = native.gather_rows(src, idx)
    assert got.dtype == src.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    out = np.full(want.shape, 3, dtype)
    assert native.gather_rows(src, idx, out=out) is out
    assert out.tobytes() == want.tobytes()
    np.save(tmp_path / "rows.npy", src)
    mm = np.load(tmp_path / "rows.npy", mmap_mode="r")
    assert native.gather_rows(mm, idx).tobytes() == want.tobytes()
    for t in (1, 5):
        assert native.gather_rows(src, idx, n_threads=t).tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["uint8", "float32", "int32"])
def test_dataset_gather_routes_every_fixed_width_dtype_natively(dtype):
    """``data/datasets.py::gather`` takes the native gather for uint8,
    float32 and int32 rows and writes into the ``out`` allocator's
    buffer (the loader's pinned array), numpy's fancy indexing bit for
    bit; a strided source takes numpy's."""
    from theanompi_tpu_torch.data.datasets import gather

    r = np.random.RandomState(8)
    src = (r.randn(30, 4, 4, 3) * 100).astype(dtype)
    idx = r.permutation(30)[:11]
    given = []

    def alloc(shape, dt):
        given.append(np.empty(shape, dt))
        return given[-1]

    before = native.LOADER.calls["tmpi_gather_rows"]
    got = gather(src, idx, alloc)
    assert native.LOADER.calls["tmpi_gather_rows"] == before + 1
    assert got is given[0] and got.dtype == src.dtype
    assert got.tobytes() == src[idx].tobytes()
    strided = src[:, :, ::2]
    got = gather(strided, idx)
    assert native.LOADER.calls["tmpi_gather_rows"] == before + 1
    np.testing.assert_array_equal(got, strided[idx])


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
def test_mirrored_crop_whole_pixels_every_channel_count(c):
    """The mirrored rows copy whole pixels (c known at compile time for
    RGB; a copy of c bytes otherwise): bit for bit the reference's
    oracle and the plain version at every channel count, every image
    flipped, both outputs, with a per-channel and a plane mean."""
    r = np.random.RandomState(10 + c)
    n, h, w, crop = 6, 19, 23, 13
    x = r.randint(0, 256, (n, h, w, c)).astype(np.uint8)
    oy = r.randint(0, h - crop + 1, n)
    ox = r.randint(0, w - crop + 1, n)
    flips = np.ones(n, bool)
    flips[0] = False
    want = JImageNet_data._numpy_crop_mirror(x, oy, ox, flips, crop)
    np.testing.assert_array_equal(native.crop_mirror_u8(x, oy, ox, flips, crop), want)
    for mean in (r.rand(c).astype(np.float32) * 255,
                 r.rand(crop, crop, c).astype(np.float32) * 255, np.float32(117.25)):
        got = native.crop_mirror_normalize(x, oy, ox, flips, crop, mean, 0.0173)
        ref = _reference_normalize(x, oy, ox, flips, crop, mean, 0.0173)
        assert got.tobytes() == ref.tobytes()


def test_default_threads_are_capped_by_the_output_size(monkeypatch):
    """Without a thread count a call takes one thread a MB of output (a
    small batch's copy is shorter than starting threads), at most the
    default count; an explicit count is honoured."""
    monkeypatch.setenv("TMPI_LOADER_THREADS", "7")
    mb = native.MIN_BYTES_A_THREAD
    assert native._threads(None, 8 * 4096) == 1
    assert native._threads(None, 3 * mb + 5) == 3
    assert native._threads(None, 79 * mb) == 7
    assert native._threads(5, 10) == 5


@pytest.mark.parametrize("fn", ["gather_rows", "crop_mirror_u8", "crop_mirror_normalize"])
def test_threads_equal_single_thread(fn):
    _, x, oy, ox, flips, crop = _batch(1, n=33, h=32, w=32, crop=27)
    if fn == "gather_rows":
        idx = np.random.RandomState(3).permutation(33)

        def call(t):
            return native.gather_rows(x, idx, n_threads=t)
    elif fn == "crop_mirror_u8":
        def call(t):
            return native.crop_mirror_u8(x, oy, ox, flips, crop, n_threads=t)
    else:
        def call(t):
            return native.crop_mirror_normalize(x, oy, ox, flips, crop, np.float32(127.5),
                                                0.02, n_threads=t)
    one = call(1)
    for t in (2, 7, 64):
        np.testing.assert_array_equal(call(t), one)


def test_out_buffer_is_written_in_place():
    _, x, oy, ox, flips, crop = _batch(4)
    out = np.full((len(x), crop, crop, 3), 7, np.uint8)
    got = native.crop_mirror_u8(x, oy, ox, flips, crop, out=out)
    assert got is out
    np.testing.assert_array_equal(out, native.crop_mirror_plain(x, oy, ox, flips, crop))
    rows = np.empty((3, 40, 36, 3), np.uint8)
    assert native.gather_rows(x, [4, 0, 8], out=rows) is rows
    np.testing.assert_array_equal(rows, x[[4, 0, 8]])


def test_calls_are_counted():
    _, x, oy, ox, flips, crop = _batch(6)
    before = native.LOADER.calls["tmpi_crop_mirror_u8"]
    native.crop_mirror_u8(x, oy, ox, flips, crop)
    native.crop_mirror_plain(x, oy, ox, flips, crop)  # the plain version is not the kernel
    assert native.LOADER.calls["tmpi_crop_mirror_u8"] == before + 1


@pytest.mark.parametrize("case", [
    "float_images", "chw_rank", "crop_too_big", "offset_past_edge", "negative_offset",
    "length_mismatch", "mean_size", "out_shape", "out_dtype", "out_strided",
    "gather_dtype", "gather_strided", "gather_index", "gather_negative",
])
def test_bad_arguments_raise(case):
    _, x, oy, ox, flips, crop = _batch(7)
    calls = {
        "float_images": lambda: native.crop_mirror_u8(x.astype(np.float32), oy, ox, flips, crop),
        "chw_rank": lambda: native.crop_mirror_u8(x[0], oy, ox, flips, crop),
        "crop_too_big": lambda: native.crop_mirror_u8(x, oy * 0, ox * 0, flips, 37),
        "offset_past_edge": lambda: native.crop_mirror_u8(x, oy + 100, ox, flips, crop),
        "negative_offset": lambda: native.crop_mirror_u8(x, oy, ox - 100, flips, crop),
        "length_mismatch": lambda: native.crop_mirror_u8(x, oy[:-1], ox, flips, crop),
        "mean_size": lambda: native.crop_mirror_normalize(x, oy, ox, flips, crop,
                                                          np.zeros(5, np.float32), 1.0),
        "out_shape": lambda: native.crop_mirror_u8(
            x, oy, ox, flips, crop, out=np.empty((len(x), crop, crop + 1, 3), np.uint8)),
        "out_dtype": lambda: native.crop_mirror_u8(
            x, oy, ox, flips, crop, out=np.empty((len(x), crop, crop, 3), np.int8)),
        "out_strided": lambda: native.crop_mirror_u8(
            x, oy, ox, flips, crop, out=np.empty((len(x), crop, 2 * crop, 3), np.uint8)[:, :, ::2]),
        "gather_dtype": lambda: native.gather_rows(x.reshape(len(x), -1).astype(object), [0]),
        "gather_strided": lambda: native.gather_rows(x[:, ::2], [0]),
        "gather_index": lambda: native.gather_rows(x, [0, len(x)]),
        "gather_negative": lambda: native.gather_rows(x, [-1]),
    }
    with pytest.raises((TypeError, ValueError, IndexError)):
        calls[case]()


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile, or no g++, raises,
    and a fresh loader surfaces it on first use."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.tmp"))  # no torn temporary left
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeLoader().get()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ at first use"):
        native.build()


def test_default_threads(monkeypatch):
    monkeypatch.setenv("TMPI_LOADER_THREADS", "3")
    assert native.default_threads() == 3
    monkeypatch.delenv("TMPI_LOADER_THREADS")
    assert 1 <= native.default_threads() <= 8


@pytest.mark.parametrize("spec", ["0-3,8,10-11", "5", "2,3,6", " 1 - 2 , 4", "0-0"])
def test_parse_cpuset_matches_reference(spec):
    assert taff.parse_cpuset(spec) == jaff.parse_cpuset(spec)


@pytest.mark.parametrize("spec", [" , ", ""])
def test_parse_cpuset_refuses_empty_like_reference(spec):
    with pytest.raises(ValueError):
        jaff.parse_cpuset(spec)
    with pytest.raises(ValueError):
        taff.parse_cpuset(spec)


@pytest.mark.parametrize("which", ["first", "all", "outside"])
def test_pin_thread_matches_reference(which, monkeypatch):
    """Pinned from scratch threads, so the runner's own mask is untouched;
    both packages pin (or not) alike and read the same cpuset."""
    allowed = sorted(os.sched_getaffinity(0))
    spec = {"first": str(allowed[0]), "all": ",".join(map(str, allowed)),
            "outside": str(max(allowed) + 1000)}[which]
    monkeypatch.setenv("TMPI_LOADER_CPUS", spec)
    assert taff.loader_cpuset() == jaff.loader_cpuset()
    results = {}

    def run(mod, key):
        pinned = mod.pin_thread()
        results[key] = (pinned, os.sched_getaffinity(0))

    for mod, key in ((taff, "port"), (jaff, "reference")):
        t = threading.Thread(target=run, args=(mod, key))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert results["port"] == results["reference"]
    assert results["port"][0] is (which != "outside")
    if which == "first":
        assert results["port"][1] == {allowed[0]}
