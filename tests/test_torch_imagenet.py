"""The port's datasets of the input feed against the reference's, batch by
batch and bit for bit, for a seed: ``Imagenet_synthetic`` (normalized on
the card or on the host), ``ImageNet_data`` over ``.npy`` shards (scalar,
per-channel and plane means; mirroring off; 10-crop validation; a rank's
rows), the augment hook of ``Dataset.train_epoch`` through
``Cifar10_data``'s crop + mirror and ``Digits_data`` (``augment_crop``,
``ten_crop_val``); and the shard format, written by either package and
read by the other."""

import numpy as np
import pytest

from theanompi_tpu.data import datasets as jds
from theanompi_tpu.data import imagenet as jim
from theanompi_tpu_torch import native
from theanompi_tpu_torch.data import datasets as tds
from theanompi_tpu_torch.data import imagenet as tim


def _assert_same_stream(port_batches, ref_batches, n_expected=None):
    port_batches, ref_batches = list(port_batches), list(ref_batches)
    assert len(port_batches) == len(ref_batches)
    if n_expected is not None:
        assert len(port_batches) == n_expected
    for i, ((xa, ya), (xb, yb)) in enumerate(zip(port_batches, ref_batches)):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, f"batch {i}"
        np.testing.assert_array_equal(xa, xb, err_msg=f"batch {i}")
        np.testing.assert_array_equal(ya, yb, err_msg=f"batch {i}")


@pytest.mark.parametrize("device_normalize", [True, False])
@pytest.mark.parametrize("rows", [slice(None), slice(0, 4), slice(4, 8)])
def test_imagenet_synthetic_batches_match_reference(device_normalize, rows):
    # more images than one draw chunk: the chunked draw is the same stream
    kw = dict(n_train=tim.Imagenet_synthetic.DRAW_CHUNK + 44, n_val=24, crop=8,
              n_classes=10, seed=3, device_normalize=device_normalize)
    port, ref = tim.Imagenet_synthetic(**kw), jim.Imagenet_synthetic(**kw)
    np.testing.assert_array_equal(port.x_train, ref.x_train)
    assert (port.device_transform is None) == (ref.device_transform is None)
    if device_normalize:
        assert port.device_transform["scale"] == ref.device_transform["scale"]
        assert np.float32(port.device_transform["mean"]) == np.float32(ref.device_transform["mean"])
    for epoch in (0, 1):
        _assert_same_stream(port.train_epoch(epoch, 8, seed=5, rows=rows),
                            ref.train_epoch(epoch, 8, seed=5, part=rows), 37)
    _assert_same_stream(port.val_epoch(8, rows=rows), ref.val_epoch(8, part=rows), 3)
    x, _ = next(port.train_epoch(0, 8))
    assert x.dtype == (np.uint8 if device_normalize else np.float32)


def _alloc(shape, dtype):
    """An ``out=`` allocator, as the training loop's ``pinned_array`` but
    in ordinary memory, filled with garbage the writes must cover."""
    return np.full(shape, 7, dtype)


@pytest.mark.parametrize("rows", [slice(None), slice(2, 6)])
def test_imagenet_synthetic_out_allocator_keeps_the_stream(rows):
    kw = dict(n_train=40, n_val=8, crop=8, n_classes=10, seed=1)
    port, ref = tim.Imagenet_synthetic(**kw), jim.Imagenet_synthetic(**kw)
    _assert_same_stream(port.train_epoch(0, 8, seed=2, rows=rows, out=_alloc),
                        ref.train_epoch(0, 8, seed=2, part=rows), 5)
    host = tds.Synthetic_data(n_train=40, n_val=8, image_shape=(8, 8, 3))
    jhost = jds.Synthetic_data(n_train=40, n_val=8, image_shape=(8, 8, 3))
    _assert_same_stream(host.train_epoch(0, 8, rows=rows, out=_alloc),
                        jhost.train_epoch(0, 8, part=rows), 5)


def test_imagenet_synthetic_gathers_natively():
    data = tim.Imagenet_synthetic(n_train=32, n_val=8, crop=8, n_classes=10)
    before = native.LOADER.calls["tmpi_gather_rows"]
    assert len(list(data.train_epoch(0, 8))) == 4
    assert native.LOADER.calls["tmpi_gather_rows"] == before + 4


def _write(package, directory, side=36, n_train=64, n_val=24, shard=32, seed=0):
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 256, (n_train, side, side, 3)).astype(np.uint8)
    lbls = r.randint(0, 10, n_train).astype(np.int64)
    assert package.write_shards(str(directory), "train", imgs, lbls, shard_size=shard) == 2
    package.write_shards(str(directory), "val", imgs[:n_val], lbls[:n_val], shard_size=n_val)
    return r


@pytest.mark.parametrize("mean", ["scalar", "channel", "plane"])
@pytest.mark.parametrize("device_normalize", [True, False])
def test_imagenet_shards_match_reference(tmp_path, mean, device_normalize):
    r = _write(tim, tmp_path)
    if mean == "channel":
        np.save(tmp_path / "mean.npy", (r.rand(3) * 255).astype(np.float32))
    elif mean == "plane":
        np.save(tmp_path / "mean.npy", (r.rand(36, 36, 3) * 255).astype(np.float32))
    kw = dict(root=str(tmp_path), crop=27, device_normalize=device_normalize)
    port, ref = tim.ImageNet_data(**kw), jim.ImageNet_data(**kw)
    assert port.n_train == ref.n_train == 64 and port.n_val == ref.n_val == 24
    assert port.n_train_batches(16) == ref.n_train_batches(16) == 4
    if device_normalize:
        np.testing.assert_array_equal(port.device_transform["mean"], ref.device_transform["mean"])
        assert port.device_transform["scale"] == ref.device_transform["scale"]
    for epoch in (0, 1):
        _assert_same_stream(port.train_epoch(epoch, 16, seed=9),
                            ref.train_epoch(epoch, 16, seed=9), 4)
    _assert_same_stream(port.train_epoch(0, 16, seed=9, out=_alloc),
                        ref.train_epoch(0, 16, seed=9), 4)
    _assert_same_stream(port.val_epoch(8), ref.val_epoch(8), 3)


@pytest.mark.parametrize("rows", [slice(0, 8), slice(8, 16), slice(4, 12)])
def test_imagenet_rank_rows_match_reference_part(tmp_path, rows):
    _write(tim, tmp_path)
    port = tim.ImageNet_data(root=str(tmp_path), crop=27)
    ref = jim.ImageNet_data(root=str(tmp_path), crop=27)
    _assert_same_stream(port.train_epoch(0, 16, seed=2, rows=rows),
                        ref.train_epoch(0, 16, seed=2, part=rows), 4)
    _assert_same_stream(port.train_epoch(0, 16, seed=2, rows=rows, out=_alloc),
                        ref.train_epoch(0, 16, seed=2, part=rows), 4)
    _assert_same_stream(port.val_epoch(16, rows=rows), ref.val_epoch(16, part=rows), 1)


def test_imagenet_train_mirror_off_matches_reference(tmp_path):
    _write(tim, tmp_path)
    kw = dict(root=str(tmp_path), crop=27, train_mirror=False)
    port, ref = tim.ImageNet_data(**kw), jim.ImageNet_data(**kw)
    _assert_same_stream(port.train_epoch(0, 16, seed=7), ref.train_epoch(0, 16, seed=7), 4)
    # the same crops as with mirroring on (the flips are drawn either way)
    on = tim.ImageNet_data(root=str(tmp_path), crop=27)
    for (xa, _), (xb, _) in zip(port.train_epoch(0, 16, seed=7), on.train_epoch(0, 16, seed=7)):
        for a, b in zip(xa, xb):
            assert np.array_equal(a, b) or np.array_equal(a, b[:, ::-1])


@pytest.mark.parametrize("device_normalize", [True, False])
@pytest.mark.parametrize("rows", [slice(None), slice(2, 6)])
def test_imagenet_ten_crop_val_matches_reference(tmp_path, device_normalize, rows):
    _write(tim, tmp_path)
    kw = dict(root=str(tmp_path), crop=27, val_crops=10, device_normalize=device_normalize)
    port, ref = tim.ImageNet_data(**kw), jim.ImageNet_data(**kw)
    assert port.val_views == ref.val_views == 10
    _assert_same_stream(port.val_epoch(8, rows=rows), ref.val_epoch(8, part=rows), 3)
    x, y = next(port.val_epoch(8, rows=rows))
    assert x.shape[0] == 10 * y.shape[0]
    with pytest.raises(ValueError, match="val_crops"):
        tim.ImageNet_data(root=str(tmp_path), crop=27, val_crops=4)


@pytest.mark.parametrize("writer,reader", [(tim, jim), (jim, tim)])
def test_shards_written_by_either_package_read_by_the_other(tmp_path, writer, reader):
    _write(writer, tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "train_images_0000.npy", "train_images_0001.npy", "train_labels_0000.npy",
        "train_labels_0001.npy", "val_images_0000.npy", "val_labels_0000.npy"]
    assert writer.shard_path("d", "train", "images", 3) == reader.shard_path("d", "train", "images", 3)
    other = reader.ImageNet_data(root=str(tmp_path), crop=27)
    same = writer.ImageNet_data(root=str(tmp_path), crop=27)
    _assert_same_stream(other.train_epoch(0, 16, seed=1), same.train_epoch(0, 16, seed=1), 4)


def test_imagenet_missing_shards_raise(tmp_path, monkeypatch):
    monkeypatch.delenv("IMAGENET_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="imagenet_synthetic"):
        tim.ImageNet_data(root=str(tmp_path / "nope"))


def _cifar(package, x, y, xv, yv):
    """A Cifar10_data built without its files (reference
    tests/test_train.py's ``__new__``), holding these arrays."""
    ds = package.Cifar10_data.__new__(package.Cifar10_data)
    ds.x_train, ds.y_train, ds.x_val, ds.y_val = x, y, xv, yv
    return ds


def test_cifar_augment_matches_reference():
    x = np.random.RandomState(0).randn(16, 32, 32, 3).astype(np.float32)
    got = _cifar(tds, x, None, None, None).augment(x, np.random.RandomState(7))
    want = _cifar(jds, x, None, None, None).augment(x, np.random.RandomState(7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tds.crop_mirror_augment(x, np.random.RandomState(2), pad=2),
                                  jds.crop_mirror_augment(x, np.random.RandomState(2), pad=2))


@pytest.mark.parametrize("rows", [slice(None), slice(0, 8)])
def test_cifar_train_epoch_runs_the_augment_hook_as_the_reference(rows):
    r = np.random.RandomState(1)
    arrays = (r.randn(48, 32, 32, 3).astype(np.float32), r.randint(0, 10, 48).astype(np.int32),
              r.randn(16, 32, 32, 3).astype(np.float32), r.randint(0, 10, 16).astype(np.int32))
    port, ref = _cifar(tds, *arrays), _cifar(jds, *arrays)
    _assert_same_stream(port.train_epoch(2, 16, seed=4, rows=rows),
                        ref.train_epoch(2, 16, seed=4, part=rows), 3)
    _assert_same_stream(port.train_epoch(2, 16, seed=4, rows=rows, out=_alloc),
                        ref.train_epoch(2, 16, seed=4, part=rows), 3)
    _assert_same_stream(port.val_epoch(16, rows=rows), ref.val_epoch(16, part=rows), 1)
    # the hook ran: no batch is a plain gather of the train images
    x, _ = next(port.train_epoch(2, 16, seed=4))
    perm = np.random.RandomState(4 * 100003 + 2).permutation(48)
    assert not np.array_equal(x, arrays[0][perm[:16]])


@pytest.mark.parametrize("augment_crop,ten_crop_val", [(False, False), (True, False),
                                                       (False, True), (True, True)])
def test_digits_batches_match_reference(augment_crop, ten_crop_val):
    kw = dict(size=16, seed=3, augment_crop=augment_crop, ten_crop_val=ten_crop_val)
    port, ref = tds.Digits_data(**kw), jds.Digits_data(**kw)
    assert port.val_views == ref.val_views == (10 if ten_crop_val else 1)
    _assert_same_stream(port.train_epoch(0, 64, seed=1), ref.train_epoch(0, 64, seed=1))
    for rows in (slice(None), slice(16, 32)):
        _assert_same_stream(port.val_epoch(32, rows=rows), ref.val_epoch(32, part=rows))


def test_registry_names_the_feed_datasets():
    for name, cls in (("cifar10", tds.Cifar10_data), ("digits", tds.Digits_data),
                      ("imagenet", tim.ImageNet_data),
                      ("imagenet_synthetic", tim.Imagenet_synthetic)):
        assert tds._REGISTRY[name] is cls
    data = tds.get_dataset("imagenet_synthetic", n_train=16, n_val=8, crop=8, n_classes=10)
    assert data.image_shape == (8, 8, 3) and data.n_classes == 10
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.get_dataset("nope")
