"""Host-side datasets (port of ``theanompi_tpu/data/datasets.py``).

Every dataset draws with the reference's numpy seeding and in its order,
so the two packages yield identical batches for a seed: the shuffled
permutation, then the train-time ``augment`` hook's draws
(``crop_mirror_augment`` for the CIFAR recipe). Rows of every
fixed-width dtype are gathered by the native row gather (``native/``).
The token datasets (``data/lm.py``) and the ImageNet
datasets (``data/imagenet.py``) register themselves here.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Iterator, Optional

import numpy as np

from theanompi_tpu_torch import native


def gather(source: np.ndarray, idx, out: Optional[Callable] = None) -> np.ndarray:
    """``source[idx]`` by the native multithreaded row gather for any
    C-contiguous array of a fixed-width dtype (uint8 or float32 images,
    int32 token windows), written where ``out`` (an allocator ``(shape,
    dtype) -> array``, e.g. ``data/loader.py::pinned_array``) says, so
    the training loop copies nothing more into pinned memory; numpy's
    fancy indexing for an object dtype or a strided array."""
    if source.dtype.hasobject or not source.flags.c_contiguous:
        return native.gather_rows_plain(source, idx)
    buf = out((len(idx), *source.shape[1:]), source.dtype) if out is not None else None
    return native.gather_rows(source, idx, out=buf)


class Dataset:
    """Host-side dataset of (images NHWC, labels int32): float32 images,
    or uint8 ones that the training loop normalizes on the card
    (``device_transform``).

    Epoch iterators yield fixed-size batches; the last partial batch is
    dropped."""

    name = "dataset"
    image_shape: tuple = (32, 32, 3)
    n_classes: int = 10

    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.x_train)

    @property
    def n_val(self) -> int:
        return len(self.x_val)

    def n_train_batches(self, batch_size: int) -> int:
        return self.n_train // batch_size

    def n_val_batches(self, batch_size: int) -> int:
        return self.n_val // batch_size

    def train_epoch(self, epoch: int, batch_size: int, seed: int = 0,
                    rows: slice = slice(None),
                    out: Optional[Callable] = None) -> Iterator[tuple]:
        """Deterministically shuffled epoch (seed + epoch -> permutation),
        the reference's order exactly. ``rows``: only these rows of each
        batch (a rank's shard, the reference's ``part``), cut from the
        unsorted permutation and gathered and augmented alone. ``out``:
        the allocator of each gathered batch (see ``gather``)."""
        rng = np.random.RandomState(seed * 100003 + epoch)
        perm = rng.permutation(self.n_train)
        for i in range(self.n_train_batches(batch_size)):
            idx = perm[i * batch_size:(i + 1) * batch_size][rows]
            yield self.augment(gather(self.x_train, idx, out), rng), self.y_train[idx]

    def val_epoch(self, batch_size: int, rows: slice = slice(None)) -> Iterator[tuple]:
        for i in range(self.n_val_batches(batch_size)):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            yield self.x_val[sl][rows], self.y_val[sl][rows]

    def augment(self, x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        """Train-time augmentation hook, drawing from the epoch's ``rng``
        after the permutation; default identity."""
        return x


class Synthetic_data(Dataset):
    """Deterministic fake data: x = class_mean + noise. Learnable,
    seeded, zero I/O."""

    name = "synthetic"

    def __init__(self, n_train: int = 1024, n_val: int = 256,
                 image_shape: tuple = (32, 32, 3), n_classes: int = 10,
                 seed: int = 1234, noise: float = 0.3):
        self.image_shape = tuple(image_shape)
        self.n_classes = n_classes
        rng = np.random.RandomState(seed)
        means = rng.randn(n_classes, *self.image_shape).astype(np.float32)

        def make(n, salt):
            r = np.random.RandomState(seed + salt)
            y = r.randint(0, n_classes, size=n).astype(np.int32)
            x = means[y] + noise * r.randn(n, *self.image_shape).astype(np.float32)
            return x.astype(np.float32), y

        self.x_train, self.y_train = make(n_train, 1)
        self.x_val, self.y_val = make(n_val, 2)


def crop_mirror_augment(x: np.ndarray, rng: np.random.RandomState, pad: int = 4) -> np.ndarray:
    """Random crop from ``pad``-pixel reflect padding + horizontal mirror,
    vectorized: the WRN/CIFAR recipe's train augmentation (reference:
    ``models/data/utils.py`` crop/mirror)."""
    n, h, w, _ = x.shape
    padded = np.pad(x, [(0, 0), (pad, pad), (pad, pad), (0, 0)], mode="reflect")
    offs = rng.randint(0, 2 * pad + 1, size=(n, 2))
    flips = rng.rand(n) < 0.5
    rows = offs[:, 0, None] + np.arange(h)  # (n, h)
    cols = offs[:, 1, None] + np.arange(w)  # (n, w)
    cols = np.where(flips[:, None], cols[:, ::-1], cols)
    return padded[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]]


class Cifar10_data(Dataset):
    """CIFAR-10 from the standard python-pickle batches
    (``cifar-10-batches-py``) under ``root``, ``$CIFAR10_DIR`` or a
    common data root; raises when absent (nothing is downloaded).
    Per-channel mean/std normalization from the train split; train-time
    augment: random crop from 4-pixel reflect padding + mirror."""

    name = "cifar10"

    SEARCH = ("/data", os.path.expanduser("~/.cache/theanompi_tpu"))

    def __init__(self, root: Optional[str] = None):
        base = self._find(root)
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(base, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(np.asarray(d[b"labels"]))
        with open(os.path.join(base, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x_val, y_val = d[b"data"], np.asarray(d[b"labels"])

        def to_nhwc(x):
            return x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0

        x_train, x_val = to_nhwc(np.concatenate(xs)), to_nhwc(x_val)
        self.mean = x_train.mean(axis=(0, 1, 2), keepdims=True)
        self.std = x_train.std(axis=(0, 1, 2), keepdims=True) + 1e-7
        self.x_train = (x_train - self.mean) / self.std
        self.x_val = (x_val - self.mean) / self.std
        self.y_train = np.concatenate(ys).astype(np.int32)
        self.y_val = y_val.astype(np.int32)

    @classmethod
    def _find(cls, root: Optional[str]) -> str:
        env = os.environ.get("CIFAR10_DIR", "")
        candidates = [root] if root else [p for p in (env, *cls.SEARCH) if p]
        for c in candidates:
            for base in (c, os.path.join(c, "cifar-10-batches-py")):
                if os.path.exists(os.path.join(base, "data_batch_1")):
                    return base
        raise FileNotFoundError(
            "CIFAR-10 not found. Place the extracted 'cifar-10-batches-py' directory "
            f"under one of {candidates} or set $CIFAR10_DIR (nothing is downloaded; "
            "use dataset='synthetic' for smoke runs)"
        )

    def augment(self, x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        return crop_mirror_augment(x, rng)


class Digits_data(Dataset):
    """scikit-learn's bundled handwritten digits (1,797 8x8 grayscale
    images, 10 classes): real data with nothing to download. Images are
    nearest-upsampled to ``size`` x ``size`` and replicated to 3 channels,
    split 80/20 from ``seed``, normalized with the train split's mean and
    std.

    ``augment_crop``: the CIFAR recipe's train augmentation
    (``crop_mirror_augment``). ``ten_crop_val``: the AlexNet-era 10-crop
    validation (4 corners + center of a 2-pixel reflect-padded image,
    each mirrored), rows view-major per image; the eval step averages
    the logits over the views."""

    name = "digits"

    def __init__(self, size: int = 16, val_frac: float = 0.2, seed: int = 0,
                 augment_crop: bool = False, ten_crop_val: bool = False):
        try:
            from sklearn.datasets import load_digits
        except ImportError as e:
            raise ImportError("dataset 'digits' needs scikit-learn (its bundled data); "
                              "use dataset='synthetic' without it") from e
        if size % 8:
            raise ValueError(f"size must be a multiple of 8, got {size}")
        digits = load_digits()
        x = digits.images.astype(np.float32)  # [N, 8, 8], values 0..16
        y = digits.target.astype(np.int32)
        rep = size // 8
        x = x.repeat(rep, axis=1).repeat(rep, axis=2)
        x = np.stack([x, x, x], axis=-1)  # [N, size, size, 3]
        self.image_shape = (size, size, 3)
        self.n_classes = 10
        order = np.random.RandomState(seed).permutation(len(x))
        n_val = int(len(x) * val_frac)
        val_idx, train_idx = order[:n_val], order[n_val:]
        self.x_train, self.y_train = x[train_idx], y[train_idx]
        self.x_val, self.y_val = x[val_idx], y[val_idx]
        # statistics of the train split only
        mean = self.x_train.mean()
        std = self.x_train.std() + 1e-7
        self.x_train = (self.x_train - mean) / std
        self.x_val = (self.x_val - mean) / std
        self.augment_crop = augment_crop
        self.val_views = 10 if ten_crop_val else 1

    def augment(self, x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        return crop_mirror_augment(x, rng) if self.augment_crop else x

    def val_epoch(self, batch_size: int, rows: slice = slice(None)) -> Iterator[tuple]:
        if self.val_views == 1:
            yield from super().val_epoch(batch_size, rows)
            return
        s = self.image_shape[0]
        for x, y in super().val_epoch(batch_size, rows):
            padded = np.pad(x, [(0, 0), (2, 2), (2, 2), (0, 0)], mode="reflect")
            h = padded.shape[1]
            oys = [0, 0, h - s, h - s, (h - s) // 2]
            oxs = [0, h - s, 0, h - s, (h - s) // 2]
            views = []
            for oy, ox in zip(oys, oxs):
                v = padded[:, oy:oy + s, ox:ox + s]
                views.append(v)
                views.append(v[:, :, ::-1])
            out = np.stack(views, axis=1).reshape(-1, s, s, x.shape[-1])
            yield np.ascontiguousarray(out), y


_REGISTRY = {
    "synthetic": Synthetic_data,
    "cifar10": Cifar10_data,
    "digits": Digits_data,
}


def register_dataset(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def get_dataset(name: str, **kwargs) -> Dataset:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; available in the port: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)
