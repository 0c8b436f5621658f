"""Host-side datasets (port of ``theanompi_tpu/data/datasets.py``).

``Synthetic_data`` draws with the same numpy seeding as the reference,
so the two packages see identical batches for a seed. The token
datasets (``data/lm.py``) register themselves here. ``Cifar10_data``
is ported once its files are available to test against.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class Dataset:
    """Host-side dataset of (images NHWC float32, labels int32).

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
                    rows: slice = slice(None)) -> Iterator[tuple]:
        """Deterministically shuffled epoch (seed + epoch -> permutation),
        the reference's order exactly. ``rows``: only these rows of each
        batch (a rank's shard), gathered alone."""
        rng = np.random.RandomState(seed * 100003 + epoch)
        perm = rng.permutation(self.n_train)
        for i in range(self.n_train_batches(batch_size)):
            idx = perm[i * batch_size:(i + 1) * batch_size][rows]
            yield self.x_train[idx], self.y_train[idx]

    def val_epoch(self, batch_size: int, rows: slice = slice(None)) -> Iterator[tuple]:
        for i in range(self.n_val_batches(batch_size)):
            idx = np.arange(i * batch_size, (i + 1) * batch_size)[rows]
            yield self.x_val[idx], self.y_val[idx]


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


_REGISTRY = {
    "synthetic": Synthetic_data,
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
