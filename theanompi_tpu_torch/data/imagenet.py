"""ImageNet input: memory-mapped uint8 shards, and a synthetic stand-in
(port of ``theanompi_tpu/data/imagenet.py``).

Reference: ``models/data/imagenet.py`` over preprocessed hickle
file-batches (256x256 uint8) with ``img_mean`` subtraction and random
227-crop + mirror in the spawned loader (``lib/proc_load_mpi.py``;
SURVEY.md §2.1, §3.4). The shards are plain ``.npy`` files opened with
``np.load(mmap_mode='r')``; both packages read and write the same
format::

    <root>/
      train_images_0000.npy   uint8 [N, S, S, 3]   (S >= the crop, e.g. 256)
      train_labels_0000.npy   int   [N]
      ...more shards...
      val_images_0000.npy / val_labels_0000.npy
      mean.npy                float [S, S, 3] or [3]   (optional)

Shard order and the order within a shard are permuted every epoch
(seeded, the same on every rank); a batch never spans shards. Each
batch's rows are gathered by the native row gather, then cropped and
mirrored by the native crop (``native/``). With ``device_normalize``
(the default) batches stay uint8 and ``device_transform`` tells the
training loop to compute ``(x - mean) * scale`` on the card.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Iterator, Optional

import numpy as np

from theanompi_tpu_torch import native
from theanompi_tpu_torch.data.datasets import Dataset, gather, register_dataset

# the normalization constants of both datasets: mid-grey and ~ the
# global pixel std
MEAN = np.float32(127.5)
SCALE = np.float32(1.0 / 58.0)


def shard_path(directory: str, split: str, kind: str, i: int) -> str:
    """The canonical shard file name (``write_shards`` and the index agree)."""
    return os.path.join(directory, f"{split}_{kind}_{i:04d}.npy")


def shard_glob(directory: str, split: str, kind: str) -> str:
    return os.path.join(directory, f"{split}_{kind}_*.npy")


def write_shards(directory: str, split: str, images: np.ndarray, labels: np.ndarray,
                 shard_size: int = 1024) -> int:
    """Write uint8 images and their labels in the shard format above;
    returns the number of shards."""
    os.makedirs(directory, exist_ok=True)
    n_shards = -(-len(images) // shard_size)
    for i in range(n_shards):
        sl = slice(i * shard_size, (i + 1) * shard_size)
        np.save(shard_path(directory, split, "images", i), images[sl])
        np.save(shard_path(directory, split, "labels", i), labels[sl])
    return n_shards


class ImageNet_data(Dataset):
    """ImageNet-1k from preprocessed mmap shards under ``root`` (or
    ``$IMAGENET_DIR``). Train: random ``crop`` x ``crop`` crops, mirrored
    at random unless ``train_mirror=False``. Val: the center crop, or
    with ``val_crops=10`` the 4 corners + center, each mirrored."""

    name = "imagenet"
    n_classes = 1000

    SEARCH = ("/data/imagenet",)

    def __init__(self, root: Optional[str] = None, crop: int = 227, train_mirror: bool = True,
                 device_normalize: bool = True, val_crops: int = 1):
        base = self._find(root)
        if val_crops not in (1, 10):
            raise ValueError("val_crops must be 1 (center) or 10 (10-crop)")
        self.crop = crop
        self.train_mirror = train_mirror
        # 10: the eval step averages each image's logits over its views
        # (train.make_eval_step(views=10))
        self.val_views = val_crops
        self.image_shape = (crop, crop, 3)
        self._train = self._index(base, "train")
        self._val = self._index(base, "val")
        if not self._train:
            raise FileNotFoundError(f"no train_images_*.npy shards under {base}")
        mean_path = os.path.join(base, "mean.npy")
        # the reference's per-pixel img_mean, subtracted after the crop
        self.mean = np.load(mean_path).astype(np.float32) if os.path.exists(mean_path) else MEAN
        self.scale = SCALE
        # the training loop's contract (launch/worker.py): uint8 batches,
        # (x - mean) * scale on the card; None: float32 batches
        self.device_transform = ({"mean": self._mean_for_crop(crop), "scale": float(self.scale)}
                                 if device_normalize else None)

    @classmethod
    def _find(cls, root: Optional[str]) -> str:
        env = os.environ.get("IMAGENET_DIR", "")
        for c in ([root] if root else [p for p in (env, *cls.SEARCH) if p]):
            if glob.glob(shard_glob(c, "train", "images")):
                return c
        raise FileNotFoundError(
            "ImageNet shards not found; pass root= (--dataset-arg root=DIR) or set "
            "$IMAGENET_DIR to a directory of train/val_images_*.npy shards (format: "
            "theanompi_tpu_torch/data/imagenet.py; use dataset='imagenet_synthetic' "
            "without data)"
        )

    @staticmethod
    def _index(base: str, split: str) -> list:
        shards = []
        for img_path in sorted(glob.glob(shard_glob(base, split, "images"))):
            lbl_path = img_path.replace("_images_", "_labels_")
            shards.append((img_path, lbl_path, len(np.load(lbl_path, mmap_mode="r"))))
        return shards

    @property
    def n_train(self) -> int:
        return sum(n for _, _, n in self._train)

    @property
    def n_val(self) -> int:
        return sum(n for _, _, n in self._val)

    def n_train_batches(self, batch_size: int) -> int:
        return sum(n // batch_size for _, _, n in self._train)

    def n_val_batches(self, batch_size: int) -> int:
        return sum(n // batch_size for _, _, n in self._val)

    def train_epoch(self, epoch: int, batch_size: int, seed: int = 0,
                    rows: slice = slice(None),
                    out: Optional[Callable] = None) -> Iterator[tuple]:
        """``rows``: a rank's rows of each batch, cut from the unsorted
        permutation (a random subset), then sorted for sequential reads
        of the shard. ``out``: the allocator of each cropped batch (see
        ``datasets.gather``)."""
        rng = np.random.RandomState(seed * 100003 + epoch)
        order = rng.permutation(len(self._train))
        for si in order:
            img_path, lbl_path, n = self._train[si]
            images = np.load(img_path, mmap_mode="r")
            labels = np.load(lbl_path)
            perm = rng.permutation(n)
            for b in range(n // batch_size):
                idx = np.sort(perm[b * batch_size:(b + 1) * batch_size][rows])
                x = gather(images, idx)
                yield self._preprocess(x, rng, train=True, out=out), labels[idx].astype(np.int32)

    def val_epoch(self, batch_size: int, rows: slice = slice(None)) -> Iterator[tuple]:
        for img_path, lbl_path, n in self._val:
            images = np.load(img_path, mmap_mode="r")
            labels = np.load(lbl_path)
            for b in range(n // batch_size):
                sl = slice(b * batch_size, (b + 1) * batch_size)
                x = np.asarray(images[sl][rows])
                y = labels[sl][rows].astype(np.int32)
                if self.val_views == 10:
                    yield self._ten_crop(x), y
                else:
                    yield self._preprocess(x, None, train=False), y

    def _ten_crop(self, x: np.ndarray) -> np.ndarray:
        """4 corners + center, each mirrored: view-major rows per image
        ``[img0_v0..img0_v9, img1_v0, ...]``, so a rank's rows hold whole
        images. uint8 when normalizing on the card, float32 otherwise."""
        n, h, w, _ = x.shape
        c = self.crop
        oys = [0, 0, h - c, h - c, (h - c) // 2]
        oxs = [0, w - c, 0, w - c, (w - c) // 2]
        views = []
        for oy, ox in zip(oys, oxs):
            v = x[:, oy:oy + c, ox:ox + c]
            views.append(v)
            views.append(v[:, :, ::-1])
        out = np.stack(views, axis=1).reshape(n * 10, c, c, x.shape[-1])
        if self.device_transform is not None:
            return np.ascontiguousarray(out)
        return native.normalize_plain(out, self._mean_for_crop(c), self.scale)

    def _mean_for_crop(self, c: int) -> np.ndarray:
        """The mean as applied after the crop: a scalar or per-channel
        mean as it is; a full-plane mean center-cropped to ``c``."""
        if np.ndim(self.mean) == 3 and self.mean.shape[0] != c:
            y0 = (self.mean.shape[0] - c) // 2
            x0 = (self.mean.shape[1] - c) // 2
            return self.mean[y0:y0 + c, x0:x0 + c]
        return np.asarray(self.mean, np.float32)

    def _preprocess(self, x: np.ndarray, rng: Optional[np.random.RandomState],
                    train: bool, out: Optional[Callable] = None) -> np.ndarray:
        """Random crop + mirror (+ mean and scale on the host when not
        normalizing on the card); val: the center crop. The draws, in the
        reference's order: one ``randint`` over the (h-c+1)(w-c+1)
        offsets, then ``rand(n)`` for the flips, drawn even with
        ``train_mirror=False`` so the stream does not depend on it.
        uint8 images take the native kernels, any other dtype numpy."""
        n, h, w, _ = x.shape
        c = self.crop
        if train:
            offs = rng.randint(0, (h - c + 1) * (w - c + 1), size=n)
            oy, ox = offs // (w - c + 1), offs % (w - c + 1)
            flips = rng.rand(n) < 0.5
            if not self.train_mirror:
                flips = np.zeros(n, bool)
        else:
            oy = np.full(n, (h - c) // 2)
            ox = np.full(n, (w - c) // 2)
            flips = np.zeros(n, bool)
        native_route = x.dtype == np.uint8
        shape = (n, c, c, x.shape[-1])
        if self.device_transform is not None:
            if native_route:
                return native.crop_mirror_u8(x, oy, ox, flips, c,
                                             out=out(shape, np.uint8) if out else None)
            return native.crop_mirror_plain(x, oy, ox, flips, c)
        m = self._mean_for_crop(c)
        if native_route:
            return native.crop_mirror_normalize(x, oy, ox, flips, c, m, float(self.scale),
                                                out=out(shape, np.float32) if out else None)
        return native.crop_mirror_normalize_plain(x, oy, ox, flips, c, m, self.scale)


class Imagenet_synthetic(Dataset):
    """Shape-correct fake ImageNet (uint8 pixels, seeded, no disk): the
    stand-in for benchmarks and tests when no shards are at hand."""

    name = "imagenet_synthetic"

    # images drawn per randint call: the same stream as one call, without
    # its int64 temporary of the whole split
    DRAW_CHUNK = 256

    def __init__(self, n_train: int = 2048, n_val: int = 256, crop: int = 227,
                 n_classes: int = 1000, seed: int = 0, device_normalize: bool = True):
        self.image_shape = (crop, crop, 3)
        self.n_classes = n_classes
        self.mean = MEAN
        self.scale = SCALE
        self.device_transform = ({"mean": self.mean, "scale": float(self.scale)}
                                 if device_normalize else None)

        def make(n, salt):
            r = np.random.RandomState(seed + salt)
            y = r.randint(0, n_classes, size=n).astype(np.int32)
            x = np.empty((n, *self.image_shape), np.uint8)
            for i in range(0, n, self.DRAW_CHUNK):
                k = min(self.DRAW_CHUNK, n - i)
                x[i:i + k] = r.randint(0, 256, size=(k, *self.image_shape))
            return x, y

        self.x_train, self.y_train = make(n_train, 1)
        self.x_val, self.y_val = make(n_val, 2)

    def augment(self, x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        if self.device_transform is not None:
            return x  # uint8, normalized on the card
        return native.normalize_plain(x, self.mean, self.scale)

    def val_epoch(self, batch_size: int, rows: slice = slice(None)) -> Iterator[tuple]:
        for x, y in super().val_epoch(batch_size, rows):
            if self.device_transform is None:
                x = native.normalize_plain(x, self.mean, self.scale)
            yield x, y


register_dataset("imagenet", ImageNet_data)
register_dataset("imagenet_synthetic", Imagenet_synthetic)
