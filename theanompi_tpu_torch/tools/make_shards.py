"""JPEG tree -> the ``.npy`` shards of ``data/imagenet.py`` + ``mean.npy``
(port of ``theanompi_tpu/tools/make_shards.py``).

Theano-MPI trained from 256x256 uint8 batch files made by an offline
pipeline, with a precomputed ``img_mean`` (SURVEY.md §3.4). This tool is
the port's converter: a class-per-directory image tree (the standard
ImageNet layout) becomes the shard format of
:mod:`theanompi_tpu_torch.data.imagenet`, streaming (one shard in memory),
decoded by a ``multiprocessing.Pool`` of ``--workers``, with the per-pixel
mean of the train split. It writes the reference's files byte for byte.

Resize rule: shorter side to ``--size`` with bilinear interpolation, then
a centre crop to ``size x size``, RGB. Labels are the sorted
class-directory names of the train split, written to
``class_index.json``; another split reuses them, and a class that the
train split lacks is an error.

Usage::

    python -m theanompi_tpu_torch.tools.make_shards IN_DIR OUT_DIR \\
        [--size 256] [--shard-size 1024] [--workers N] [--splits train,val]

IN_DIR holds ``train/<class>/*.JPEG`` (and optionally ``val/<class>/...``);
any extension PIL reads works. Decoding needs PIL (Pillow), imported by
the decode worker only; without it the tool raises naming it. Nothing
else of the port imports PIL.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from multiprocessing import Pool
from typing import Iterator, Optional

import numpy as np

from theanompi_tpu_torch.data.imagenet import shard_path

_EXTS = (".jpeg", ".jpg", ".png", ".bmp")


def _list_split(split_dir: str, class_to_label: Optional[dict] = None
                ) -> tuple[dict, list[tuple[str, int]]]:
    """The class -> label mapping and the (path, label) pairs of a split.

    With ``class_to_label`` given (the train split's), this split's class
    directories are looked up in it: an unknown class is an error, and a
    split missing some classes keeps the train labels."""
    dirs = sorted(d for d in os.listdir(split_dir)
                  if os.path.isdir(os.path.join(split_dir, d)))
    if class_to_label is None:
        class_to_label = {c: i for i, c in enumerate(dirs)}
    else:
        unknown = [d for d in dirs if d not in class_to_label]
        if unknown:
            raise ValueError(
                f"{split_dir} has classes absent from the train split: "
                f"{unknown[:5]}{'...' if len(unknown) > 5 else ''} — labels "
                "are defined by the train class index")
    samples = []
    for cls in dirs:
        cdir = os.path.join(split_dir, cls)
        label = class_to_label[cls]
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(_EXTS):
                samples.append((os.path.join(cdir, f), label))
    return class_to_label, samples


def _decode_one(args: tuple[str, int, int]) -> Optional[tuple[np.ndarray, int]]:
    """Decode, resize the shorter side, centre-crop; ``None`` for a
    corrupt file (logged and skipped). Raises ``ImportError`` without
    PIL."""
    path, label, size = args
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("make_shards decodes images with PIL (the Pillow package), "
                          "which is not installed") from e
    try:
        with Image.open(path) as im:
            im = im.convert("RGB")
            w, h = im.size
            if w <= h:
                nw, nh = size, max(size, round(h * size / w))
            else:
                nh, nw = size, max(size, round(w * size / h))
            im = im.resize((nw, nh), Image.BILINEAR)
            left = (nw - size) // 2
            top = (nh - size) // 2
            im = im.crop((left, top, left + size, top + size))
            return np.asarray(im, dtype=np.uint8), label
    except Exception as e:  # noqa: BLE001  a corrupt or truncated file
        print(f"skipping {path}: {e}", file=sys.stderr)
        return None


def _decoded_stream(samples: list[tuple[str, int]], size: int, workers: int
                    ) -> Iterator[tuple[np.ndarray, int]]:
    jobs = ((p, lbl, size) for p, lbl in samples)
    if workers <= 1:
        for j in jobs:
            out = _decode_one(j)
            if out is not None:
                yield out
        return
    with Pool(workers) as pool:
        for out in pool.imap(_decode_one, jobs, chunksize=16):
            if out is not None:
                yield out


def convert_split(in_dir: str, out_dir: str, split: str, size: int = 256,
                  shard_size: int = 1024, workers: int = 1,
                  shuffle_seed: Optional[int] = 0, compute_mean: bool = False,
                  class_index: Optional[dict] = None) -> dict:
    """Convert one split; returns ``{n_images, n_shards, class_index}``.

    ``shuffle_seed`` shuffles the (path, label) list once before sharding,
    so that each shard mixes classes (a batch never spans shards); None
    keeps the class-sorted order. ``class_index`` (class -> label) pins
    the labels across splits: pass the train mapping when converting
    another split. Without it the mapping comes from this split's sorted
    directories and is written to ``class_index.json``."""
    split_dir = os.path.join(in_dir, split)
    writes_index = class_index is None
    class_index, samples = _list_split(split_dir, class_index)
    if not samples:
        raise FileNotFoundError(f"no images under {split_dir}")
    if shuffle_seed is not None:
        order = np.random.RandomState(shuffle_seed).permutation(len(samples))
        samples = [samples[i] for i in order]
    os.makedirs(out_dir, exist_ok=True)

    mean_acc = np.zeros((size, size, 3), np.float64) if compute_mean else None
    buf_x = np.empty((shard_size, size, size, 3), np.uint8)
    buf_y = np.empty((shard_size,), np.int64)
    fill = shard_i = total = 0

    def flush(n: int) -> None:
        nonlocal shard_i
        np.save(shard_path(out_dir, split, "images", shard_i), buf_x[:n])
        np.save(shard_path(out_dir, split, "labels", shard_i), buf_y[:n])
        shard_i += 1

    for img, label in _decoded_stream(samples, size, workers):
        buf_x[fill] = img
        buf_y[fill] = label
        if mean_acc is not None:
            mean_acc += img
        fill += 1
        total += 1
        if fill == shard_size:
            flush(fill)
            fill = 0
    if fill:
        flush(fill)

    if mean_acc is not None and total:
        np.save(os.path.join(out_dir, "mean.npy"), (mean_acc / total).astype(np.float32))
    if writes_index:
        with open(os.path.join(out_dir, "class_index.json"), "w") as f:
            json.dump(class_index, f, indent=0)
    return {"n_images": total, "n_shards": shard_i, "class_index": class_index}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m theanompi_tpu_torch.tools.make_shards",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("in_dir", help="image tree: <in_dir>/<split>/<class>/*.jpeg")
    ap.add_argument("out_dir", help="shard output directory (--dataset-arg root=)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--shard-size", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--splits", default="train,val")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="keep class-sorted order (debugging only: batches never span "
                         "shards, so unshuffled shards bias them)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    splits = [s.strip() for s in args.splits.split(",") if s.strip()]
    # train defines the class index; every other split reuses it
    splits.sort(key=lambda s: s != "train")
    class_index = None
    for split in splits:
        info = convert_split(args.in_dir, args.out_dir, split, size=args.size,
                             shard_size=args.shard_size, workers=args.workers,
                             shuffle_seed=None if args.no_shuffle else 0,
                             compute_mean=(split == "train"), class_index=class_index)
        class_index = info["class_index"]
        print(json.dumps({"split": split, "n_images": info["n_images"],
                          "n_shards": info["n_shards"], "n_classes": len(class_index)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
