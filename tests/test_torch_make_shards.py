"""``theanompi_tpu_torch/tools/make_shards.py`` against the reference's
``theanompi_tpu/tools/make_shards.py``: on a tree of tiny images that
the test writes with PIL (portrait, landscape, square, greyscale, PNG, a
corrupt file), both write byte-identical shard ``.npy`` files,
``mean.npy`` and ``class_index.json``, one process or a pool, shuffled or
not; an unknown val class is refused by both; without PIL the port
raises naming it. The shards load in the port's ImageNet dataset."""

import json
import os

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from theanompi_tpu.tools import make_shards as ref  # noqa: E402
from theanompi_tpu_torch.tools import make_shards as port  # noqa: E402

SIZES = [(23, 17), (17, 29), (20, 20), (40, 13), (9, 31)]


def _tree(root, classes=("cat", "dog", "emu"), per_class=5, splits=("train", "val")):
    r = np.random.RandomState(0)
    for split in splits:
        for ci, cls in enumerate(classes):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(per_class if split == "train" else 2):
                w, h = SIZES[(i + ci) % len(SIZES)]
                arr = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
                if i == 3:
                    Image.fromarray(arr[..., 0], "L").save(d / f"g{i}.jpg", quality=90)
                elif i == 4:
                    Image.fromarray(arr).save(d / f"p{i}.png")
                else:
                    Image.fromarray(arr).save(d / f"im{i}.JPEG", quality=90)
            (d / "notes.txt").write_text("not an image")
    (root / "train" / "cat" / "broken.jpg").write_bytes(b"\xff\xd8 truncated")
    return root


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("workers,shuffle", [(1, 0), (2, 0), (1, None)])
def test_convert_split_byte_identical_to_reference(tmp_path, workers, shuffle):
    src = _tree(tmp_path / "in")
    outs = {}
    for name, mod in (("ref", ref), ("port", port)):
        out = tmp_path / name
        info = mod.convert_split(str(src), str(out), "train", size=8, shard_size=4,
                                 workers=workers, shuffle_seed=shuffle, compute_mean=True)
        info_val = mod.convert_split(str(src), str(out), "val", size=8, shard_size=4,
                                     workers=workers, shuffle_seed=shuffle,
                                     class_index=info["class_index"])
        outs[name] = (info, info_val, _files(out))
    (ri, rv, rf), (pi, pv, pf) = outs["ref"], outs["port"]
    assert pi == ri and pv == rv
    assert pi["n_images"] == 15 and pi["n_shards"] == 4 and pv["n_images"] == 6
    assert sorted(pf) == sorted(rf)
    assert {"mean.npy", "class_index.json", "train_images_0003.npy",
            "val_labels_0001.npy"} <= set(pf)
    for f in rf:
        assert pf[f] == rf[f], f
    assert json.loads(pf["class_index.json"]) == {"cat": 0, "dog": 1, "emu": 2}


def test_cli_byte_identical_and_loads_in_the_ports_dataset(tmp_path, capsys):
    src = _tree(tmp_path / "in")
    argv = ["--size", "8", "--shard-size", "6", "--workers", "2", "--splits", "val,train"]
    assert ref.main([str(src), str(tmp_path / "ref"), *argv]) == 0
    ref_lines = capsys.readouterr().out.strip().splitlines()
    assert port.main([str(src), str(tmp_path / "port"), *argv]) == 0
    port_lines = capsys.readouterr().out.strip().splitlines()
    assert port_lines == ref_lines
    assert [json.loads(x)["split"] for x in port_lines] == ["train", "val"]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")

    from theanompi_tpu_torch.data.imagenet import ImageNet_data

    data = ImageNet_data(root=str(tmp_path / "port"), crop=6)
    assert data.n_train == 15 and data.n_val == 6
    x, y = next(data.train_epoch(0, 5))
    assert x.shape == (5, 6, 6, 3) and x.dtype == np.uint8 and set(y) <= {0, 1, 2}


def test_unknown_val_class_is_refused_by_both(tmp_path):
    src = _tree(tmp_path / "in", splits=("train",))
    (src / "val" / "yak").mkdir(parents=True)
    Image.fromarray(np.zeros((9, 9, 3), np.uint8)).save(src / "val" / "yak" / "a.jpg")
    for mod in (ref, port):
        info = mod.convert_split(str(src), str(tmp_path / mod.__name__), "train", size=8,
                                 shard_size=4)
        with pytest.raises(ValueError, match="absent from the train split"):
            mod.convert_split(str(src), str(tmp_path / mod.__name__), "val", size=8,
                              class_index=info["class_index"])


def test_empty_split_is_refused(tmp_path):
    (tmp_path / "in" / "train" / "cat").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no images"):
        port.convert_split(str(tmp_path / "in"), str(tmp_path / "out"), "train")


def test_missing_pil_raises_naming_it(tmp_path, monkeypatch):
    src = _tree(tmp_path / "in", splits=("train",))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        port.convert_split(str(src), str(tmp_path / "out"), "train", size=8)


def test_cli_flags_are_the_references():
    flags = {a.dest for a in port.build_parser()._actions} - {"help"}
    assert flags == {"in_dir", "out_dir", "size", "shard_size", "workers", "splits",
                     "no_shuffle"}
