"""The port's recorder (``utils/recorder.py``) against the JAX
package's: the same short run through both packages' ``run_training``
with ``save_dir`` writes JSONL rows of the same kinds, keys and steps,
and each package's pickled history loads with the other's
``Recorder.load_history``."""

import json
import warnings

import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu.launch.worker import run_training as j_run_training
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.utils.recorder import Recorder as JRecorder
from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.utils.recorder import Recorder

SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
DATA = {"n_train": 12, "n_val": 4}


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _shape(rows):
    """Each row's kind, keys and step (or epoch), the values left out."""
    return [(r["kind"], sorted(r), r.get("step", r.get("epoch"))) for r in rows]


def test_both_packages_write_the_same_rows(tmp_path):
    j_run_training("bsp", JAlexNet, devices=1, n_epochs=2, max_steps=5, dataset="synthetic",
                   dataset_kwargs=DATA, save_dir=str(tmp_path / "jax"), print_freq=0,
                   recipe_overrides=dict(compute_dtype=jnp.float32, **SMALL))
    run_training(model_cls=TAlexNet, device="cpu", n_epochs=2, max_steps=5, dataset="synthetic",
                 dataset_kwargs=DATA, save_dir=str(tmp_path / "port"), print_freq=2,
                 recipe_overrides=dict(compute_dtype=torch.float32, **SMALL))
    jrows = _rows(tmp_path / "jax" / "alexnet_bsp.jsonl")
    trows = _rows(tmp_path / "port" / "alexnet_bsp.jsonl")
    assert _shape(trows) == _shape(jrows)
    assert [r["step"] for r in trows if r["kind"] == "train"] == [1, 2, 3, 4, 5]
    assert [r["kind"] for r in trows if r["kind"] != "train"] == ["epoch", "val"] * 2
    train = [r for r in trows if r["kind"] == "train"]
    assert all(r["images_per_sec"] > 0 and r["lr"] == pytest.approx(0.01) for r in train)
    # the pickles cross too
    for load in (JRecorder.load_history, Recorder.load_history):
        hist = load(str(tmp_path / "port" / "alexnet_bsp_history.pkl"))
        assert [r["step"] for r in hist["history"]["train"]] == [1, 2, 3, 4, 5]
        assert len(hist["timings"]["step"]) == 5 and len(hist["timings"]["wait"]) == 5
        jhist = load(str(tmp_path / "jax" / "alexnet_bsp_history.pkl"))
        assert sorted(jhist["history"]) == sorted(hist["history"])


def test_recorder_brackets_history_and_console(tmp_path, capsys):
    rec = Recorder(save_dir=str(tmp_path), run_name="t", print_freq=2)
    rec.start("eval")
    dt = rec.end("eval")
    assert dt >= 0 and rec.timings["eval"] == [dt]
    rec.note_time("step", 0.5)
    rec.note_time("wait", 0.25)
    rec.train_metrics(1, {"loss": 1.5, "error": 0.7}, n_images=32)
    rec.train_metrics(2, {"loss": 1.25, "error": 0.5, "lr": 0.01}, n_images=32)
    rec.val_metrics(0, {"loss": 1.2, "error": 0.5, "top5_error": 0.1})
    rec.start_epoch()
    rec.end_epoch(0, n_images=320)
    rec.save()
    rec.close()
    out = capsys.readouterr().out.splitlines()
    # the reference's console lines
    assert out[0] == ("[rank 0] step 2 loss=1.2500 error=0.5000 lr=0.0100 wait=250.0ms "
                      "step=500.0ms 64 img/s")
    assert out[1] == "[rank 0] epoch 0 val: loss=1.2000 err=0.5000 top5_err=0.1000"
    assert out[2].startswith("[rank 0] epoch 0 done in ")
    rows = _rows(tmp_path / "t.jsonl")
    assert [r["kind"] for r in rows] == ["train", "train", "val", "epoch"]
    assert rows[0]["images_per_sec"] == 64.0 and rows[0]["step"] == 1
    hist = JRecorder.load_history(str(tmp_path / "t_history.pkl"))
    assert hist["history"]["train"][0]["loss"] == 1.5
    assert _mean_of_last_two(Recorder(print_freq=0), [0.1, 0.3]) == pytest.approx(0.2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert Recorder(print_freq=0).end("comm") == 0.0
    assert "without a matching start('comm')" in str(w[0].message)


def _mean_of_last_two(rec, times):
    for t in times:
        rec.note_time("step", t)
    return rec.mean_time("step", 2)
