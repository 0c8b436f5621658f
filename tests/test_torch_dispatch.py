"""How far the host runs ahead (``theanompi_tpu_torch/utils/dispatch.py``)
on the CPU: the recorder's JSONL rows of a run are the same at dispatch
depth 1, 3 and the default (drains every ``print_freq`` steps), apart
from the wall-clock fields, per step and in groups of steps, and no
more than K steps are ever in flight at depth K. The reference's
contract (its ``tests/test_dispatch.py``): deeper pipelines emit the
same rows, later."""

import json
import pathlib
import shutil
import tempfile

import pytest

import torch

from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.utils.dispatch import MetricsDispatcher

SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
DATA = {"n_train": 12, "n_val": 4}
# wall-clock fields of the rows
CLOCK = {"images_per_sec", "seconds"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root():
    d = pathlib.Path(tempfile.mkdtemp(prefix="tmpi-dispatch-"))
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _rows(root, label, **kw):
    d = root / label
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = run_training(model_cls=AlexNet, device="cpu", fused_update=True, dataset="synthetic",
                         dataset_kwargs=DATA, n_epochs=2, print_freq=4, save_dir=str(d),
                         recipe_overrides=dict(compute_dtype=torch.float32, **SMALL), **kw)
    finally:
        torch.set_num_threads(n)
    rows = [json.loads(line) for line in open(d / "alexnet_bsp.jsonl")]
    return s, [{k: v for k, v in r.items() if k not in CLOCK} for r in rows]


@pytest.fixture(scope="module")
def default_rows(root):
    return _rows(root, "default")


@pytest.mark.parametrize("depth,k", [(1, 1), (3, 1), (2, 3), (None, 3)],
                         ids=["depth1", "depth3", "depth2-groups3", "default-groups3"])
def test_rows_are_the_same_at_every_depth(root, default_rows, depth, k):
    s, rows = _rows(root, f"d{depth}-k{k}", dispatch_depth=depth, steps_per_dispatch=k)
    base, want = default_rows
    assert [r["step"] for r in rows if r["kind"] == "train"] == list(range(1, 7))
    assert rows == want
    assert s["losses"] == base["losses"] and s["dispatch_depth"] == depth
    if depth is not None:
        assert s["max_in_flight"] <= depth
    else:
        assert base["max_in_flight"] == 3  # one epoch's steps, no bound


class _Mark:
    def __init__(self, log, step):
        self.log, self.step = log, step

    def synchronize(self):
        self.log.append(self.step)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_no_more_than_depth_steps_are_ever_in_flight(depth):
    drained, waited = [], []
    disp = MetricsDispatcher(lambda entries, partial: drained.append(
        ([e[0] for e in entries], partial)), depth=depth)
    peak = 0
    for step in range(1, 13):
        disp.enqueued(step, _Mark(waited, step))
        peak = max(peak, disp.in_flight + 1)  # the step the next enqueue adds
        disp.push([(step,)], step - 1, step)
    assert disp.max_in_flight == depth and peak <= depth
    assert waited == list(range(1, 13 - depth + 1))  # the oldest first, each once
    disp.flush()
    assert [s for steps, _ in drained for s in steps] == list(range(1, 13))
    assert drained[-1][1] is False
