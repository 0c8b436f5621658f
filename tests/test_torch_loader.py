"""The port's PrefetchLoader (``theanompi_tpu_torch/data/loader.py``) held
to the reference's loader semantics, the cases of ``tests/test_loader.py``:
order, the end of an epoch with a full queue (the sentinel must still
arrive), a producer's error re-raised at the consumer, close mid-epoch,
the context manager, an idempotent close; and the prefetch thread's
pinning to ``TMPI_LOADER_CPUS``, a malformed cpuset surfacing at the
consumer."""

import os
import threading
import time

import numpy as np
import pytest

from theanompi_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from theanompi_tpu_torch.data.loader import PrefetchLoader, host_tensors


def _host_place(b):
    return b


@pytest.mark.parametrize("place", [None, _host_place])
def test_yields_all_batches_in_order_as_the_reference(place):
    batches = [np.full((2,), i) for i in range(7)]
    out = list(PrefetchLoader(batches, place=place, depth=2))
    ref = list(JPrefetchLoader(batches, place=_host_place, depth=2))
    assert len(out) == len(ref) == 7
    for i, (a, b) in enumerate(zip(out, ref)):
        np.testing.assert_array_equal(a, batches[i])
        np.testing.assert_array_equal(a, b)


def test_place_runs_on_the_prefetch_thread():
    names = []

    def place(b):
        names.append(threading.current_thread().name)
        return b * 2

    out = list(PrefetchLoader([np.ones(2)] * 3, place=place, depth=1))
    assert names == ["tmpi-prefetch"] * 3
    assert all(np.array_equal(b, [2, 2]) for b in out)


@pytest.mark.parametrize("depth", [1, 2])
def test_end_of_epoch_with_full_queue_no_deadlock(depth):
    n_batches = depth + 4
    batches = [np.full((2,), i) for i in range(n_batches)]
    loader = PrefetchLoader(batches, place=_host_place, depth=depth)
    time.sleep(0.3)  # the producer runs to exhaustion against a full queue
    seen = []
    done = threading.Event()

    def consume():
        for b in loader:  # slow consumer
            seen.append(int(b[0]))
            time.sleep(0.05)
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert done.wait(timeout=10.0), f"consumer deadlocked; consumed {len(seen)}/{n_batches}"
    assert seen == list(range(n_batches))


@pytest.mark.parametrize("where", ["dataset", "place"])
def test_producer_error_reraised_at_consumer(where):
    def gen():
        yield np.zeros((2,))
        if where == "dataset":
            raise RuntimeError("boom in pipeline")
        yield np.ones((2,))

    def place(b):
        if where == "place" and b[0] == 1:
            raise RuntimeError("boom in pipeline")
        return b

    loader = PrefetchLoader(gen(), place=place, depth=2)
    next(loader)
    with pytest.raises(RuntimeError, match="boom in pipeline"):
        for _ in range(3):
            next(loader)


def test_close_mid_epoch_stops_producer():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield np.full((2,), i)

    loader = PrefetchLoader(gen(), place=_host_place, depth=2)
    next(loader)
    loader.close()
    assert loader._thread.is_alive() is False
    assert len(produced) < 1000


def test_context_manager_closes_producer_on_exit():
    with PrefetchLoader([np.zeros((2,))] * 50, place=_host_place, depth=2) as loader:
        next(loader)
    assert loader._stop.is_set()
    assert loader._thread.is_alive() is False


def test_context_manager_closes_on_consumer_exception():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield np.full((2,), i)

    with pytest.raises(RuntimeError, match="consumer died"):
        with PrefetchLoader(gen(), place=_host_place, depth=2) as loader:
            next(loader)
            raise RuntimeError("consumer died")
    assert loader._thread.is_alive() is False
    assert len(produced) < 1000


def test_close_is_idempotent():
    loader = PrefetchLoader([np.zeros((2,))] * 10, place=_host_place, depth=2)
    next(loader)
    loader.close()
    loader.close()
    assert loader._thread.is_alive() is False


def test_prefetch_thread_is_pinned_to_the_loader_cpuset(monkeypatch):
    allowed = sorted(os.sched_getaffinity(0))
    monkeypatch.setenv("TMPI_LOADER_CPUS", str(allowed[-1]))
    masks = []

    def place(b):
        masks.append(os.sched_getaffinity(0))
        return b

    with PrefetchLoader([np.zeros(2)] * 2, place=place, depth=1) as loader:
        assert len(list(loader)) == 2
    assert masks == [{allowed[-1]}] * 2
    assert os.sched_getaffinity(0) == set(allowed)  # the consumer's mask is untouched


def test_malformed_cpuset_surfaces_at_the_consumer(monkeypatch):
    monkeypatch.setenv("TMPI_LOADER_CPUS", "a-b")
    with PrefetchLoader([np.zeros(2)] * 3, place=_host_place, depth=1) as loader:
        with pytest.raises(ValueError):
            next(loader)


def test_host_tensors_without_pinning_share_the_arrays():
    x = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    y = np.arange(2, dtype=np.int32)
    xt, yt = host_tensors((x, y), pin=False)
    assert xt.data_ptr() == x.ctypes.data and yt.data_ptr() == y.ctypes.data
    np.testing.assert_array_equal(xt.numpy(), x)
    # a strided view is made contiguous
    (st,) = host_tensors((x[:, ::2],), pin=False)
    assert st.is_contiguous()
    np.testing.assert_array_equal(st.numpy(), x[:, ::2])
