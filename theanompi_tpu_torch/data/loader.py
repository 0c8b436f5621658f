"""The prefetch loader (port of ``theanompi_tpu/data/loader.py``).

Reference: ``lib/proc_load_mpi.py``, one MPI-spawned loader process per
worker that loaded, preprocessed and double-buffered batches behind the
GPU's compute (SURVEY.md §3.4). Here a background thread runs the host
side of the pipeline (the dataset's gather and crop, whose native calls
release the interpreter lock, and ``place``: pinning in the training
loop) up to ``depth`` batches ahead, while the main thread launches the
current step; the copy to the card is a non-blocking one from pinned
memory, issued by the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from theanompi_tpu_torch.utils.hostaffinity import pin_thread


def pinned_array(shape, dtype) -> np.ndarray:
    """A batch buffer in pinned host memory from PyTorch's caching host
    allocator, as the numpy view that a dataset's ``out=`` allocator
    returns: the native gather and crop write the batch straight into
    it, with no fresh pages to fault in and no pin copy after."""
    like = torch.from_numpy(np.empty(0, dtype))
    return torch.empty(tuple(shape), dtype=like.dtype, pin_memory=True).numpy()


def host_tensors(batch, pin: bool) -> tuple:
    """A host batch of numpy arrays as CPU tensors, pinned when ``pin``
    so that the copy to the card is asynchronous. An array that is the
    whole numpy view of a pinned tensor (``pinned_array``) goes as that
    tensor, uncopied: the caching host allocator then keeps its block
    from reuse until the non-blocking copy from it is done. Any other
    array is copied into pinned memory."""
    out = []
    for a in batch:
        base = a.base
        if (pin and isinstance(base, torch.Tensor) and base.is_pinned()
                and base.data_ptr() == a.ctypes.data and tuple(base.shape) == a.shape
                and base.is_contiguous()):
            out.append(base)
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.pin_memory() if pin else t)
    return tuple(out)


class PrefetchLoader:
    """Wrap a host batch iterator; yield ``place(batch)`` up to ``depth``
    batches ahead of consumption, from a thread named ``tmpi-prefetch``.

    ``place`` (default: the batch unchanged) runs on that thread. An
    exception raised there (the dataset, ``place``, or a malformed
    ``TMPI_LOADER_CPUS``) is re-raised at the consumer's next
    ``__next__``. Use it as a context manager, or ``close()`` it, so the
    thread ends when the consumer stops early or raises."""

    _SENTINEL = object()

    def __init__(self, batches: Iterable, place: Optional[Callable] = None, depth: int = 2):
        self._place = place or (lambda b: b)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iter(batches),),
                                        name="tmpi-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Block until ``item`` is queued or ``close()`` stops the thread."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator) -> None:
        try:
            # the hwloc equivalent: the loader thread (and the native
            # threads it starts) on TMPI_LOADER_CPUS; inside the try, so
            # a malformed cpuset reaches the consumer as an error
            pin_thread()
            for batch in it:
                if self._stop.is_set() or not self._put(self._place(batch)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            # the sentinel must reach the consumer even through a full
            # queue (production outpacing the step is the normal case),
            # or the consumer blocks in get() at the end of the epoch
            self._put(self._SENTINEL)

    def close(self) -> None:
        """Stop the producer and drop prefetched batches. Idempotent."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
