"""Session API and rank launcher (port of ``theanompi_tpu/launch/session.py``).

``rule.init(devices, modelfile, modelclass)`` resolves the model class
and runs the training loop, blocking or on a background thread that
``wait()`` joins. With ``devices=n > 1`` it runs one process per rank
(``spawn_ranks``), the way Theano-MPI ran one MPI process per GPU: each
rank joins a ``torch.distributed`` process group through a ``file://``
rendezvous in a fresh temporary directory, on its own card (``cuda:r``,
NCCL) unless the caller names a device (``"cpu"``: gloo; ``"cuda:k"``:
every rank on card k, which needs gloo).
"""

from __future__ import annotations

import importlib
import importlib.util
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


def resolve_model(modelfile: str, modelclass: str):
    """Import ``modelclass`` from ``modelfile``: a zoo short name
    (``alexnet``), a module path (``theanompi_tpu_torch.models.alex_net``)
    or a ``.py`` file path."""
    from theanompi_tpu_torch.models import MODEL_REGISTRY

    if modelfile in MODEL_REGISTRY:
        modelfile = MODEL_REGISTRY[modelfile][0]
    if modelfile.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_tmpi_model", modelfile)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(modelfile)
    return getattr(mod, modelclass)


# --------------------------------------------------------------------------
# one process per rank
# --------------------------------------------------------------------------


def rank_devices(n: int, device=None) -> list:
    """The device of each of ``n`` ranks: ``cuda:r`` by default (raises
    without ``n`` visible cards), else ``device`` for every rank."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; BSP ranks run on the cards unless "
                "asked otherwise — pass device='cpu' (--device cpu) to run on the CPU"
            )
        count = torch.cuda.device_count()
        if count < n:
            raise RuntimeError(f"BSP over {n} ranks needs {n} cards; {count} visible")
        return [torch.device("cuda", r) for r in range(n)]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return [dev] * n


def _rank_main(rank, n, init_method, backend, device, fn, args, results):
    from theanompi_tpu_torch.parallel.distributed import initialize_distributed

    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        initialize_distributed(init_method, n, rank, device=device, backend=backend)
        results.put((rank, True, fn(rank, n, device, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs, grace: float = 10.0) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(timeout=5)


def spawn_ranks(fn: Callable, n: int, args: tuple = (), *, device=None,
                backend: Optional[str] = None, timeout: Optional[float] = None) -> list:
    """Run ``fn(rank, n, device, *args)`` in ``n`` fresh processes (spawn),
    each one rank of a process group, and return their results in rank
    order. ``fn`` must be importable (a module-level function) and return
    something picklable; CPU tensors would be shared through memory that
    dies with the rank, so return numpy arrays or plain values. A rank
    that raises or dies stops the others, and the error is raised here
    with that rank's traceback; so is a run longer than ``timeout``
    seconds."""
    from theanompi_tpu_torch.parallel.distributed import default_backend

    devices = rank_devices(n, device)
    backend = backend or default_backend(devices[0])
    if backend == "nccl" and len(set(devices)) < n:
        raise ValueError(
            f"NCCL needs one card per rank, but the {n} ranks share {devices[0]}; "
            "use backend 'gloo' to run several ranks on one card"
        )
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdv_dir = tempfile.mkdtemp(prefix="tmpi-rdv-")
    init_method = "file://" + os.path.join(rdv_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main, name=f"tmpi-rank{r}",
                         args=(r, n, init_method, backend, devices[r], fn, args, results))
             for r in range(n)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "before returning a result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(rdv_dir, ignore_errors=True)
    return [out[r] for r in range(n)]


def _train_rank(rank, n, device, rule, modelfile, modelclass, kwargs):
    from theanompi_tpu_torch.launch.worker import run_training

    return run_training(rule=rule, model_cls=resolve_model(modelfile, modelclass),
                        devices=n, device=device, **kwargs)


def launch_training(rule: str, devices: int, modelfile: str, modelclass: str, *,
                    backend: Optional[str] = None, **kwargs) -> dict:
    """Train through ``run_training``: in this process for one device,
    else in one spawned process per rank (``spawn_ranks``); returns rank
    0's summary (which holds every rank's step time and launch counts).
    ``kwargs`` are ``run_training``'s (``fused_update``, ``pool_kernel``,
    ``strategy``, ``ckpt_dir``, ``resume``, ...), passed to every rank."""
    if devices <= 1:
        from theanompi_tpu_torch.launch.worker import run_training

        return run_training(rule=rule, model_cls=resolve_model(modelfile, modelclass),
                            devices=devices, **kwargs)
    device = kwargs.pop("device", None)
    return spawn_ranks(_train_rank, devices, (rule, modelfile, modelclass, kwargs),
                       device=device, backend=backend)[0]


class SyncRule:
    """Base rule: subclasses set ``rule_name``."""

    rule_name: str = "base"

    def __init__(self, **rule_kwargs):
        self.rule_kwargs = rule_kwargs
        self._thread: Optional[threading.Thread] = None
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def init(self, devices=1, modelfile: str = "alexnet", modelclass: str = "AlexNet",
             blocking: bool = False, **overrides):
        """Start training (``run_training`` kwargs, and ``backend`` for
        several ranks, in ``overrides``). With ``blocking=False`` training
        runs on a background thread and ``wait()`` joins it."""
        self._thread = None
        self._result = None
        self._error = None
        resolve_model(modelfile, modelclass)  # fail here on a bad name
        kwargs = {**self.rule_kwargs, **overrides}

        def _run():
            try:
                self._result = launch_training(self.rule_name, devices, modelfile,
                                               modelclass, **kwargs)
            except BaseException as e:  # surfaced in wait()
                self._error = e

        if blocking:
            _run()
            if self._error is not None:
                raise self._error
            return self._result
        self._thread = threading.Thread(target=_run, name=f"tmpi-{self.rule_name}", daemon=True)
        self._thread.start()
        return self

    def wait(self):
        """Block until training finishes; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result


class BSP(SyncRule):
    """Bulk-synchronous data parallelism over one or more ranks."""

    rule_name = "bsp"


class EASGD(SyncRule):
    """Elastic-averaging SGD: a worker a rank (or a group of ranks) and a
    replicated center, the elastic exchange every ``avg_freq`` steps
    (``parallel/easgd.py``)."""

    rule_name = "easgd"


class GOSGD(SyncRule):
    """Gossip SGD: randomized peer-to-peer share-weighted averaging
    between the workers (``parallel/gosgd.py``)."""

    rule_name = "gosgd"
