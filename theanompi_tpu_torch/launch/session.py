"""Session API and rank launcher (port of ``theanompi_tpu/launch/session.py``).

``rule.init(devices, modelfile, modelclass)`` resolves the model class
and runs the training loop, blocking or on a background thread that
``wait()`` joins. With ``devices=n > 1`` it runs one process per rank
(``spawn_ranks``), the way Theano-MPI ran one MPI process per GPU: each
rank joins a ``torch.distributed`` process group through a ``file://``
rendezvous in a fresh temporary directory, on its own card (``cuda:r``,
NCCL) unless the caller names a device (``"cpu"``: gloo; ``"cuda:k"``:
every rank on card k, which needs gloo).

A rank's failure comes back to the parent as the same exception type
when it is one the supervisor tells apart (``Preempted``,
``TopologyChanged``, ``InjectedCrash``, ``OSError`` with its errno),
with its ``step`` / ``new_world``, and the rank's traceback in the
message; any other failure as ``RuntimeError``. The other ranks get
``REPORT_GRACE`` seconds to report (ranks that fail alike, as an
injected fault fires on every rank), or ``FAIL_GRACE`` seconds while a
rank may still be writing (every rank's crash save under
``--ckpt-sharded``, rank 0's preemption save), before they are stopped;
the wait ends once every rank has exited. SIGTERM sent to the parent
while ranks run is forwarded to each of them (their grace handlers
decide what it means).
"""

from __future__ import annotations

import importlib
import importlib.util
import multiprocessing as mp
import os
import queue
import shutil
import signal
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


# seconds the other ranks get to report after one fails, before they
# are stopped: REPORT_GRACE for ranks that fail alike, FAIL_GRACE while
# a rank may still be writing a save (module docstring)
REPORT_GRACE = 3.0
FAIL_GRACE = 30.0


def _exc_payload(e: BaseException) -> dict:
    """What the parent needs to raise ``e``'s type again: its class and
    the attributes the supervisor reads."""
    from theanompi_tpu_torch.ops.kernels import launch_counts
    from theanompi_tpu_torch.utils.faults import InjectedCrash, Preempted, TopologyChanged

    t = {"t_fail": getattr(e, "t_fail", None), "launches": launch_counts()}
    for cls in (Preempted, TopologyChanged, InjectedCrash):
        if isinstance(e, cls):
            return {"type": cls.__name__, "step": getattr(e, "step", None),
                    "kind": getattr(e, "kind", None), "new_world": getattr(e, "new_world", None),
                    **t}
    if isinstance(e, OSError):
        return {"type": "OSError", "errno": e.errno, **t}
    return {"type": "RuntimeError", **t}


def rank_failure(rank: int, n: int, payload: dict, tb: str) -> BaseException:
    """The parent's exception for rank ``rank``'s failure (module
    docstring)."""
    from theanompi_tpu_torch.utils.faults import InjectedCrash, Preempted, TopologyChanged

    msg = f"rank {rank} of {n} failed:\n{tb}"
    kind = payload.get("type")
    if kind == "Preempted":
        e = Preempted(payload["step"])
    elif kind == "TopologyChanged":
        e = TopologyChanged(payload["kind"], payload["step"], payload["new_world"])
    elif kind == "InjectedCrash":
        e = InjectedCrash(msg)
    elif kind == "OSError":
        e = OSError(payload.get("errno"), msg)
    else:
        e = RuntimeError(msg)
    e.rank_traceback = tb
    if payload.get("t_fail") is not None:
        e.t_fail = payload["t_fail"]
    return e


def _rank_main(rank, n, init_method, backend, device, fn, args, results):
    from theanompi_tpu_torch.parallel.distributed import initialize_distributed

    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        initialize_distributed(init_method, n, rank, device=device, backend=backend)
        results.put((rank, True, fn(rank, n, device, *args)))
    except BaseException as e:
        results.put((rank, False, (_exc_payload(e), traceback.format_exc())))
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
                backend: Optional[str] = None, timeout: Optional[float] = None,
                saves_on_fail: bool = False) -> list:
    """Run ``fn(rank, n, device, *args)`` in ``n`` fresh processes (spawn),
    each one rank of a process group, and return their results in rank
    order. ``fn`` must be importable (a module-level function) and return
    something picklable; CPU tensors would be shared through memory that
    dies with the rank, so return numpy arrays or plain values. A rank
    that raises or dies stops the others (after ``FAIL_GRACE`` seconds
    to finish when ``saves_on_fail`` or the rank was preempted, else
    ``REPORT_GRACE``), and its error is raised here (module docstring);
    so is a run longer than ``timeout`` seconds."""
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
    forwarding = threading.current_thread() is threading.main_thread()
    prev_sigterm = None
    if forwarding:
        def forward(signum, frame):
            for p in procs:
                if p.is_alive():
                    os.kill(p.pid, signal.SIGTERM)

        prev_sigterm = signal.signal(signal.SIGTERM, forward)
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
                # the others fail alike (an injected fault fires on every
                # rank) and may be writing their saves: let them end
                failed = {rank: value}
                writing = saves_on_fail or value[0].get("type") == "Preempted"
                end = time.monotonic() + (FAIL_GRACE if writing else REPORT_GRACE)
                while time.monotonic() < end and any(p.is_alive() for p in procs):
                    try:  # a rank exits only once its result left the pipe
                        r, ok, v = results.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if not ok:
                        failed[r] = v
                e = rank_failure(rank, n, *value)
                # every failed rank's kernel launches, for the supervisor's record
                e.rank_launches = {r: p.get("launches") for r, (p, _) in sorted(failed.items())}
                raise e
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        _stop(procs)
        if forwarding:
            signal.signal(signal.SIGTERM, prev_sigterm)
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
                       device=device, backend=backend,
                       saves_on_fail=bool(kwargs.get("ckpt_sharded")))[0]


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
