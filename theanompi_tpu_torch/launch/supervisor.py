"""Bounded retry with verified auto-resume (port of
``theanompi_tpu/launch/supervisor.py``).

:func:`supervise_training` runs attempts of the training loop, each one
``launch_training`` call (in this process for one rank, one spawned
process a rank for several), with the reference's recovery contract:

- **Bounded retry with backoff**: an attempt that dies with an ordinary
  exception is retried up to ``max_retries`` times, after
  ``backoff_base * 2**(failures-1)`` seconds (capped at
  ``backoff_max``), or, with ``retry_jitter``, seeded decorrelated
  jitter (``sleep_k = uniform(base, 3 * sleep_{k-1})``, capped, seeded
  from the run's ``seed`` and the host); the value slept is in the retry
  record's ``backoff_s``.
- **Cause**: every retry record carries ``cause``
  (:func:`classify_retry_cause`: ``crash`` / ``preempt`` / ``topology``
  / ``storage`` / ``anomaly``).
- **Scrub, then a verified walk-back, before each retry**: one
  synchronous ``scrub_checkpoint_dir`` pass moves corrupt members into
  ``<ckpt_dir>/quarantine/``; the retry resumes from the newest
  checkpoint that passes ``latest_checkpoint(verify=True)``, and its
  record names that step.
- **Preemption**: an attempt that exits through the SIGTERM grace path
  (``Preempted``) checkpointed and left ``resumable.json``; the
  supervisor records it and raises it on (the kill is coming). The next
  invocation sees the marker and resumes without being told to.
- **Elastic world** (``elastic=True``): before every attempt the world
  is probed again (:func:`_probe_world`) and the attempt resumes
  resharded onto it (``utils/checkpoint.load_resharded``).
- **Faults once a supervised run**: rank processes are new in every
  attempt, so every attempt's injector arms from one fault ledger (the
  caller's ``fault_ledger``, else a temporary one the supervisor makes
  and removes): a fault fires once a supervised run, not once an
  attempt.

Records: one ``kind=retry`` line per failed or preempted attempt and one
``kind=topology`` line per elastic attempt in ``<obs_dir>/supervisor.jsonl``;
a ``kind=scrub`` line per retry-time scrub that moved anything and a
final ``kind=metrics`` snapshot (``tmpi_retries_total``,
``tmpi_preempt_resumes_total``, per cause) in ``<obs_dir>/metrics.jsonl``,
in the reference's schema. ``obs_dir`` carries only these records until
the observability slice.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import socket
import tempfile
import time
import zlib
from typing import Any, Optional

import torch

from theanompi_tpu_torch.ops.kernels import launch_counts
from theanompi_tpu_torch.utils.checkpoint import (
    checkpoint_step,
    clear_resumable_marker,
    latest_checkpoint,
    read_resumable_marker,
    scrub_checkpoint_dir,
)
from theanompi_tpu_torch.utils.faults import FaultInjector, Preempted, TopologyChanged

# the closed vocabulary of retry causes (the reference's)
RETRY_CAUSES = ("crash", "preempt", "topology", "storage", "anomaly")


def classify_retry_cause(e: BaseException) -> str:
    """The layer an attempt-killing exception came from: ``preempt``
    (:class:`Preempted`), ``topology`` (:class:`TopologyChanged`),
    ``storage`` (any :class:`OSError`), ``anomaly`` (a numerics stop: the
    port has none until its observability slice), else ``crash``."""
    if isinstance(e, Preempted):
        return "preempt"
    if isinstance(e, TopologyChanged):
        return "topology"
    if isinstance(e, OSError):
        return "storage"
    if type(e).__name__ in ("NumericsAnomaly", "RollbackRequested"):
        return "anomaly"
    return "crash"


class _SupervisorLog:
    """The retry / topology records and the final metrics snapshot,
    appended under ``obs_dir`` (nothing when it is None)."""

    def __init__(self, obs_dir: Optional[str], rank: int = 0):
        self.obs_dir = obs_dir
        self.rank = int(rank)
        if obs_dir:
            os.makedirs(obs_dir, exist_ok=True)

    def _append(self, filename: str, rec: dict) -> None:
        if not self.obs_dir:
            return
        with open(os.path.join(self.obs_dir, filename), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def retry(self, attempt: int, step: int, error: BaseException, backoff_s: float,
              resumable: bool = False, world: Optional[int] = None) -> None:
        rec = {"kind": "retry", "rank": self.rank, "t": time.time(), "attempt": int(attempt),
               "step": int(step), "error": repr(error), "backoff_s": float(backoff_s),
               "resumable": bool(resumable), "cause": classify_retry_cause(error)}
        if world is not None:
            rec["world"] = int(world)
        self._append("supervisor.jsonl", rec)

    def scrub(self, result: dict) -> None:
        self._append("metrics.jsonl", {
            "kind": "scrub", "rank": self.rank, "t": time.time(),
            "checked": int(result["checked"]), "corrupt": int(result["corrupt"]),
            "quarantined": ",".join(result["quarantined"]), "seconds": float(result["seconds"])})

    def topology(self, attempt: int, world: int, prev_world: Optional[int] = None) -> None:
        rec = {"kind": "topology", "rank": self.rank, "t": time.time(),
               "attempt": int(attempt), "world": int(world)}
        if prev_world is not None:
            rec["prev_world"] = int(prev_world)
        self._append("supervisor.jsonl", rec)

    def snapshot(self, retries: int, preempts: int, step: Optional[int] = None,
                 causes: Optional[dict] = None) -> None:
        metrics = {"tmpi_retries_total": float(retries),
                   "tmpi_preempt_resumes_total": float(preempts)}
        for cause, n in sorted((causes or {}).items()):
            metrics[f'tmpi_retries_total{{cause="{cause}"}}'] = float(n)
        rec = {"kind": "metrics", "t": time.time(), "source": "supervisor", "metrics": metrics}
        if step is not None:
            rec["step"] = int(step)
        self._append("metrics.jsonl", rec)


def _probe_world(requested: Optional[int], injector=None, device=None,
                 override: Optional[int] = None) -> int:
    """The world the next elastic attempt runs in: the cards there are
    (``torch.cuda.device_count()``, ranks on cards 0..n-1 in order) or,
    when the caller named a device (``"cpu"``, ``"cuda:k"``: every rank
    on it), the request; a fired shrink / grow / slice_down's world
    (``override``, else ``injector.world_override()``) in its place;
    capped by the request."""
    n_live = int(torch.cuda.device_count()) if device is None else int(requested or 1)
    if override is None and injector is not None:
        override = injector.world_override()
    live = override if override is not None else n_live
    want = min(int(live), int(requested)) if requested else int(live)
    return max(1, min(n_live, want))


def _jitter_rng(seed: int) -> random.Random:
    """The decorrelated jitter's generator: the run's seed with the host
    and controller mixed in (supervisors of one fleet share the seed, so
    the seed alone would make them sleep alike); the same on one host."""
    salt = zlib.crc32(socket.gethostname().encode()) ^ int(
        os.environ.get("TMPI_PROCESS_ID", 0) or 0)
    return random.Random((int(seed or 0) << 20) ^ salt)


def supervise_training(rule: str, devices: int, modelfile: str, modelclass: str, *,
                       max_retries: int = 2, backoff_base: float = 1.0,
                       backoff_max: float = 60.0, retry_jitter: bool = False,
                       ckpt_dir: Optional[str] = None, obs_dir: Optional[str] = None,
                       resume: bool = False, elastic: bool = False,
                       **run_kwargs: Any) -> dict:
    """Run ``launch_training(rule, devices, modelfile, modelclass,
    **run_kwargs)`` under the supervisor (module docstring).

    ``ckpt_dir`` is required when ``max_retries > 0``: a retry without a
    checkpoint would restart from scratch, which no recovery path should
    do quietly. ``elastic``: probe the world before every attempt
    (``devices`` is the cap) and resume resharded. Returns the successful
    attempt's summary with ``retries``, ``preempt_resumes``, ``attempts``
    and ``retry_causes``."""
    from theanompi_tpu_torch.launch.session import launch_training

    if max_retries and not ckpt_dir:
        raise ValueError("supervise_training with max_retries > 0 requires ckpt_dir — a "
                         "retry can only auto-resume from a checkpoint")
    specs = run_kwargs.get("inject_faults")
    own_ledger = None
    if specs and not run_kwargs.get("fault_ledger"):
        own_ledger = tempfile.mkdtemp(prefix="tmpi-faults-")
        run_kwargs["fault_ledger"] = os.path.join(own_ledger, "fault_ledger")
    log = _SupervisorLog(obs_dir)
    retries = preempts = attempt = 0
    causes: dict = {}
    world: Optional[int] = None
    override: Optional[int] = None
    jitter = _jitter_rng(run_kwargs.get("seed", 0))
    prev_sleep = float(backoff_base)
    last_failure = None  # when the last attempt failed and what its retry waited
    attempt_log: list = []  # each failed attempt: its world, error and launches
    if ckpt_dir and read_resumable_marker(ckpt_dir) is not None:
        preempts += 1
        resume = True
        print(f"[supervisor] resumable marker found in {ckpt_dir!r}; auto-resuming", flush=True)
    try:
        while True:
            attempt += 1
            if elastic:
                injector = (FaultInjector(specs, ledger=run_kwargs.get("fault_ledger"))
                            if specs else None)
                new_world = _probe_world(devices, injector, run_kwargs.get("device"), override)
                log.topology(attempt, new_world, prev_world=world)
                if world is not None and new_world != world:
                    print(f"[supervisor] elastic: world {world} -> {new_world} rank(s) for "
                          f"attempt {attempt}", flush=True)
                world = new_world
            else:
                world = devices
            if ckpt_dir:
                clear_resumable_marker(ckpt_dir)  # this attempt writes it again if preempted
            counts0 = launch_counts()
            try:
                summary = launch_training(rule, world, modelfile, modelclass, ckpt_dir=ckpt_dir,
                                          resume=resume, elastic=elastic, **run_kwargs)
                break
            except Preempted as e:
                # checkpointed and marked by the loop: the kill is coming,
                # so record the attempt and let the exit happen
                log.retry(attempt, e.step, e, 0.0, resumable=True, world=world)
                log.snapshot(retries, preempts, step=e.step, causes=causes)
                raise
            except Exception as e:  # noqa: BLE001 — the retry boundary
                launches = getattr(e, "rank_launches", None)
                if launches is None:  # an attempt in this process: its own launches
                    now = launch_counts()
                    launches = {0: {k: now[k] - counts0.get(k, 0) for k in now}}
                attempt_log.append({"attempt": attempt, "world": world,
                                    "error": type(e).__name__,
                                    "launches_per_rank": [launches[r] for r in sorted(launches)]})
                retries += 1
                cause = classify_retry_cause(e)
                causes[cause] = causes.get(cause, 0) + 1
                if isinstance(e, TopologyChanged):
                    override = e.new_world
                t_caught = time.time()
                if ckpt_dir:
                    scrub = scrub_checkpoint_dir(ckpt_dir)
                    if scrub["corrupt"]:
                        log.scrub(scrub)
                        print(f"[supervisor] scrub quarantined {scrub['corrupt']} corrupt "
                              f"checkpoint member(s): {scrub['quarantined']}", flush=True)
                # the step the next attempt resumes from, as its resume
                # will find it (past a corrupt newest file)
                t_walk = time.time()
                path = latest_checkpoint(ckpt_dir, verify=True) if ckpt_dir else None
                step = checkpoint_step(path)
                if retries > max_retries:
                    log.retry(attempt, step, e, 0.0, world=world)
                    log.snapshot(retries, preempts, causes=causes)
                    raise
                if retry_jitter:
                    backoff = min(float(backoff_max), jitter.uniform(
                        float(backoff_base), max(float(backoff_base), 3.0 * prev_sleep)))
                    prev_sleep = backoff
                else:
                    backoff = min(float(backoff_max), float(backoff_base) * 2 ** (retries - 1))
                log.retry(attempt, step, e, backoff, world=world)
                print(f"[supervisor] attempt {attempt} failed ({type(e).__name__}: "
                      f"{str(e).splitlines()[0] if str(e) else ''}); retry {retries}/"
                      f"{max_retries} resumes from "
                      f"{'step ' + str(step) if step >= 0 else 'scratch (no verified checkpoint)'}"
                      f" after {backoff:.2f}s backoff", flush=True)
                last_failure = {"t_fail": getattr(e, "t_fail", t_caught), "t_caught": t_caught,
                                "t_walk": t_walk, "t_retry": time.time(), "backoff": backoff}
                if backoff > 0:
                    time.sleep(backoff)
                resume = True
    finally:
        if own_ledger is not None:
            shutil.rmtree(own_ledger, ignore_errors=True)
    if ckpt_dir:
        clear_resumable_marker(ckpt_dir)
    summary["retries"] = retries
    summary["preempt_resumes"] = preempts
    summary["attempts"] = attempt
    summary["retry_causes"] = dict(causes)
    summary["world"] = world
    summary["failed_attempts"] = attempt_log
    if last_failure is not None and summary.get("first_step_t") is not None:
        # from the failure to the retry's first step, the backoff left
        # out, and where that time went
        f = last_failure
        summary["recovery_ms"] = (summary["first_step_t"] - f["t_fail"] - f["backoff"]) * 1e3
        summary["recovery"] = {
            "unwind_ms": (f["t_caught"] - f["t_fail"]) * 1e3,  # crash saves, teardown
            "scrub_ms": (f["t_walk"] - f["t_caught"]) * 1e3,
            "walk_ms": (f["t_retry"] - f["t_walk"]) * 1e3,
            # processes, model, data (the backoff left out)
            "start_ms": (summary["run_start_t"] - f["t_retry"] - f["backoff"]) * 1e3,
            "to_first_step_ms": (summary["first_step_t"] - summary["run_start_t"]) * 1e3}
    log.snapshot(retries, preempts, step=summary.get("steps"), causes=causes)
    return summary
