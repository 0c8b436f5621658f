"""Deterministic fault injection (port of ``theanompi_tpu/utils/faults.py``).

The registry behind ``--inject-fault KIND@STEP`` (repeatable): a
:class:`FaultInjector` armed with :class:`FaultSpec` s fires each of
them once, at a deterministic global step, so the supervisor's retry,
the checkpoint's integrity chain, the scrubber and the SIGTERM grace
path are exercised by tests instead of trusted.

Kinds (``KIND@STEP`` or ``KIND@STEP:ARG``), with the reference's step
semantics:

- ``crash``        raise :class:`InjectedCrash` before dispatching STEP;
- ``sigterm``      ``os.kill(self, SIGTERM)`` before STEP (preemption;
                   with ``--sigterm-grace`` the loop checkpoints, marks
                   the run resumable and raises :class:`Preempted`);
- ``sigkill``      ``os.kill(self, SIGKILL)`` before STEP;
- ``ckpt_truncate`` truncate the newest checkpoint after the first save
                   at or after STEP;
- ``nan_batch``    poison the batch feeding STEP with NaN (float batches);
- ``loader_stall`` sleep ARG seconds (default 2.0) before STEP;
- ``shrink`` / ``grow`` raise :class:`TopologyChanged` before STEP with
                   the world set to ARG ranks;
- ``slice_down``   :class:`TopologyChanged` before STEP with ARG slices
                   (default 1) removed from the topology the run
                   registered (:meth:`FaultInjector.set_topology`);
- ``enospc``       the first save at or after STEP raises
                   ``OSError(ENOSPC)`` mid-write (``utils/checkpoint.py``'s
                   writer shim; on the async writer's thread too);
- ``slow_write``   the first save at or after STEP stalls ARG seconds
                   (default 2.0) inside the writer;
- ``bitrot``       flip bytes in the newest committed checkpoint after
                   the first save at or after STEP;
- ``partial_set``  delete one member of the newest sharded set after the
                   first save at or after STEP.

Once across processes: with ``ledger`` every fired spec is appended to a
file (one ``os.write`` of one line to a file opened ``O_APPEND``, then
``fsync``, all before the fault's side effect), and specs already there
arm as fired. Every rank of a run fires the same spec at the same step
and writes its own line: rank 0 writes the reference's ``kind@step``,
rank ``r`` ``kind@step rank=r``; a spec counts as fired as many times as
the rank that recorded it most often, so a relaunched attempt, of any
world, replays no fault that already happened. The supervisor gives
every attempt one ledger.
"""

from __future__ import annotations

import os
import signal
import time
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch


class InjectedFault(RuntimeError):
    """Base class of the injector's failures."""


class InjectedCrash(InjectedFault):
    """The ``crash`` fault: an ordinary exception of the training loop,
    what the supervisor's bounded retry absorbs."""


class TopologyChanged(InjectedFault):
    """The ``shrink`` / ``grow`` / ``slice_down`` faults: the world
    changed to ``new_world`` ranks before step ``step``. Under
    ``supervise_training(elastic=True)`` the retry probes the world again
    and resumes resharded onto it."""

    def __init__(self, kind: str, step: int, new_world: int):
        self.kind = str(kind)
        self.step = int(step)
        self.new_world = int(new_world)
        super().__init__(f"injected {kind} before step {step}: world is now "
                         f"{new_world} device(s)")

    def __reduce__(self):
        return (type(self), (self.kind, self.step, self.new_world))


class Preempted(RuntimeError):
    """The SIGTERM grace exit: the loop checkpointed and marked the run
    resumable. The supervisor records it and raises it on; the next
    invocation resumes from the marker."""

    def __init__(self, step: int):
        self.step = int(step)
        super().__init__(f"preempted (SIGTERM) at step {step}: checkpointed and marked "
                         "resumable")

    def __reduce__(self):
        return (type(self), (self.step,))


FAULT_KINDS = (
    "crash", "sigterm", "sigkill", "ckpt_truncate", "nan_batch",
    "loader_stall", "shrink", "grow", "slice_down",
    "enospc", "slow_write", "bitrot", "partial_set",
)

# applied to a durable checkpoint after the first save at or after the step
STORAGE_MUTATION_KINDS = ("ckpt_truncate", "bitrot", "partial_set")

# asked by the checkpoint writer shim at each save's step
WRITE_FAULT_KINDS = ("enospc", "slow_write")


@dataclass
class FaultSpec:
    """One armed fault: ``kind`` fires once at global step ``step``;
    ``fired_seq`` is the order it fired in (-1: not fired)."""

    kind: str
    step: int
    arg: Optional[float] = None
    fired: bool = False
    fired_seq: int = -1
    # slice_down's surviving world, resolved when it fires
    resolved_world: Optional[int] = None


def parse_fault_spec(spec: Union[str, FaultSpec]) -> FaultSpec:
    """``KIND@STEP`` / ``KIND@STEP:ARG`` -> :class:`FaultSpec`."""
    if isinstance(spec, FaultSpec):
        return spec
    kind, sep, rest = str(spec).partition("@")
    if not sep:
        raise ValueError(f"fault spec {spec!r} must be KIND@STEP (e.g. crash@5); "
                         f"kinds: {FAULT_KINDS}")
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; kinds: {FAULT_KINDS}")
    step_s, sep2, arg_s = rest.partition(":")
    try:
        step = int(step_s)
    except ValueError:
        raise ValueError(f"fault spec {spec!r}: step {step_s!r} is not an int") from None
    if step < 1:
        raise ValueError(f"fault spec {spec!r}: steps are 1-based")
    arg = None
    if sep2:
        try:
            arg = float(arg_s)
        except ValueError:
            raise ValueError(f"fault spec {spec!r}: arg {arg_s!r} is not a number") from None
    if kind in ("shrink", "grow"):
        if arg is None or int(arg) != arg or arg < 1:
            raise ValueError(f"fault spec {spec!r}: {kind} needs an integer target world "
                             f"size >= 1 (e.g. {kind}@{step}:2)")
    if kind == "slice_down" and arg is not None and (int(arg) != arg or arg < 1):
        raise ValueError(f"fault spec {spec!r}: slice_down's arg is the number of slices "
                         f"lost, an integer >= 1 (e.g. slice_down@{step}:1)")
    return FaultSpec(kind=kind, step=step, arg=arg)


def _ledger_entry(line: str) -> tuple:
    """``(kind@step, rank)`` of a ledger line."""
    entry, _, tag = line.strip().partition(" ")
    rank = int(tag[len("rank="):]) if tag.startswith("rank=") else 0
    return entry, rank


class FaultInjector:
    """Fires each armed :class:`FaultSpec` once at its step (module
    docstring). The loop calls :meth:`check_step` with the 1-based step
    it is about to dispatch (a group passes its range),
    :meth:`poison_batch` on that step's batch,
    :meth:`storage_mutations_due` / :meth:`apply_storage_mutation` after
    a durable save, and installs :meth:`write_fault` as the checkpoint
    writer's hook. ``ledger``: the fired-fault file (module docstring);
    ``rank``: the rank whose lines this injector writes."""

    def __init__(self, specs: Sequence[Union[str, FaultSpec]],
                 ledger: Optional[str] = None, rank: int = 0):
        self.specs = [parse_fault_spec(s) for s in (specs or [])]
        self._fire_seq = 0
        self._topology: Optional[tuple] = None  # (n_slices, per_slice)
        self._ledger = ledger
        self.rank = int(rank)
        if ledger and os.path.exists(ledger):
            with open(ledger) as f:
                lines = [ln for ln in f if ln.strip()]
            per_rank = Counter(_ledger_entry(ln) for ln in lines)
            fires: dict = {}
            for (entry, _), c in per_rank.items():
                fires[entry] = max(fires.get(entry, 0), c)
            for line in lines:  # in the order they fired
                entry, _ = _ledger_entry(line)
                if not fires.get(entry):
                    continue
                for s in self.specs:
                    if not s.fired and f"{s.kind}@{s.step}" == entry:
                        s.fired = True
                        s.fired_seq = self._fire_seq
                        self._fire_seq += 1
                        fires[entry] -= 1
                        break

    def set_topology(self, n_slices: int, per_slice: int) -> None:
        """Register the run's ``(n_slices, per_slice)``, from which
        ``slice_down`` resolves the surviving world."""
        self._topology = (int(n_slices), int(per_slice))

    def _record_fire(self, s: FaultSpec) -> None:
        if not self._ledger:
            return
        line = f"{s.kind}@{s.step}" + (f" rank={self.rank}" if self.rank else "") + "\n"
        fd = os.open(self._ledger, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line.encode())
            os.fsync(fd)
        finally:
            os.close(fd)

    def _fire(self, s: FaultSpec) -> FaultSpec:
        s.fired = True
        s.fired_seq = self._fire_seq
        self._fire_seq += 1
        self._record_fire(s)
        return s

    def _take(self, kind: str, first: int, last: Optional[int] = None) -> Optional[FaultSpec]:
        last = first if last is None else last
        for s in self.specs:
            if s.kind == kind and not s.fired and first <= s.step <= last:
                return self._fire(s)
        return None

    def check_step(self, first: int, last: Optional[int] = None) -> None:
        """Fire the crash / sigterm / sigkill / loader_stall / topology
        faults due before dispatching steps ``[first, last]``."""
        s = self._take("loader_stall", first, last)
        if s is not None:
            time.sleep(2.0 if s.arg is None else float(s.arg))
        s = self._take("crash", first, last)
        if s is not None:
            raise InjectedCrash(f"injected crash before step {s.step}")
        for kind in ("shrink", "grow"):
            s = self._take(kind, first, last)
            if s is not None:
                raise TopologyChanged(kind, s.step, int(s.arg))
        s = self._take("slice_down", first, last)
        if s is not None:
            lost = 1 if s.arg is None else int(s.arg)
            if self._topology is None or self._topology[0] <= 1:
                raise ValueError(
                    f"slice_down@{s.step}: no multislice topology registered — the run must "
                    "have --slices N (N > 1) for whole-slice loss to leave a surviving world")
            n_slices, per_slice = self._topology
            survivors = (n_slices - lost) * per_slice
            if survivors < 1:
                raise ValueError(f"slice_down@{s.step}:{lost}: losing {lost} of {n_slices} "
                                 "slice(s) leaves no survivors")
            s.resolved_world = survivors
            raise TopologyChanged("slice_down", s.step, survivors)
        s = self._take("sigterm", first, last)
        if s is not None:
            os.kill(os.getpid(), signal.SIGTERM)
        s = self._take("sigkill", first, last)
        if s is not None:
            os.kill(os.getpid(), signal.SIGKILL)

    def poison_batch(self, x: torch.Tensor, first: int, last: Optional[int] = None):
        """``nan_batch``: ``x`` plus NaN when a spec is due in ``[first,
        last]`` (on ``x``'s device, no sync), else ``x``. Float batches
        only: a uint8 or token batch cannot carry NaN."""
        s = self._take("nan_batch", first, last)
        if s is None:
            return x
        if not x.is_floating_point():
            raise ValueError(f"nan_batch@{s.step}: batch dtype {x.dtype} cannot carry NaN "
                             "(uint8 or token batches); inject on a float-input dataset")
        return x + float("nan")

    def world_override(self) -> Optional[int]:
        """The world the most recently fired shrink / grow / slice_down
        left (by firing order), or None."""
        fired = [s for s in self.specs if s.kind in ("shrink", "grow", "slice_down") and s.fired]
        if not fired:
            return None
        last = max(fired, key=lambda s: s.fired_seq)
        if last.kind == "slice_down":
            resolved = [s for s in fired if s.kind != "slice_down" or s.resolved_world is not None]
            if not resolved:
                return None
            last = max(resolved, key=lambda s: s.fired_seq)
            if last.kind == "slice_down":
                return int(last.resolved_world)
        return int(last.arg)

    def _take_at_or_after(self, kind: str, step: int) -> Optional[FaultSpec]:
        for s in self.specs:
            if s.kind == kind and not s.fired and step >= s.step:
                return self._fire(s)
        return None

    def storage_mutations_due(self, step: int) -> list:
        """Every ``ckpt_truncate`` / ``bitrot`` / ``partial_set`` due at or
        after ``step``, each fired once; apply them once the save is
        durable (an async save waited first)."""
        out = []
        for kind in STORAGE_MUTATION_KINDS:
            s = self._take_at_or_after(kind, step)
            if s is not None:
                out.append(s)
        return out

    @staticmethod
    def apply_storage_mutation(spec: FaultSpec, ckpt_dir: str) -> Optional[str]:
        """Apply one fired storage mutation; returns the path it mangled
        or removed (None when nothing qualified)."""
        if spec.kind == "ckpt_truncate":
            return FaultInjector.truncate_newest(ckpt_dir)
        if spec.kind == "bitrot":
            return FaultInjector.bitrot_newest(ckpt_dir)
        if spec.kind == "partial_set":
            return FaultInjector.drop_sharded_member(ckpt_dir)
        raise ValueError(f"{spec.kind!r} is not a storage mutation")

    def write_fault(self, step: int) -> Optional[tuple]:
        """The checkpoint writer's hook: ``(kind, arg)`` of a due
        ``enospc`` / ``slow_write`` spec (fired once), else None. Runs on
        the writer thread, one save at a time."""
        for kind in WRITE_FAULT_KINDS:
            s = self._take_at_or_after(kind, step)
            if s is not None:
                return (kind, s.arg)
        return None

    @staticmethod
    def truncate_newest(ckpt_dir: str) -> Optional[str]:
        """Truncate the newest checkpoint file to half its size."""
        from theanompi_tpu_torch.utils.checkpoint import latest_checkpoint

        path = latest_checkpoint(ckpt_dir)
        if path is None:
            return None
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return path

    @staticmethod
    def bitrot_newest(ckpt_dir: str) -> Optional[str]:
        """Flip 8 bytes in the middle of the newest checkpoint file (size
        and name intact: only the CRC32 chain can tell)."""
        from theanompi_tpu_torch.utils.checkpoint import latest_checkpoint

        path = latest_checkpoint(ckpt_dir)
        if path is None:
            return None
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(8)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        return path

    @staticmethod
    def drop_sharded_member(ckpt_dir: str) -> Optional[str]:
        """Delete the highest-rank member of the newest complete sharded
        set, which then reads as absent."""
        from theanompi_tpu_torch.utils.checkpoint import _sharded_sets

        sets = _sharded_sets(ckpt_dir)
        if not sets:
            return None
        victim = sets[max(sets)][-1]
        os.unlink(victim)
        return victim
