"""How far the host runs ahead of the card (port of
``theanompi_tpu/utils/dispatch.py``).

The training loop enqueues each step without waiting for the card and
reads its metrics back later, in drains. :class:`MetricsDispatcher`
decides when: it holds the steps in flight (each step's CUDA event,
recorded after it is enqueued) and the rows not yet read back, and
calls the loop's ``drain(entries, partial)`` to read rows. Step times
stay the loop's CUDA-event intervals; the dispatcher only chooses the
points where the host waits.

- ``depth=None`` (the CLI's default): no bound of its own. Rows are read
  every ``print_freq`` steps (and by :meth:`flush` at epoch ends and
  other boundaries), as the port has always done.
- ``depth=K`` (``--dispatch-depth K``): after each step is enqueued,
  while K steps are in flight the host waits for the oldest's event, so
  no more than K steps are ever in flight; the rows of the steps it
  waited for are read at once (``partial=True``: the loop reads them on
  a side stream, so the read waits for no newer step). This holds in
  groups of steps too (``--steps-per-dispatch``): the group calls
  :meth:`enqueued` after each of its steps.

Why the default is not the reference's (1, a sync every step): the rows
are the same either way, which is the reference's own contract (its
``dispatch.py`` docstring: deeper pipelines emit the same rows, only
later), and on CUDA a sync every step makes the host wait for each step
before it enqueues the next, so every step pays the host's enqueue time
on top of the card's. ``depth=1`` keeps the reference's behaviour for
whoever wants it, and its cost is on record (PERF.md).

``host_blocked_s`` sums the host's waits inside the dispatcher,
``n_syncs`` counts them, and ``max_in_flight`` is the most steps that
were ever in flight at once.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional


def _wait(mark) -> None:
    """Block until the step whose end ``mark`` is has run (a CUDA event;
    a host time on the CPU, where the step has already run)."""
    sync = getattr(mark, "synchronize", None)
    if sync is not None:
        sync()


class MetricsDispatcher:
    """Steps in flight and rows to read (module docstring).

    ``drain(entries, partial)`` reads the rows of ``entries`` (each
    ``entry[0]`` its step) in step order; ``partial`` is True when newer
    steps may still be in flight."""

    def __init__(self, drain: Callable[[list, bool], None], depth: Optional[int] = None,
                 print_freq: int = 0):
        if depth is not None and int(depth) < 1:
            raise ValueError(f"dispatch depth must be >= 1, got {depth}")
        self.drain = drain
        self.depth = None if depth is None else int(depth)
        self.print_freq = int(print_freq or 0)
        self._rows: deque = deque()
        self._marks: deque = deque()  # (step, end mark) of the steps in flight
        self._done_step = 0  # every step up to this one has run
        self.host_blocked_s = 0.0
        self.n_syncs = 0
        self.max_in_flight = 0

    @property
    def in_flight(self) -> int:
        return len(self._marks)

    def enqueued(self, step: int, mark) -> None:
        """Step ``step`` was enqueued and ``mark`` recorded after it; with
        a depth, wait for the oldest steps until fewer than ``depth`` are
        in flight."""
        self._marks.append((int(step), mark))
        self.max_in_flight = max(self.max_in_flight, len(self._marks))
        if self.depth is None:
            return
        while len(self._marks) >= self.depth:
            s, m = self._marks.popleft()
            t0 = time.perf_counter()
            _wait(m)
            self.host_blocked_s += time.perf_counter() - t0
            self.n_syncs += 1
            self._done_step = max(self._done_step, s)

    def push(self, entries: list, first: int, last: int) -> None:
        """The rows of the steps ``first + 1 .. last`` just dispatched."""
        self._rows.extend(entries)
        if self.depth is not None:
            done = []
            while self._rows and self._rows[0][0] <= self._done_step:
                done.append(self._rows.popleft())
            if done:
                self.drain(done, bool(self._rows) or bool(self._marks))
        elif self.print_freq and last // self.print_freq > first // self.print_freq:
            self.flush()

    def flush(self) -> None:
        """Read every row not yet read (a wait for the newest step), at
        epoch ends and before anything that must see them all."""
        rows = list(self._rows)
        self._rows.clear()
        if rows:
            t0 = time.perf_counter()
            self.drain(rows, False)
            self.host_blocked_s += time.perf_counter() - t0
            self.n_syncs += 1
        self.synced()

    def synced(self) -> None:
        """The caller waited for the card: nothing is in flight."""
        if self._marks:
            self._done_step = max(self._done_step, self._marks[-1][0])
        self._marks.clear()

    def summary(self) -> dict:
        return {"dispatch_depth": self.depth, "host_blocked_s": self.host_blocked_s,
                "dispatch_syncs": self.n_syncs, "max_in_flight": self.max_in_flight}
