"""Host CPU binding of the input pipeline (port of
``theanompi_tpu/utils/hostaffinity.py``; reference: ``lib/hwloc_utils.py``).

The reference bound each worker and its loader near its GPU. Here the
one binding made is the loader's: the prefetch thread (and the native
loader threads it starts, which inherit its mask) can be kept off the
cores that launch the card's kernels.

    TMPI_LOADER_CPUS="4-7"     # cpuset of the loader thread (range/list)
    TMPI_LOADER_CPUS="2,3,6"

Unset means no pinning. ``pin_thread`` is a no-op where the platform
has no ``sched_setaffinity``.
"""

from __future__ import annotations

import os
from typing import Optional


def parse_cpuset(spec: str) -> set[int]:
    """``"0-3,8,10-11"`` -> {0,1,2,3,8,10,11} (taskset list syntax)."""
    cpus: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cpus.update(range(int(lo), int(hi) + 1))
        else:
            cpus.add(int(part))
    if not cpus:
        raise ValueError(f"empty cpuset {spec!r}")
    return cpus


def loader_cpuset() -> Optional[set[int]]:
    """``TMPI_LOADER_CPUS`` intersected with this process's affinity mask
    (a cpu outside it is one the kernel would refuse); None when unset or
    when nothing of it is usable."""
    spec = os.environ.get("TMPI_LOADER_CPUS")
    if not spec:
        return None
    want = parse_cpuset(spec)
    try:
        allowed = os.sched_getaffinity(0)
    except AttributeError:
        return None
    return (want & allowed) or None


def pin_thread(cpus: Optional[set[int]] = None) -> bool:
    """Pin the CALLING thread to ``cpus`` (default: the loader cpuset).
    True iff a pin was applied. On Linux, ``sched_setaffinity(0, ...)``
    from a thread pins that thread alone."""
    if cpus is None:
        cpus = loader_cpuset()
    if not cpus:
        return False
    try:
        os.sched_setaffinity(0, cpus)
        return True
    except (AttributeError, OSError):
        return False
