"""Process-group bootstrap (port of ``theanompi_tpu/parallel/distributed.py``).

The reference joins JAX's multi-controller world; the port runs one
process per rank (one per card) and joins a ``torch.distributed``
process group. Nothing on a card's host announces a cluster, so the
rendezvous comes from, in precedence order:

1. explicit arguments to :func:`initialize_distributed`;
2. ``TMPI_COORDINATOR`` (an ``init_method`` URL: ``tcp://host:port`` or
   ``file:///path``; a bare ``host:port`` means tcp), ``TMPI_NUM_PROCESSES``
   and ``TMPI_PROCESS_ID`` — the reference's names.

With none of those set it is a no-op. The backend follows the device:
NCCL for CUDA and gloo for the CPU, unless the caller names one (gloo
also reduces CUDA tensors, which is how two ranks can share one card).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cpu",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group if one is configured; returns True iff a
    group is initialized (now or earlier in this process)."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or env.get("TMPI_COORDINATOR") or None
    if num_processes is None and env.get("TMPI_NUM_PROCESSES"):
        num_processes = int(env["TMPI_NUM_PROCESSES"])
    if process_id is None and env.get("TMPI_PROCESS_ID"):
        process_id = int(env["TMPI_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "joining a process group needs coordinator, num_processes AND "
            f"process_id (got {coordinator=}, {num_processes=}, {process_id=}); "
            "set TMPI_COORDINATOR/TMPI_NUM_PROCESSES/TMPI_PROCESS_ID or pass "
            "them explicitly"
        )
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(
        backend or default_backend(device), init_method=coordinator,
        world_size=num_processes, rank=process_id,
    )
    return True


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def assert_same_across_processes(value: float, name: str, atol: float = 0.0) -> None:
    """Debug guard: a host-side scalar is the same on every rank (e.g. the
    loss after a lockstep BSP step). Collective: every rank calls it."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, float(value))
    if any(abs(v - gathered[0]) > atol for v in gathered):
        raise AssertionError(f"{name} differs across processes: {gathered} (atol={atol})")
