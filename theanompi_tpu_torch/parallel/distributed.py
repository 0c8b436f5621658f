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

The collective part of a checkpoint save and a resume lives here too:
:func:`gather_tree` brings every rank's residual tree to rank 0,
:func:`all_gather_objects` the ranks' generator states, and
:func:`agree_on_step` makes every rank raise together when the ranks
resolved different checkpoints. Every rank calls them, on the training
thread: two threads that issue collectives can deadlock.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from theanompi_tpu_torch.tree import tree_leaves, tree_map


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


def all_gather_objects(obj, n: int) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank
    (``[obj]`` with one rank). Collective."""
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def gather_tree(tree, n: int):
    """Every rank's copy of ``tree`` (tensors of one dtype, the same
    structure and shapes on every rank) -> the list of the ``n`` trees in
    rank order on rank 0, None on the others. Collective. The leaves
    travel packed in one buffer, in logical (contiguous) order; with
    several ranks the trees rank 0 gets are new tensors, not views of
    live state. An all-gather and not a gather: gloo gathers no CUDA
    tensors."""
    if n == 1:
        return [tree]
    leaves = [t.detach() for t in tree_leaves(tree)]
    dtypes = {t.dtype for t in leaves}
    if len(dtypes) > 1:
        raise ValueError(f"gather_tree packs one dtype; the tree holds {sorted(map(str, dtypes))}")
    packed = torch.cat([t.reshape(-1) for t in leaves])
    outs = [torch.empty_like(packed) for _ in range(n)]
    dist.all_gather(outs, packed)
    if dist.get_rank() != 0:
        return None
    trees = []
    for buf in outs:
        parts, off = [], 0
        for t in leaves:
            parts.append(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()
        it = iter(parts)
        trees.append(tree_map(lambda _: next(it), tree))
    return trees


def agree_on_step(step: int, n: int) -> None:
    """Raise on every rank unless every rank resolved the same
    checkpoint ``step`` (-1: none); a rank that resumed alone would wait
    in a collective the others never reach. Collective."""
    steps = all_gather_objects(int(step), n)
    if any(s != steps[0] for s in steps):
        raise RuntimeError(
            f"ranks resolved different checkpoint steps {steps} (this is rank "
            f"{dist.get_rank()}): the checkpoint directory is not storage every rank "
            "sees alike (required for --resume)")
