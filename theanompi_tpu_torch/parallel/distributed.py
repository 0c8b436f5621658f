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
:func:`gather_tree` brings the ranks' residual or worker trees to rank 0,
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


def gather_tree(tree, n: int, ranks=None):
    """The copies of ``tree`` (tensors of any dtypes, the same structure,
    shapes and dtypes on every rank) held by ``ranks`` (default: every
    rank) -> the list of those trees in the order of ``ranks`` on rank 0,
    None on the others. Collective over the world: a rank outside
    ``ranks`` only returns. With several ranks the trees rank 0 gets are
    new tensors in host memory (pinned when the tree lies on the card),
    not views of live state.

    Each rank's leaves travel as their bytes packed in one buffer, each
    in logical (contiguous) order, and rank 0 receives one rank's buffer
    at a time and copies it to the host, so its card never holds more
    than one other rank's tree: the checkpoint of many workers, each
    with its own state, fits beside the model. Under gloo the buffers
    travel from host memory (gloo's point-to-point ops of CUDA tensors
    abort the rank, ``strategies._hop``)."""
    if n == 1:
        return [tree]
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    leaves = [t.detach().contiguous() for t in tree_leaves(tree)]
    # each leaf's bytes start 8-byte aligned, so every piece views as its dtype
    size = [-(-t.numel() * t.element_size() // 8) * 8 for t in leaves]
    packed = leaves[0].new_zeros(sum(size), dtype=torch.uint8)
    off = 0
    for t, nb in zip(leaves, size):
        packed[off:off + t.numel() * t.element_size()] = t.reshape(-1).view(torch.uint8)
        off += nb
    on_card = packed.is_cuda
    if dist.get_backend() == "gloo":
        packed = packed.cpu()
    me = dist.get_rank()
    if me != 0:
        if me in ranks:
            dist.send(packed, 0)
        return None
    buf = torch.empty_like(packed)
    trees = []
    for r in ranks:
        if r != 0:
            dist.recv(buf, r)
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=on_card)
        host.copy_(packed if r == 0 else buf)
        parts, off = [], 0
        for t, nb in zip(leaves, size):
            parts.append(host[off:off + t.numel() * t.element_size()].view(t.dtype).view(t.shape))
            off += nb
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
