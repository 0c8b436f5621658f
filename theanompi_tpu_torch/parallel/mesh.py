"""Rank and world helpers of data-parallel BSP (port of the parts of
``theanompi_tpu/parallel/mesh.py`` the one-process-per-card model needs).

The reference runs one SPMD program over a ``("data",)`` mesh; here each
rank is a process on its own card, so a mesh position is the rank.
"""

from __future__ import annotations

import torch

DATA_AXIS = "data"


def host_local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """The rows ``[r·B/n, (r+1)·B/n)`` of the global batch that rank
    ``r`` of ``n`` reads — the reference's shard of the ``data`` axis."""
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} does not split evenly over {world} ranks"
        )
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The rank's own random stream (dropout masks), seeded from
    ``(seed, rank)`` — the counterpart of the reference's
    ``fold_linear_index``, which folds the device's mesh index into the
    key. Its bits cannot match ``jax.random``'s."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)
