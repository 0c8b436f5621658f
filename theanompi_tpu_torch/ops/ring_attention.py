"""Sequence-parallel attention over a mesh axis: ring attention (K/V
rotation) and Ulysses (head <-> sequence all-to-all), and the plain
single-device oracle.

Port of ``theanompi_tpu/ops/ring_attention.py``. The sequence is sharded
over the ranks of a mesh axis (``parallel/mesh.py``: a process group,
one rank a card). ``ring_attention`` keeps each rank's Q block and moves
the K/V blocks around the ring, one stacked ``ppermute`` a hop (the
local block first, then exactly n - 1 hops), folding each block into an
fp32 online softmax; ``ulysses_attention`` scatters heads and gathers the
sequence with one all-to-all, attends locally over the whole sequence
(the plain oracle, or ``local_fn``, e.g. the flash kernels), and
transposes back. Both work on the heads the rank holds (``H / tp`` under
tensor parallelism). Both are exact: the same softmax as one device's, to
fp32 rounding. Both are differentiable through ``mesh.ppermute`` and
``mesh.all_to_all``, whose backward runs the transposed collective.
``ops/flash_attention.py::ring_flash_attention`` is the ring whose hops
are the flash kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from theanompi_tpu_torch.parallel.mesh import all_to_all, axis_group, axis_index, ppermute

# masked-logit sentinel (finite: keeps exp/max NaN-free), as the reference
NEG = -1e30


def ring_attention(q, k, v, axis_name, causal: bool = False, scale: Optional[float] = None,
                   precision=None) -> torch.Tensor:
    """Exact blockwise attention with K/V rotating around ``axis_name``:
    ``[B, Tq, H, D]`` local blocks -> the local output block in q's
    dtype. Global positions come from the axis index (``rank · Tq`` for
    the queries, ``src · Tk`` for the block from rank ``src``), so
    ``causal=True`` masks in the GLOBAL order. Scores and the online
    softmax run in fp32; a block every key of which a row may not see
    gets its p zeroed explicitly (its running max may still be the
    sentinel). ``precision`` is accepted for the reference's signature:
    the products run in fp32 here either way."""
    del precision
    _, n = axis_group(axis_name)
    rank = axis_index(axis_name)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    q_pos = rank * Tq + torch.arange(Tq, device=dev)
    o = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)

    def attend(o, m, l, kt, vt, src):
        # q cast at each hop, as the reference's: a bf16 q's gradient is
        # rounded to bf16 a hop and summed over the hops in bf16
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kt.float()) * sc
        if causal:
            k_pos = src * Tk + torch.arange(Tk, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vt.float())
        return o, m_new, l

    # the local block first (no rotation), then exactly n - 1 hops; K and
    # V travel as ONE stacked ppermute a hop
    o, m, l = attend(o, m, l, k, v, rank)
    kv = torch.stack([k, v])
    for t in range(1, n):
        kv = ppermute(kv, axis_name, 1)
        o, m, l = attend(o, m, l, kv[0], kv[1], (rank - t) % n)
    # causal leaves every query at least its own key, so l > 0
    out = o / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def validate_ulysses_heads(heads: int, n: int, axis_name) -> None:
    """The Ulysses all-to-all scatters the heads over the axis: the
    reference's message when they do not divide
    (``models/transformer.py::validate_ulysses_heads``). ``heads`` is the
    rank's own count: ``H / tp`` under tensor parallelism, whose ranks
    each hold ``H / tp`` heads before the all-to-all."""
    if heads % n:
        raise ValueError(f"ulysses attention needs local heads ({heads}) divisible by the "
                         f"{axis_name!r} axis size {n}")


def ulysses_attention(q, k, v, axis_name, causal: bool = False, scale: Optional[float] = None,
                      precision=None, local_fn=None) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): the first
    all-to-all scatters heads and gathers the sequence (``[B, T/n, H, D]
    -> [B, T, H/n, D]``, blocks in rank order), attention runs locally
    over the whole sequence with no cross-rank mask bookkeeping
    (``local_fn``, e.g. ``ops.flash_attention.flash_attention``, or the
    plain oracle), and the second all-to-all restores ``[B, T/n, H, D]``.
    Needs ``H % n == 0``."""
    _, n = axis_group(axis_name)
    validate_ulysses_heads(q.shape[2], n, axis_name)
    qg = all_to_all(q, axis_name, split_dim=2, concat_dim=1)
    kg = all_to_all(k, axis_name, split_dim=2, concat_dim=1)
    vg = all_to_all(v, axis_name, split_dim=2, concat_dim=1)
    fn = local_fn if local_fn is not None else full_attention_reference
    out = fn(qg, kg, vg, causal=causal, scale=scale, precision=precision)
    return all_to_all(out, axis_name, split_dim=1, concat_dim=2)


def full_attention_reference(q, k, v, causal: bool = False, scale: Optional[float] = None,
                             precision=None) -> torch.Tensor:
    """``[B, Tq, H, D], [B, Tk, H, D] x2 -> [B, Tq, H, D]`` in q's dtype.

    Scores and the softmax in fp32; the causal mask is ``row >= col``
    aligned at the start, valid for Tq != Tk. ``precision`` is accepted
    for the reference's signature: the products run in fp32 here either
    way (the port keeps TF32 off, ``device.py``)."""
    del precision
    B, T, H, D = q.shape
    Tk = k.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    if causal:
        mask = torch.arange(T, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)[None]
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)
