"""Gradient-exchange strategies of BSP (port of the flat strategies of
``theanompi_tpu/parallel/strategies.py``).

A strategy maps this rank's gradient tree to the MEAN gradient over all
ranks of the default process group (``torch.distributed``: NCCL between
cards, gloo on the CPU). As in the reference (and Theano-MPI's
``BSP_Exchanger``), the leaves are packed into one contiguous fp32
buffer first, in the reference's flat order (``_packed``), so the ring's
segments and the int8 scales fall where the reference puts them. Each
leaf is taken in the reference's layout by its layout tag: the model's
``param_layouts``, which every strategy takes as ``layouts``.

- ``psum``: one fp32 ``all_reduce`` of the buffer (≙ ``nccl32``).
- ``psum_bf16``: the buffer in bf16, reduced in bf16 (≙ ``nccl16``).
- ``ring`` / ``ring_bf16`` / ``ring_int8``: the explicit segmented ring
  (≙ ``asa32`` / ``asa16``, and its int8 escalation): reduce-scatter then
  allgather, each hop one ``batch_isend_irecv`` to rank+1 and from
  rank−1; the hop's segment travels as fp32, bf16 or one packed int8
  message (``ops/quant.py``). Accumulation is fp32.
- ``psum`` with ``--wire-codec``: ``codec_psum_mean``, the stateful
  compressed allreduce (each leaf quantized, error feedback through
  ``TrainState.ef``); the ring with a codec takes its wire from it.

The mean multiplies the sum by ``fl(1/n)``: the reference divides by the
constant n, which XLA compiles into that multiply (exact for n a power
of two, one rounding otherwise) — so the ring is bit-identical to the
reference's at any n.

Not yet ported: ``hier``, ``BucketedOverlapSync``, checked mode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch.nn.layers import from_reference_layout, to_reference_layout
from theanompi_tpu_torch.ops.quant import LANES, wire_decode, wire_decode_add, wire_encode
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any
Strategy = Callable[[Tree], Tree]
# ``grads -> tree of layout tags`` (``Model.param_layouts``)
Layouts = Callable[[Tree], Tree]


def _inv(n: int) -> float:
    """fl(1/n) in f32, exactly representable as a Python float."""
    return float(np.float32(1.0 / n))


def _packed(fn: Callable[[torch.Tensor], torch.Tensor], layouts: Layouts) -> Strategy:
    """Wrap a flat-buffer collective into a tree strategy: pack every
    leaf into one fp32 vector (the reference's ``ravel_pytree`` order:
    sorted keys, each leaf in its reference layout), run ``fn``, unpack
    into leaves of each input leaf's dtype and layout."""

    def strategy(grads: Tree) -> Tree:
        leaves, tags = tree_leaves(grads), tree_leaves(layouts(grads))
        refs = [to_reference_layout(g, tag) for g, tag in zip(leaves, tags)]
        flat = torch.cat([r.reshape(-1).float() for r in refs])
        out = fn(flat)
        pieces, off = [], 0
        for g, r, tag in zip(leaves, refs, tags):
            piece = out[off:off + g.numel()].view(r.shape).to(g.dtype)
            pieces.append(from_reference_layout(piece, tag))
            off += g.numel()
        it = iter(pieces)
        return tree_map(lambda _: next(it), grads)

    return strategy


def _all_reduce_mean(flat: torch.Tensor, n: int) -> torch.Tensor:
    if n > 1:
        dist.all_reduce(flat)
    return flat * _inv(n)


def mean_across_ranks(tensors: list, n: int) -> list:
    """The mean over the ``n`` ranks of a list of tensors (metrics, BN
    statistics), in one fp32 ``all_reduce``; each result in its input's
    shape and dtype."""
    if not tensors:
        return []
    flat = _all_reduce_mean(torch.cat([t.detach().reshape(-1).float() for t in tensors]), n)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


# --------------------------------------------------------------------------
# psum family (≙ Exch_nccl32 / Exch_nccl16)
# --------------------------------------------------------------------------


def psum_mean(n: int, layouts: Layouts) -> Strategy:
    return _packed(lambda flat: _all_reduce_mean(flat, n), layouts)


def psum_bf16(n: int, layouts: Layouts) -> Strategy:
    """bf16 operands reduced in bf16, as the reference's bf16 ``pmean``:
    half the wire of ``psum``, with bf16 accumulation (``ring_bf16`` is
    the bf16-wire / fp32-accumulate variant)."""

    def fn(flat):
        wire = flat.to(torch.bfloat16)
        if n > 1:
            dist.all_reduce(wire)
        return (wire * _inv(n)).float()

    return _packed(fn, layouts)


# --------------------------------------------------------------------------
# explicit segmented ring (≙ Exch_asa32 / Exch_asa16)
# --------------------------------------------------------------------------


def _hop(send: torch.Tensor, n: int) -> torch.Tensor:
    """Send ``send`` to rank+1 and receive the same-shaped tensor from
    rank−1, in one batched point-to-point exchange."""
    rank = dist.get_rank()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), (rank + 1) % n),
           dist.P2POp(dist.irecv, recv, (rank - 1) % n)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _ring_allreduce_flat(flat: torch.Tensor, n: int, wire: Optional[str] = None) -> torch.Tensor:
    """Segmented ring allreduce of a flat fp32 buffer -> the SUM:
    reduce-scatter (n−1 hops), then allgather (n−1 hops). ``wire``
    compresses each hop's segment: ``"bf16"`` casts, ``"int8"`` sends one
    packed int8 message (``wire_encode``), decoded and accumulated in
    fp32."""
    if wire not in (None, "bf16", "int8"):
        raise ValueError(f"unknown wire compression {wire!r} (None|bf16|int8)")
    if n == 1:
        return flat
    L = flat.numel()
    seg = -(-L // n)
    if wire == "int8":
        # the quantizer's lane layout needs 128-multiple segments
        seg = -(-seg // LANES) * LANES
    buf = flat.new_zeros(n * seg)
    buf[:L] = flat
    buf = buf.view(n, seg)
    rank = dist.get_rank()

    def send(chunk):
        if wire == "bf16":
            return _hop(chunk.to(torch.bfloat16), n).float()
        return _hop(chunk, n)

    for t in range(n - 1):
        chunk, acc = buf[(rank - t) % n], buf[(rank - t - 1) % n]
        if wire == "int8":
            # decode and add in one rounding, as the reference's compiled
            # ring does (XLA contracts the two into an fma)
            wire_decode_add(_hop(wire_encode(chunk), n), acc)
        else:
            acc += send(chunk)
    # rank r now owns the fully reduced segment (r + 1) mod n
    own = (rank + 1) % n

    if wire == "int8":
        # Allgather with PACKED forwarding: the owner quantizes its reduced
        # segment once; the int8 bytes then travel every hop unchanged and
        # every rank (the owner too) decodes the same message. Quantizing
        # again at each hop is not idempotent in the scale and would leave
        # the replicas different.
        packed = wire_encode(buf[own])
        buf[own] = wire_decode(packed)
        for t in range(n - 1):
            packed = _hop(packed, n)
            buf[(rank - t) % n] = wire_decode(packed)
        return buf.view(-1)[:L]

    if wire == "bf16":
        # the owner keeps what the receivers get (the bf16 cast is exact
        # on the way on), so the replicas agree
        buf[own] = buf[own].to(torch.bfloat16).float()
    for t in range(n - 1):
        buf[(rank - t) % n] = send(buf[(rank + 1 - t) % n])
    return buf.view(-1)[:L]


def _ring(n: int, wire: Optional[str], layouts: Layouts) -> Strategy:
    return _packed(lambda flat: _ring_allreduce_flat(flat, n, wire) * _inv(n), layouts)


def ring(n: int, layouts: Layouts) -> Strategy:
    return _ring(n, None, layouts)


def ring_bf16(n: int, layouts: Layouts) -> Strategy:
    return _ring(n, "bf16", layouts)


def ring_int8(n: int, layouts: Layouts) -> Strategy:
    """int8-wire ring: each hop's segment block-quantized (one packed
    message: 1.03 B/elem against 4), dequantized and accumulated in fp32."""
    return _ring(n, "int8", layouts)


# --------------------------------------------------------------------------
# codec-compressed psum: each leaf quantized (error feedback threaded
# through TrainState.ef), mean in fp32
# --------------------------------------------------------------------------


def codec_psum_mean(n: int, codec, layouts: Layouts) -> Strategy:
    """Compressed allreduce ``(grads, ef) -> (mean grads, ef')``; marked
    ``stateful`` so ``train.make_train_step`` threads ``state.ef``."""
    mean = psum_mean(n, layouts)

    def strategy(grads, ef):
        wire, ef = codec.compress(grads, ef, layouts(grads))
        return mean(wire), ef

    strategy.stateful = True
    return strategy


# --------------------------------------------------------------------------
# registry — Theano-MPI's config names kept as aliases
# --------------------------------------------------------------------------

_CANONICAL = {
    "psum": psum_mean,
    "psum_bf16": psum_bf16,
    "ring": ring,
    "ring_bf16": ring_bf16,
    "ring_int8": ring_int8,
}

_ALIASES = {
    "ar": "psum",
    "cudaaware": "psum",
    "copper": "psum",
    "nccl32": "psum",
    "nccl16": "psum_bf16",
    "asa32": "ring",
    "asa16": "ring_bf16",
}

_ALREADY_COMPRESSED = ("psum_bf16", "ring_bf16", "ring_int8")

# strategies of the reference that the port has not brought over yet
_NOT_PORTED = ("hier",)


def _resolve_codec(name: str, codec):
    """Validate a (strategy, codec) pair -> WireCodec. Strategies that
    compress their own wire refuse a second codec; the explicit ring
    takes its wire from the codec but has no per-leaf residual (each hop
    quantizes partial sums per segment), so ``:ef`` needs ``psum``."""
    from theanompi_tpu_torch.parallel.codec import get_codec

    codec = get_codec(codec)
    key = _ALIASES.get(name, name)
    if not codec.active:
        return codec
    if key in _ALREADY_COMPRESSED:
        raise ValueError(
            f"strategy {name!r} already compresses its wire; composing it "
            f"with --wire-codec {codec.spec!r} would quantize twice — use "
            "strategy 'psum' (or 'ring') with the codec, or the strategy alone"
        )
    if key == "ring" and codec.error_feedback:
        raise ValueError(
            "error feedback needs a per-leaf residual, but the explicit "
            "ring quantizes per segment per hop (no stable leaf mapping) "
            f"— use --wire-codec {codec.name!r} on the ring, or "
            f"{codec.spec!r} with strategy 'psum'"
        )
    return codec


def get_strategy(name: str, n: int, codec=None, *, layouts: Layouts) -> Strategy:
    """The exchange over ``n`` ranks (the default process group's world).
    ``codec``: a wire codec spec or instance (``parallel/codec.py``). With
    ``psum`` it gives the stateful compressed strategy; with ``ring`` it
    selects the ring's wire; strategies that already compress refuse it.
    ``layouts``: ``grads -> layout tags`` (``Model.param_layouts``)."""
    key = _ALIASES.get(name, name)
    if key in _NOT_PORTED:
        raise ValueError(
            f"strategy {name!r} is not ported yet (ROADMAP.md); available: "
            f"{sorted(_CANONICAL) + sorted(_ALIASES)}"
        )
    codec = _resolve_codec(name, codec)
    if codec.active:
        if key == "psum":
            return codec_psum_mean(n, codec, layouts)
        if key == "ring":  # every other pairing raised in _resolve_codec
            return _ring(n, codec.name, layouts)
    try:
        return _CANONICAL[key](n, layouts)
    except KeyError:
        raise ValueError(
            f"unknown exchange strategy {name!r}; available: "
            f"{sorted(_CANONICAL) + sorted(_ALIASES)}"
        ) from None
