"""Gradient-exchange strategies of BSP (port of
``theanompi_tpu/parallel/strategies.py``).

A strategy maps this rank's gradient tree to the MEAN gradient over all
ranks of the default process group (``torch.distributed``: NCCL between
cards, gloo on the CPU). As in the reference (and Theano-MPI's
``BSP_Exchanger``), the leaves are packed into one contiguous fp32
buffer first, in the reference's flat order (``_packed``), so the ring's
segments, hier's shards and the int8 scales fall where the reference
puts them. Each leaf is taken in the reference's layout by its layout
tag: the model's ``param_layouts``, which every strategy takes as
``layouts``.

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
- ``hier`` (``--slices r``): the two-hop exchange over the mesh axes of
  ``parallel/mesh.py``: reduce-scatter inside the slice, an
  ``all_reduce`` of the shard across slices (the only hop a codec
  compresses; ``:ef`` keeps one residual row of the shard a rank), then
  an all-gather inside the slice (``hierarchical_sync``).
- ``--allreduce-buckets MB`` (``bucketed``): the psum or hier exchange
  cut into buckets of about MB fp32 bytes in reverse leaf order
  (``assign_buckets``); each bucket's exchange is posted inside the
  backward as soon as its last gradient is made
  (``BucketedOverlapSync``), or after it under ``:ef``.

The mean multiplies the sum by ``fl(1/n)``: the reference divides by the
constant n, which XLA compiles into that multiply (exact for n a power
of two, one rounding otherwise) — so the ring is bit-identical to the
reference's at any n.

Not ported: checked mode (``checked_mode_strategy``), whose AD has no
exchange collective at all.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from theanompi_tpu_torch.nn.layers import PLAIN, from_reference_layout, to_reference_layout
from theanompi_tpu_torch.ops.quant import LANES, wire_decode, wire_decode_add, wire_encode
from theanompi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    axis_group,
    inv_f32,
    post_hop,
)
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any
Strategy = Callable[[Tree], Tree]
# ``grads -> tree of layout tags`` (``Model.param_layouts``)
Layouts = Callable[[Tree], Tree]


def _pack_leaves(leaves, tags) -> torch.Tensor:
    """Leaves -> one new flat fp32 buffer (never a view of a leaf), each
    leaf in its reference layout, in the given order (the reference's
    ``ravel_pytree`` and ``_pack_flat``)."""
    return torch.cat([to_reference_layout(g, tag).reshape(-1).float()
                      for g, tag in zip(leaves, tags)])


def _unpack_leaves(flat: torch.Tensor, leaves, tags) -> list:
    """Inverse of :func:`_pack_leaves`: pieces of ``flat`` in each input
    leaf's shape, dtype and layout."""
    pieces, off = [], 0
    for g, tag in zip(leaves, tags):
        shape = to_reference_layout(g, tag).shape
        piece = flat[off:off + g.numel()].view(shape).to(g.dtype)
        pieces.append(from_reference_layout(piece, tag))
        off += g.numel()
    return pieces


def _packed(fn: Callable[[torch.Tensor], torch.Tensor], layouts: Layouts) -> Strategy:
    """Wrap a flat-buffer collective into a tree strategy: pack every
    leaf into one fp32 vector (the reference's ``ravel_pytree`` order:
    sorted keys, each leaf in its reference layout), run ``fn``, unpack
    into leaves of each input leaf's dtype and layout."""

    def strategy(grads: Tree) -> Tree:
        leaves, tags = tree_leaves(grads), tree_leaves(layouts(grads))
        it = iter(_unpack_leaves(fn(_pack_leaves(leaves, tags)), leaves, tags))
        return tree_map(lambda _: next(it), grads)

    return strategy


def _all_reduce_mean(flat: torch.Tensor, n: int, group=None,
                     divisor: Optional[int] = None) -> torch.Tensor:
    """The sum of ``flat`` over the ``n`` ranks of ``group`` (``None``:
    the world), in place, times ``fl(1/divisor)`` (default ``n``: the
    mean)."""
    if n > 1:
        dist.all_reduce(flat, group=group)
    return flat * inv_f32(n if divisor is None else divisor)


def mean_across_ranks(tensors: list, n: int, group=None) -> list:
    """The mean over the ``n`` ranks of ``group`` (``None``: the world)
    of a list of tensors (metrics, BN statistics), in one fp32
    ``all_reduce``; each result in its input's shape and dtype."""
    if not tensors:
        return []
    flat = _all_reduce_mean(torch.cat([t.detach().reshape(-1).float() for t in tensors]), n,
                            group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


# --------------------------------------------------------------------------
# psum family (≙ Exch_nccl32 / Exch_nccl16)
# --------------------------------------------------------------------------


def psum_mean(n: int, layouts: Layouts, group=None, divisor: Optional[int] = None) -> Strategy:
    """One fp32 ``all_reduce`` of the packed gradients over the ``n`` ranks
    of ``group`` (``None``: the world; a worker group's ``"data"`` axis
    under EASGD / GoSGD; a mesh axis of the ND engine), times
    ``fl(1/n)``, or ``fl(1/divisor)`` given one (the ND sync divides by
    every participating rank, whatever the group)."""
    return _packed(lambda flat: _all_reduce_mean(flat, n, group, divisor), layouts)


def psum_bf16(n: int, layouts: Layouts) -> Strategy:
    """bf16 operands reduced in bf16, as the reference's bf16 ``pmean``:
    half the wire of ``psum``, with bf16 accumulation (``ring_bf16`` is
    the bf16-wire / fp32-accumulate variant)."""

    def fn(flat):
        wire = flat.to(torch.bfloat16)
        if n > 1:
            dist.all_reduce(wire)
        return (wire * inv_f32(n)).float()

    return _packed(fn, layouts)


# --------------------------------------------------------------------------
# explicit segmented ring (≙ Exch_asa32 / Exch_asa16)
# --------------------------------------------------------------------------


def _hop(send: torch.Tensor, n: int, shift: int = 1, group=None) -> torch.Tensor:
    """Send ``send`` to the rank ``shift`` ahead and receive the
    same-shaped tensor from the rank ``shift`` behind, among the ``n``
    ranks of ``group`` (``None``: the world; positions are ranks within
    the group), in one batched point-to-point exchange
    (``mesh.post_hop``: under gloo a card's hop goes through the host,
    since gloo's point-to-point ops move host memory only)."""
    return post_hop([send], n, shift, group).wait()[0]


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
    return _packed(lambda flat: _ring_allreduce_flat(flat, n, wire) * inv_f32(n), layouts)


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


def codec_psum_mean(n: int, codec, layouts: Layouts, group=None,
                    divisor: Optional[int] = None) -> Strategy:
    """Compressed allreduce ``(grads, ef) -> (mean grads, ef')`` over the
    ``n`` ranks of ``group`` (``psum_mean``'s ``group`` and ``divisor``):
    every leaf of ``grads`` through the codec in one round; marked
    ``stateful`` so ``train.make_train_step`` threads ``state.ef``."""
    mean = psum_mean(n, layouts, group, divisor)

    def strategy(grads, ef):
        wire, ef = codec.compress(grads, ef, layouts(grads))
        return mean(wire), ef

    strategy.stateful = True
    return strategy


# --------------------------------------------------------------------------
# hierarchical two-hop exchange (≙ the reference's 'hier'): in-slice
# reduce-scatter, cross-slice all_reduce of the 1/s shard (the only hop a
# codec compresses), in-slice all-gather, over the mesh axes' groups
# --------------------------------------------------------------------------

# the card's torch may predate the ``*_single`` names this one prefers
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def hier_segment(n_elements: int, ici_size: int) -> int:
    """A rank's shard of the hierarchical exchange: the flat buffer padded
    to a multiple of the slice width and reduce-scattered, ``ceil(N / s)``."""
    return -(-int(n_elements) // max(1, int(ici_size)))


def _check_hier_axes(axis_sizes, world: Optional[int] = None) -> tuple:
    if not axis_sizes or len(tuple(axis_sizes)) != 2:
        raise ValueError(
            "strategy 'hier' needs a multi-slice run, axis_sizes=(n_slices, per_slice) "
            "(--slices N with N > 1); on one slice there is no slice boundary to "
            "schedule around, use 'psum'")
    r, s = (int(a) for a in axis_sizes)
    if world is not None and r * s != int(world):
        raise ValueError(f"hier axis_sizes {(r, s)} do not multiply to the {world} ranks")
    return r, s


def _hier_mean_flat(flat: torch.Tensor, r: int, s: int, dcn_wire=None) -> torch.Tensor:
    """The mean over the ``r·s`` ranks of a flat fp32 buffer in two hops:
    pad to ``s·seg`` and reduce-scatter over ``"data"`` (each rank holds
    its slice's sum of one ``seg`` shard), ``dcn_wire(shard)`` (the
    codec, on this hop alone), ``all_reduce`` over ``"dcn"``, ``·
    fl(1/n)``, all-gather over ``"data"`` and cut back to the buffer's
    length."""
    L = flat.numel()
    seg = hier_segment(L, s)
    if s > 1:
        buf = flat.new_zeros(s * seg)
        buf[:L] = flat
        shard = flat.new_empty(seg)
        _reduce_scatter(shard, buf, group=axis_group(DATA_AXIS)[0])
    else:
        shard = flat.clone()
    if r > 1:
        if dcn_wire is not None:
            shard = dcn_wire(shard)
        dist.all_reduce(shard, group=axis_group(DCN_AXIS)[0])
    shard = shard * inv_f32(r * s)
    if s == 1:
        return shard
    out = flat.new_empty(s * seg)
    _all_gather(out, shard, group=axis_group(DATA_AXIS)[0])
    return out[:L]


def _ef_wire(codec, ef_rows: list, i: int):
    """``dcn_wire`` of the ``:ef`` composition: the shard through
    ``codec`` against residual row ``ef_rows[i]``, which it replaces."""

    def wire(shard):
        out, ef_rows[i] = codec.compress_leaf(shard, ef_rows[i], PLAIN)
        return out

    return wire


def hierarchical_sync(axis_sizes, codec, layouts: Layouts) -> Strategy:
    """The ``hier`` strategy over ``axis_sizes = (n_slices, per_slice)``.
    Codec off, it is the flat mean re-associated slice first (close to
    ``psum``, not bit-identical: the sum runs in another order). An
    active codec compresses only the cross-slice hop: stateless codecs
    quantize the slice-reduced shard; ``:ef`` keeps this rank's residual
    of that shard, one fp32 row of ``seg`` elements in ``TrainState.ef``
    (:func:`hier_ef_template`), and is marked ``stateful``."""
    r, s = _check_hier_axes(axis_sizes)
    if codec.active and codec.error_feedback:

        def strategy(grads, ef):
            rows = [ef]
            out = _packed(lambda flat: _hier_mean_flat(flat, r, s, _ef_wire(codec, rows, 0)),
                          layouts)(grads)
            return out, rows[0]

        strategy.stateful = True
        return strategy
    qdq = codec.qdq if codec.active else None
    return _packed(lambda flat: _hier_mean_flat(flat, r, s, qdq), layouts)


def hier_ef_template(params: Tree, axis_sizes, bucket_bytes: Optional[int] = None):
    """Zero residuals of hier's ``:ef`` on this rank: one fp32 row of
    ``hier_segment(N, s)`` elements (the reference's ``(n, seg)`` array
    holds one such row a rank), or with ``bucket_bytes`` a tuple of one
    row a bucket, in ``assign_buckets`` order."""
    _, s = _check_hier_axes(axis_sizes)
    leaves = tree_leaves(params)

    def zeros(idx):
        n = sum(leaves[i].numel() for i in idx)
        return torch.zeros(hier_segment(n, s), dtype=torch.float32, device=leaves[0].device)

    if bucket_bytes is None:
        return zeros(range(len(leaves)))
    return tuple(zeros(idx) for idx in assign_buckets(leaves, bucket_bytes))


# --------------------------------------------------------------------------
# bucketed overlap with the backward (--allreduce-buckets): the exchange
# cut into ~MB buckets, each posted as soon as the backward has made its
# gradients
# --------------------------------------------------------------------------


def _leaf_wire_bytes(leaf) -> int:
    """fp32 wire bytes of one gradient leaf (gradients cross the exchange
    in fp32 whatever the param dtype)."""
    return (leaf.numel() or 1) * 4


def assign_buckets(leaves, bucket_bytes: int) -> list:
    """Leaf indices in contiguous buckets of about ``bucket_bytes``,
    walking the leaves in REVERSE flat order (the backward makes the late
    layers' gradients first); a leaf over the budget is a bucket of its
    own. The reference's buckets, index for index."""
    buckets, cur, cur_b = [], [], 0
    for i in reversed(range(len(leaves))):
        b = _leaf_wire_bytes(leaves[i])
        if cur and cur_b + b > bucket_bytes:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(i)
        cur_b += b
    if cur:
        buckets.append(cur)
    return buckets


def bucket_overlap_frac(n_buckets: int) -> float:
    """The share of the buckets whose exchange can hide under the rest of
    the backward: all but the last, ``(B-1)/B``; 0 for one exchange."""
    n = int(n_buckets or 0)
    return (n - 1) / n if n > 1 else 0.0


class _BucketRound:
    """One backward's buckets in flight: a hook on each param leaf (a
    leaf's hook runs when its gradient is whole, every use summed) posts
    a bucket's exchange when the bucket's last gradient arrives.

    Why leaf hooks and not an identity ``autograd.Function`` a bucket
    (the reference's ``custom_vjp`` tag): autograd runs the ready node
    of the highest sequence number first, so tags made before the
    forward all wait for the end of the backward, while a leaf's
    gradient node runs as soon as it is ready.

    On the card the exchange runs on a side stream, which waits for the
    compute stream at the bucket's post and which the step waits for in
    :meth:`finish`: the backward's kernels do not queue behind the
    collectives. The packed buffer is made on the compute stream and
    kept alive until then; nothing the side stream reads is freed
    early."""

    def __init__(self, sync: "BucketedOverlapSync", params: Tree):
        self.sync = sync
        leaves = tree_leaves(params)
        self.tags = tree_leaves(sync.layouts(params))
        self.buckets = assign_buckets(leaves, sync.bucket_bytes)
        self.grads: list = [None] * len(leaves)
        self.missing = [len(idx) for idx in self.buckets]
        self.results: list = [None] * len(self.buckets)
        # (bucket, gradients the backward had still to make) at each post
        self.posts: list = []
        bucket_of = {i: b for b, idx in enumerate(self.buckets) for i in idx}
        self.handles = [leaf.register_hook(self._hook(i, bucket_of[i]))
                        for i, leaf in enumerate(leaves)]

    def _hook(self, i: int, b: int):
        def hook(grad):
            self.grads[i] = grad
            self.missing[b] -= 1
            if self.missing[b] == 0:
                self._post(b)

        return hook

    def _post(self, b: int) -> None:
        self.posts.append((b, sum(g is None for g in self.grads)))
        idx = self.buckets[b]
        grads = [self.grads[i] for i in idx]
        tags = [self.tags[i] for i in idx]
        flat = self.sync.pack(grads, tags)  # on the compute stream
        side = self.sync.side_stream(flat.device)
        ctx = contextlib.nullcontext()
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(flat.device))
            ctx = torch.cuda.stream(side)
        with ctx:
            self.results[b] = (flat, self.sync.exchange(flat))

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def finish(self, grads: Tree) -> Tree:
        """The mean gradients (``grads``: the backward's local ones, whose
        tree they take): buckets whose hooks never ran (a leaf the loss
        does not reach) are posted now; the compute stream waits for the
        side stream."""
        self.close()
        leaves = tree_leaves(grads)
        for b, idx in enumerate(self.buckets):
            if self.results[b] is None:
                for i in idx:
                    self.grads[i] = leaves[i]
                self._post(b)
        dev = leaves[0].device if leaves else None
        side = self.sync.side_stream(dev) if dev is not None else None
        if side is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(side)
            for _, mean in self.results:
                mean.record_stream(cur)
        out = list(leaves)
        for idx, (_, mean) in zip(self.buckets, self.results):
            sub = [leaves[i] for i in idx]
            for i, piece in zip(idx, _unpack_leaves(mean, sub, [self.tags[i] for i in idx])):
                out[i] = piece
        it = iter(out)
        return tree_map(lambda _: next(it), grads)


class BucketedOverlapSync:
    """The exchange in buckets of about ``bucket_mb`` fp32 MB
    (``assign_buckets``), over ``n`` ranks, the leaves in the reference's
    flat order and layouts (``layouts``).

    In the backward (``in_backward``: no codec, or a stateless one): the
    step calls :meth:`begin` on the params before the forward, and
    ``finish`` on its :class:`_BucketRound` with the local gradients
    after the backward; each bucket's exchange is posted from the
    backward as soon as its gradients are whole. Per bucket: a stateless
    codec quantizes each leaf (one multi-leaf launch each way a bucket
    for int8), the bucket packs into one fp32 buffer and is reduced by
    one ``all_reduce`` (psum) or by the two hops of hier
    (``axis_sizes``; the codec then on the cross-slice hop only). A
    leaf's mean is the single psum's, bit for bit where the sum of the
    ranks does not depend on the buffer's length.

    After the backward (``stateful``, ``:ef``): each bucket through the
    codec against the residuals of its own leaves, then its collective
    (``__call__(grads, ef)``); under hier the residual is one shard row a
    bucket (:func:`hier_ef_template`)."""

    def __init__(self, n: int, bucket_mb: float, codec, layouts: Layouts, axis_sizes=None):
        if not bucket_mb or bucket_mb <= 0:
            raise ValueError(f"--allreduce-buckets needs a positive bucket size in MB, "
                             f"got {bucket_mb!r}")
        self.n = int(n)
        self.bucket_mb = float(bucket_mb)
        self.bucket_bytes = max(1, int(bucket_mb * 2 ** 20))
        self.codec = codec
        self.layouts = layouts
        self.axis_sizes = (_check_hier_axes(axis_sizes, n) if axis_sizes is not None else None)
        self.hier = self.axis_sizes is not None
        self.stateful = codec.active and codec.error_feedback
        self.in_backward = not self.stateful
        self._side: dict = {}

    def buckets_for(self, tree: Tree) -> list:
        return assign_buckets(tree_leaves(tree), self.bucket_bytes)

    def side_stream(self, device):
        """The exchange's stream on ``device`` (None on the CPU)."""
        if device is None or torch.device(device).type != "cuda":
            return None
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def pack(self, grads: list, tags: list) -> torch.Tensor:
        """One bucket's local gradients -> its flat fp32 buffer; a
        stateless codec quantizes each leaf first, unless hier's cross-slice
        hop takes it."""
        if self.codec.active and not self.hier:
            grads, _ = self.codec.compress(grads, None, tags)
        return _pack_leaves(grads, tags)

    def exchange(self, flat: torch.Tensor, dcn_wire=None) -> torch.Tensor:
        """The mean of one bucket's buffer over the ranks."""
        if self.hier:
            r, s = self.axis_sizes
            if dcn_wire is None and self.codec.active:
                dcn_wire = self.codec.qdq
            return _hier_mean_flat(flat, r, s, dcn_wire)
        return _all_reduce_mean(flat, self.n)

    def begin(self, params: Tree) -> _BucketRound:
        return _BucketRound(self, params)

    def __call__(self, grads: Tree, ef: Tree):
        """The ``:ef`` exchange after the backward -> ``(mean grads, ef')``."""
        leaves, tags = tree_leaves(grads), tree_leaves(self.layouts(grads))
        buckets = assign_buckets(leaves, self.bucket_bytes)
        ef_leaves = list(ef) if self.hier else tree_leaves(ef)
        want = len(buckets) if self.hier else len(leaves)
        if len(ef_leaves) != want:
            raise ValueError(
                f"error-feedback state has {len(ef_leaves)} leaves for {want} "
                f"{'buckets' if self.hier else 'leaves'}: the engine state was not "
                "initialized for this exchange")
        out, new_ef = list(leaves), list(ef_leaves)
        for b, idx in enumerate(buckets):
            sub, stags = [leaves[i] for i in idx], [tags[i] for i in idx]
            if self.hier:
                mean = self.exchange(_pack_leaves(sub, stags), _ef_wire(self.codec, new_ef, b))
            else:
                # one codec round and one collective a bucket: the
                # residuals stay keyed to this bucket's leaves
                wire, e2 = self.codec.compress(sub, [ef_leaves[i] for i in idx], stags)
                for i, e in zip(idx, e2):
                    new_ef[i] = e
                mean = self.exchange(_pack_leaves(wire, stags))
            for i, piece in zip(idx, _unpack_leaves(mean, sub, stags)):
                out[i] = piece
        it = iter(out)
        grads_out = tree_map(lambda _: next(it), grads)
        if self.hier:
            return grads_out, tuple(new_ef)
        it = iter(new_ef)
        return grads_out, tree_map(lambda _: next(it), grads)


def bucketed(name: str, n: int, bucket_mb: float, codec=None, *, layouts: Layouts,
             axis_sizes=None) -> BucketedOverlapSync:
    """``--allreduce-buckets``: validate the (strategy, codec) pair and
    return the bucketed exchange. ``psum`` and ``hier`` only: the rings
    schedule their own segments."""
    codec = _resolve_codec(name, codec)
    key = _ALIASES.get(name, name)
    if key == "hier":
        _check_hier_axes(axis_sizes, n)
        return BucketedOverlapSync(n, bucket_mb, codec, layouts, axis_sizes)
    if key != "psum":
        raise ValueError(
            f"--allreduce-buckets needs strategy 'psum' or 'hier' (got {name!r}): the "
            "explicit ring variants already schedule their own segments, and compressed "
            "wires ride the codec knob (--wire-codec) on the psum path")
    return BucketedOverlapSync(n, bucket_mb, codec, layouts)


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
_RINGS = ("ring", "ring_bf16", "ring_int8")


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


def get_strategy(name: str, n: int, codec=None, *, layouts: Layouts,
                 axis_sizes=None) -> Strategy:
    """The exchange over ``n`` ranks (the default process group's world).
    ``codec``: a wire codec spec or instance (``parallel/codec.py``). With
    ``psum`` it gives the stateful compressed strategy; with ``ring`` it
    selects the ring's wire; with ``hier`` it compresses the cross-slice
    hop; strategies that already compress refuse it. ``layouts``: ``grads
    -> layout tags`` (``Model.param_layouts``). ``axis_sizes``: ``(n_slices,
    per_slice)`` of a multi-slice run (``parallel/mesh.py``), which
    ``hier`` needs and the single-axis rings refuse."""
    codec = _resolve_codec(name, codec)
    key = _ALIASES.get(name, name)
    if key == "hier":
        _check_hier_axes(axis_sizes, n)
        return hierarchical_sync(axis_sizes, codec, layouts)
    if key in _RINGS and axis_sizes is not None and int(axis_sizes[0]) > 1:
        raise ValueError(
            f"strategy {name!r} is a single-axis ring; on a multi-slice run use "
            "'psum'/'psum_bf16' (one reduction over every rank) or 'hier' (the staged "
            "two-hop schedule, codec on the cross-slice hop)")
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
            f"{sorted(_CANONICAL) + ['hier'] + sorted(_ALIASES)}"
        ) from None
