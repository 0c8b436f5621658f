"""Dense decoder-only transformer LM: one device, or sharded over the
``(data, model, seq)`` mesh's axes.

Port of ``theanompi_tpu/models/transformer.py`` (its dense parts): pre-norm
blocks (RMS norm, causal attention, GELU MLP), learned positions, an
untied vocabulary head, and the next-token loss. Params keep the
reference's tree, names and shapes, so the bridge carries them across
leaf for leaf and the einsums keep their subscripts: ``qkv [d, 3, H,
hd]``, ``proj [H, hd, d]``, ``mlp_in [d, d_ff]``, ``mlp_out [d_ff, d]``,
``ln1``/``ln2 [d]``, ``tok_emb [V, d]``, ``pos_emb [max_len, d]``,
``head [d, V]``. Every leaf is ``PLAIN`` (``nn.layers``): the 4-D
``qkv`` is no conv kernel.

Mixed precision as the reference: params stored fp32, matmul weights and
activations cast to the compute dtype at use (``cast_block_params``),
norm statistics, softmax statistics and the loss in fp32.

Attention without a sequence-parallel axis: ``attn="flash"`` (and
``ulysses_flash`` / ``ring_flash``, which degrade to their local step)
runs the flash kernels (``ops/flash_attention.py``); ``ring`` and
``ulysses`` the plain oracle (``ops/ring_attention.py``). Under a
sequence axis (``sp_axis``, a mesh axis of ``parallel/mesh.py``; the
tokens ``[B, T/n]`` of this rank's shard): ``ring`` / ``ulysses`` are
the unfused ring and all-to-all schemes, ``ring_flash`` the ring whose
hops are the flash kernels, ``ulysses_flash`` the all-to-all around the
flash kernels; ``flash`` alone is refused. Positions are global
(``rank · T + t``), the target of a shard's last position is the next
shard's first token, and the loss's sum and count are summed over the
axis (``next_token_loss``).

Tensor parallelism (``tp_axis``, Megatron's): the leaves arrive as this
rank's shards of :meth:`TransformerLM.tp_param_specs` (heads of ``qkv``
and ``proj``, the hidden units of ``mlp_in`` and ``mlp_out``, the
vocabulary columns of ``head``; the embeddings and gains replicated), so
attention runs on the ``H / tp`` local heads (under a sequence axis too)
and each block's two row-parallel products end in one ``psum`` of their
residual delta over the axis, in the delta's own dtype (a bf16 delta
sums in bf16, as the reference's ``lax.psum`` does). The logits stay
vocab-sharded: ``_vocab_sharded_nll`` is the distributed cross-entropy
(the global max by ``pmax``, the normalizer and the target logit by
``psum``, statistics in fp32). ``loss_chunk`` under ``tp_axis`` is
refused, naming both: the reference ignores the chunk there without a
word (``theanompi_tpu/models/transformer.py:362-369``).

``remat=True`` checkpoints each block (the reference's
``jax.checkpoint(block)``): ``torch.utils.checkpoint`` without reentry
keeps none of a block's activations, and the backward runs the block's
forward again, the flash forward kernel and the block's psums included,
with the same ops in the same order (the same bf16 roundings).
``loss_chunk`` computes the loss per chunk of positions
(``chunked_nll``), each chunk's logits recomputed in the backward. Both
checkpoints run with ``preserve_rng_state=False``: the blocks and the
loss draw no random numbers, and stashing the CUDA generator's state is
not allowed while a step is captured into a CUDA graph. MoE blocks and
the paged decode functions come in later slices.

``nd_spec_setup`` is the reference's: the axes that take part, the ranks
they span (``n_total``) and the per-leaf specs. Each rank's backward
already carries the other ranks' dependence on its parameters (the
psum's transpose is a psum, the ppermute's the opposite shift, the
all-to-all's its inverse), so each rank's gradient is that of the sum of
every rank's loss: ``sync_grads_by_spec`` sums each leaf over every
participating axis it is not sharded on and divides by ``n_total``,
which is the gradient of the global mean loss, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from theanompi_tpu_torch.models.contract import as_dtype
from theanompi_tpu_torch.nn.layers import gelu
from theanompi_tpu_torch.ops.flash_attention import flash_attention, ring_flash_attention
from theanompi_tpu_torch.ops.ring_attention import (
    full_attention_reference,
    ring_attention,
    ulysses_attention,
    validate_ulysses_heads,
)
from theanompi_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_index,
    pmax,
    post_hop,
    psum,
)
from theanompi_tpu_torch.parallel.strategies import codec_psum_mean, psum_mean
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any

FLASH_ATTN = ("flash", "ulysses_flash", "ring_flash")
SP_ATTN = {
    "ring": ring_attention,
    "ring_flash": ring_flash_attention,
    "ulysses": ulysses_attention,
    "ulysses_flash": functools.partial(ulysses_attention, local_fn=flash_attention),
}


def _rms(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # statistics in fp32 even when x is bf16, the fp32 gain; the output
    # returns to x's compute dtype for the next matmul
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6) * g
    return y.to(x.dtype)


def cast_block_params(blk: dict, dtype: torch.dtype) -> dict:
    """Matmul weights to the compute ``dtype`` (their grads come back
    fp32 through the cast), norm gains (and an MoE router's ``gate``)
    left fp32. No-op for fp32 compute."""
    if dtype == torch.float32:
        return blk
    skip = ("ln1", "ln2", "gate")
    return {k: (v if k in skip else v.to(dtype)) for k, v in blk.items()}


def attention_block(blk: dict, x: torch.Tensor, attn: str, sp_axis: Optional[str]) -> torch.Tensor:
    """Pre-norm attention sub-block: qkv projection (``[d, 3, H, hd]``),
    causal attention (under ``sp_axis`` one of the four sequence-parallel
    schemes of ``SP_ATTN``), output projection; returns the residual
    delta."""
    if sp_axis is not None and attn == "flash":
        raise ValueError(
            "attn='flash' is the fused LOCAL kernel; under sequence parallelism pick "
            "attn='ring_flash' (K/V rotation, each hop folded by the fused kernel) or "
            "attn='ulysses_flash' (all-to-all with the fused local step) — "
            "'ring'/'ulysses' are their unfused variants")
    hin = _rms(x, blk["ln1"])
    qkv = torch.einsum("btd,dchk->btchk", hin, blk["qkv"])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, T, H, hd]
    if sp_axis is not None:
        if attn not in SP_ATTN:
            raise ValueError(f"unknown attention {attn!r}; under sequence parallelism: "
                             f"{sorted(SP_ATTN)}")
        att = SP_ATTN[attn](q, k, v, sp_axis, causal=True)
    elif attn in FLASH_ATTN:
        # no SP axis: both SP schemes degenerate to their local step
        att = flash_attention(q, k, v, causal=True)
    else:
        att = full_attention_reference(q, k, v, causal=True)
    return torch.einsum("bthk,hkd->btd", att, blk["proj"])


def global_positions(sp_axis: Optional[str], T: int, device=None) -> torch.Tensor:
    """Global position ids of a window of ``T`` local positions: ``rank ·
    T + arange(T)`` on the sequence axis ``sp_axis`` (one device:
    0..T-1). The one shard-offset rule of the forward."""
    base = axis_index(sp_axis) * T if sp_axis is not None else 0
    return base + torch.arange(T, device=device)


def next_token_loss(tokens: torch.Tensor, sp_axis: Optional[str],
                    nll_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Mean next-token NLL over this rank's batch rows x the GLOBAL
    sequence: the target of position t is the token at t+1 (under
    ``sp_axis`` the target of a shard's last position is the next shard's
    first token, fetched by one backward ppermute), and the final global
    position (no target) is masked. Under ``sp_axis`` the sum and the
    count are summed over the axis (the sum by ``mesh.psum``, whose
    transpose is a psum), so every rank of the axis holds the same loss.
    ``nll_fn(targets) -> [B, T]`` gives the per-position NLL."""
    B, T = tokens.shape
    valid = torch.ones((B, T), dtype=torch.float32, device=tokens.device)
    if sp_axis is not None:
        group, n = axis_group(sp_axis)
        last_shard = axis_index(sp_axis) == n - 1
        # each rank's first tokens go to the rank behind it (no gradient)
        nxt = post_hop([tokens[:, 0].contiguous()], n, -1, group).wait()[0] if n > 1 \
            else tokens[:, 0]
        targets = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
    else:
        last_shard = True
        # the wrapped target of the last position is masked out below
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    if last_shard:
        valid[:, T - 1] = 0.0
    nll = nll_fn(targets)
    total = torch.sum(nll * valid)
    count = torch.sum(valid)
    if sp_axis is not None:
        total = psum(total, sp_axis)
        count = psum(count, sp_axis)
    return total / count


def chunked_nll(x: torch.Tensor, head: torch.Tensor, chunk: int,
                dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-position NLL computed a chunk of ``chunk`` positions at a time
    from the hidden states ``x [B, T, d]``: each chunk's ``[B, chunk, V]``
    logits (the head matmul in ``dtype``) are reduced to ``logsumexp -
    logit[target]`` in fp32 and dropped, and the backward recomputes them
    chunk by chunk (the body is checkpointed). The loss's memory falls
    from O(T x V) to O(chunk x V); the values are ``softmax_nll``'s on the
    full logits. Raises when ``chunk`` does not divide the sequence."""

    def body(xb, hd, tb):
        lf = (xb @ hd).float()
        lse = torch.logsumexp(lf, dim=-1)
        tl = torch.gather(lf, -1, tb.long()[..., None])[..., 0]
        return lse - tl

    def nll_fn(targets):
        T = targets.shape[1]
        if T % chunk:
            raise ValueError(f"loss_chunk={chunk} must divide the local sequence length {T}")
        hd = head.to(dtype)
        return torch.cat([checkpoint(body, x[:, i:i + chunk], hd, targets[:, i:i + chunk],
                                     use_reentrant=False, preserve_rng_state=False)
                          for i in range(0, T, chunk)], dim=1)

    return nll_fn


def softmax_nll(logits: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-position NLL ``logsumexp(logits) - logits[target]`` in fp32
    whatever the compute dtype."""

    def nll_fn(targets):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        tl = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
        return lse - tl

    return nll_fn


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    """Architecture config; params live in a plain dict tree. ``attn``:
    ``flash`` / ``ulysses_flash`` / ``ring_flash`` (the flash kernels) or
    ``ring`` / ``ulysses`` (the plain oracle). ``dtype``: the compute
    dtype."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_len: int = 1024
    attn: str = "ring"
    remat: bool = False
    dtype: Any = torch.float32
    loss_chunk: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))

    def init(self, gen: torch.Generator) -> Tree:
        """Params drawn from ``gen`` on the CPU: N(0, 0.02) weights, unit
        norm gains."""
        d, h = self.d_model, self.d_ff
        nh, hd = self.n_heads, self.d_model // self.n_heads

        def normal(*shape):
            return 0.02 * torch.randn(shape, generator=gen)

        params = {
            "tok_emb": normal(self.vocab, d),
            "pos_emb": normal(self.max_len, d),
            "head": normal(d, self.vocab),
            "blocks": [],
        }
        for _ in range(self.n_layers):
            params["blocks"].append({
                "qkv": normal(d, 3, nh, hd),
                "proj": normal(nh, hd, d),
                "mlp_in": normal(d, h),
                "mlp_out": normal(h, d),
                "ln1": torch.ones(d),
                "ln2": torch.ones(d),
            })
        return params

    def forward(self, params: Tree, tokens: torch.Tensor, *, sp_axis: Optional[str] = None,
                tp_axis: Optional[str] = None) -> torch.Tensor:
        """``tokens [B, T] -> logits [B, T, V]`` in the compute dtype
        (under ``tp_axis`` this rank's vocabulary columns ``[B, T, V /
        tp]``)."""
        x = self.forward_hidden(params, tokens, sp_axis=sp_axis, tp_axis=tp_axis)
        return x @ params["head"].to(self.dtype)

    def forward_hidden(self, params: Tree, tokens: torch.Tensor, *,
                       sp_axis: Optional[str] = None,
                       tp_axis: Optional[str] = None) -> torch.Tensor:
        """``tokens [B, T] -> hidden [B, T, d]`` (the forward without the
        vocabulary head). Under ``tp_axis`` the block leaves are this
        rank's shards and each block's attention and FFN deltas are
        summed over the axis (the row-parallel ``proj`` and
        ``mlp_out``)."""
        T = tokens.shape[1]
        pos = global_positions(sp_axis, T, tokens.device)
        tokens = tokens.long()
        # cast AFTER the gathers (cheaper than casting the [V, d] table)
        x = (params["tok_emb"][tokens] + params["pos_emb"][pos][None]).to(self.dtype)

        def block(x, blk):
            blk = cast_block_params(blk, self.dtype)
            delta = attention_block(blk, x, self.attn, sp_axis)
            if tp_axis is not None:
                delta = psum(delta, tp_axis)  # row-parallel proj
            x = x + delta
            hin = _rms(x, blk["ln2"])
            delta = gelu(hin @ blk["mlp_in"]) @ blk["mlp_out"]
            if tp_axis is not None:
                delta = psum(delta, tp_axis)  # row-parallel mlp_out
            return x + delta

        remat = self.remat and torch.is_grad_enabled()
        for blk in params["blocks"]:
            if remat:
                # the block's activations are recomputed in the backward
                x = checkpoint(block, x, blk, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, blk)
        return x

    def loss(self, params: Tree, tokens: torch.Tensor, axis_name: Optional[str] = None, *,
             tp_axis: Optional[str] = None) -> torch.Tensor:
        """Next-token cross-entropy of ``tokens`` over the global sequence
        (``axis_name``: the sequence axis, over which ``tokens`` is this
        rank's shard); per chunk of positions (``chunked_nll``, the chunk
        dividing the local length) when ``loss_chunk`` is set. Under
        ``tp_axis`` the logits stay vocab-sharded and the cross-entropy
        is ``_vocab_sharded_nll``; ``loss_chunk`` there is refused."""
        check_tp_loss_chunk(self, tp_axis)
        if self.loss_chunk:
            x = self.forward_hidden(params, tokens, sp_axis=axis_name)
            return next_token_loss(tokens, axis_name,
                                   chunked_nll(x, params["head"], self.loss_chunk, self.dtype))
        logits = self.forward(params, tokens, sp_axis=axis_name, tp_axis=tp_axis)
        return next_token_loss(tokens, axis_name, pick_nll(logits, tp_axis))

    def tp_param_specs(self, tp_axis: str = MODEL_AXIS) -> Tree:
        """Megatron's sharding, in the reference's form: per leaf, a tuple
        of one entry a dimension, the mesh axis that dimension is sharded
        on or None (``()``: replicated). Heads column-sharded in ``qkv``
        and row-sharded in ``proj``, the FFN's hidden units in ``mlp_in``
        and ``mlp_out``, the vocabulary columns of ``head``; the
        embeddings and the norm gains replicated."""
        blk = {"qkv": (None, None, tp_axis, None), "proj": (tp_axis, None, None),
               "mlp_in": (None, tp_axis), "mlp_out": (tp_axis, None), "ln1": (), "ln2": ()}
        return {"tok_emb": (), "pos_emb": (), "head": (None, tp_axis),
                "blocks": [dict(blk) for _ in range(self.n_layers)]}


# --------------------------------------------------------------------------
# the vocabulary-sharded cross-entropy
# --------------------------------------------------------------------------


def _vocab_sharded_nll(logits: torch.Tensor, targets: torch.Tensor,
                       tp_axis: str) -> torch.Tensor:
    """``-log softmax(logits)[target]`` with the vocabulary dimension
    sharded over ``tp_axis`` (this rank holds columns ``t·V_local …``):
    Megatron's parallel cross-entropy. The global max by ``pmax`` (a
    stabilizer only, with no gradient: it cancels in ``log z + m``), the
    normalizer and the target logit by ``psum``, the target logit picked
    on the shard that owns it (zero elsewhere). Statistics in fp32
    whatever the logits' dtype."""
    logits = logits.float()
    V_local = logits.shape[-1]
    start = axis_index(tp_axis) * V_local
    m = pmax(torch.amax(logits, dim=-1), tp_axis)  # [B, T]
    z = psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1), tp_axis)
    local_ids = targets.long() - start
    in_range = (local_ids >= 0) & (local_ids < V_local)
    idx = local_ids.clamp(0, V_local - 1)
    tl = torch.gather(logits, -1, idx[..., None])[..., 0]
    tl = psum(torch.where(in_range, tl, torch.zeros_like(tl)), tp_axis)
    return torch.log(z) + m - tl


def pick_nll(logits: torch.Tensor, tp_axis: Optional[str]) -> Callable:
    """The per-position NLL function of (possibly vocab-sharded) logits:
    the distributed cross-entropy under ``tp_axis``, ``softmax_nll``
    otherwise."""
    if tp_axis is not None:
        return lambda targets: _vocab_sharded_nll(logits, targets, tp_axis)
    return softmax_nll(logits)


def validate_tp_divisibility(model: TransformerLM, tp_axis: str, ntp: int) -> None:
    """Megatron's divisibility contract (the reference's message): the
    axis size divides the heads, the FFN's hidden units and the
    vocabulary."""
    if model.n_heads % ntp or model.d_ff % ntp or model.vocab % ntp:
        raise ValueError(
            f"the {tp_axis!r} axis size {ntp} must divide each of n_heads/d_ff/vocab "
            f"({model.n_heads}/{model.d_ff}/{model.vocab})")


def check_tp_loss_chunk(model, tp_axis: Optional[str]) -> None:
    """Refuse ``loss_chunk`` under tensor parallelism, naming both: the
    chunked loss applies the whole head per chunk, and the reference
    drops the chunk there without a word."""
    if tp_axis is not None and getattr(model, "loss_chunk", None):
        raise ValueError(
            f"loss_chunk={model.loss_chunk} does not compose with --tp (the {tp_axis!r} axis): "
            "the vocab-sharded cross-entropy already keeps no full logits; drop loss_chunk "
            "(--recipe-arg loss_chunk=None)")


# --------------------------------------------------------------------------
# the dense ND mesh: the reference's spec setup and spec-driven sync
# --------------------------------------------------------------------------


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names, in order of appearance."""
    out = []
    for entry in spec or ():
        for ax in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if ax is not None:
                out.append(str(ax))
    return tuple(out)


def psum_axes(spec, axes) -> tuple:
    """The participating ``axes`` a leaf's gradient is summed over: those
    its spec does not shard it on (the reference's
    ``parallel/recipe.py::psum_axes``)."""
    sharded_on = set(spec_axes(spec))
    return tuple(a for a in axes if a not in sharded_on)


def nd_spec_setup(model: TransformerLM, axis_sizes: dict, dp_axis: Optional[str],
                  tp_axis: Optional[str], sp_axis: Optional[str]) -> tuple:
    """Mesh and shape checks of the dense ND step (the reference's
    ``nd_spec_setup``) -> ``(axes, n_total, specs)``: the axes that take
    part, the number of ranks they span, and the per-leaf specs
    (``tp_param_specs`` under ``tp_axis``, else every leaf replicated,
    ``()``). The Ulysses check takes the local heads ``H / tp``."""
    axes = [a for a in (dp_axis, tp_axis, sp_axis) if a is not None]
    if not axes:
        raise ValueError("need at least one of dp_axis/tp_axis/sp_axis")
    for a in axes:
        if a not in axis_sizes:
            raise ValueError(f"axis {a!r} not in mesh axes {sorted(axis_sizes)}")
    if tp_axis:
        validate_tp_divisibility(model, tp_axis, axis_sizes[tp_axis])
        check_tp_loss_chunk(model, tp_axis)
    heads_local = model.n_heads // (axis_sizes[tp_axis] if tp_axis else 1)
    if sp_axis and model.attn in ("ulysses", "ulysses_flash"):
        validate_ulysses_heads(heads_local, axis_sizes[sp_axis], sp_axis)
    n_total = 1
    for a in axes:
        n_total *= axis_sizes[a]
    specs = model.tp_param_specs(tp_axis) if tp_axis else map_specs(
        lambda _: (), model.tp_param_specs(MODEL_AXIS))
    return axes, n_total, specs


def spec_bounds(shape, spec, coords: dict) -> list:
    """``[start, stop)`` of each dimension of a rank's shard of a global
    ``shape`` under ``spec``: an entry names an axis, or a tuple of axes
    taken as one mixed-radix index in their order; ``coords`` maps each
    axis to ``(index, size)``."""
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    out = []
    for dim, entry in zip(shape, entries):
        idx, n = 0, 1
        for ax in spec_axes((entry,)):
            i, size = coords[ax]
            idx, n = idx * size + i, n * size
        if dim % n:
            raise ValueError(f"dimension {dim} of a {tuple(shape)} leaf does not split over "
                             f"{spec_axes((entry,))} ({n} shards)")
        per = dim // n
        out.append([idx * per, (idx + 1) * per])
    return out


def shard_leaf(x, spec, coords: dict):
    """Rank's shard of the global leaf ``x`` (a tensor or an array) under
    ``spec`` (``spec_bounds``): a view."""
    return x[tuple(slice(a, b) for a, b in spec_bounds(x.shape, spec, coords))]


def global_shape(local_shape, spec, coords: dict) -> tuple:
    """The global shape of a leaf whose shard has ``local_shape``."""
    entries = list(spec or ()) + [None] * (len(local_shape) - len(spec or ()))
    return tuple(int(d) * math.prod(coords[a][1] for a in spec_axes((e,)))
                 for d, e in zip(local_shape, entries))


def join_shards(shards: list, spec, coords_list: list):
    """The global leaf from the shards of every rank (numpy arrays, each
    with its rank's ``coords``): each written at its bounds."""
    first = np.asarray(shards[0])
    full = np.empty(global_shape(first.shape, spec, coords_list[0]), first.dtype)
    for piece, coords in zip(shards, coords_list):
        full[tuple(slice(a, b) for a, b in spec_bounds(full.shape, spec, coords))] = piece
    return full


def sync_grads_by_spec(grads: Tree, specs: Tree, axes, n_total: int, layouts: Tree,
                       codec=None, ef: Tree = (), sizes: Optional[dict] = None) -> tuple:
    """The reference's gradient sync of the ND step -> ``(grads, ef')``:
    each leaf summed over every participating axis it is not sharded on,
    then divided by ``n_total``, the number of ranks the participating
    axes span (not the size of the group it is summed over). The leaves
    are cut into the groups of equal ``psum_axes``, each group one fp32
    ``all_reduce`` of its packed leaves over the bound mesh's process
    group of those axes, times ``fl(1/n_total)``. ``codec``: each group
    with a wire (its axes span more than one rank) goes through the wire
    codec first, each rank's own part quantized (one codec round a
    group, error feedback in ``ef``, this rank's residual tree); a leaf
    with no wire, such as one pure ``--tp`` shards (its psum axes all of
    one rank), passes through untouched, its residual too. ``sizes``:
    each axis's size, where known (an axis set of one rank needs no bound
    group then)."""
    leaves, spec_l, tags = tree_leaves(grads), tree_leaves_specs(specs), tree_leaves(layouts)
    ef_l = tree_leaves(ef) if codec is not None and codec.error_feedback else None
    out, new_ef = list(leaves), (list(ef_l) if ef_l is not None else None)
    by_axes: dict = {}
    for i, spec in enumerate(spec_l):
        by_axes.setdefault(psum_axes(spec, axes), []).append(i)
    for pax, idx in by_axes.items():
        if sizes is not None and math.prod(sizes[a] for a in pax) == 1:
            group, n = None, 1
        else:
            group, n = axis_group(pax) if pax else (None, 1)
        sub, sub_tags = [leaves[i] for i in idx], [tags[i] for i in idx]
        lay = lambda _, t=sub_tags: t  # noqa: E731
        if codec is not None and codec.active and n > 1:
            sub_ef = [ef_l[i] for i in idx] if ef_l is not None else ()
            synced, sub_ef = codec_psum_mean(n, codec, lay, group, n_total)(sub, sub_ef)
            if ef_l is not None:
                for i, r in zip(idx, sub_ef):
                    new_ef[i] = r
        else:
            synced = psum_mean(n, lay, group, n_total)(sub)
        for i, g in zip(idx, synced):
            out[i] = g
    it = iter(out)
    grads = tree_map(lambda _: next(it), grads)
    if new_ef is None:
        return grads, ef
    it = iter(new_ef)
    return grads, tree_map(lambda _: next(it), ef)


def tree_leaves_specs(specs: Tree) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a
    tuple, which ``tree_leaves`` would walk into)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in tree_leaves_specs(specs[k])]
    if isinstance(specs, list):
        return [s for t in specs for s in tree_leaves_specs(t)]
    return [specs]


def map_specs(fn: Callable, specs: Tree) -> Tree:
    """``fn`` over the specs of a spec tree (dicts and lists walked, a
    spec tuple taken whole)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, t) for t in specs]
    return fn(specs)
