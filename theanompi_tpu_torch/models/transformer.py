"""Dense decoder-only transformer LM: one device, or a sequence sharded
over a mesh axis.

Port of ``theanompi_tpu/models/transformer.py`` (its dense, tp-less parts): pre-norm
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

``remat=True`` checkpoints each block (the reference's
``jax.checkpoint(block)``): ``torch.utils.checkpoint`` without reentry
keeps none of a block's activations, and the backward runs the block's
forward again, the flash forward kernel included, with the same ops in
the same order (the same bf16 roundings). ``loss_chunk`` computes the
loss per chunk of positions (``chunked_nll``), each chunk's logits
recomputed in the backward. Both checkpoints run with
``preserve_rng_state=False``: the blocks and the loss draw no random
numbers, and stashing the CUDA generator's state is not allowed while a
step is captured into a CUDA graph. Tensor parallelism, MoE blocks and the
paged decode functions come in later slices.

``nd_spec_setup`` is the dense, tp-less part of the reference's. Every
leaf is replicated, so the reference's ``sync_grads_by_spec`` sums each
gradient over every rank of the mesh and divides by their count: BSP's
``psum`` exchange over the world (``parallel/nd.py``). Each rank's
backward already carries the other ranks' dependence on its parameters
(the psum's transpose is a psum, the ppermute's the opposite shift, the
all-to-all's its inverse), so that mean over ranks is the gradient of
the global mean loss, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

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
from theanompi_tpu_torch.parallel.mesh import axis_group, axis_index, post_hop, psum

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

    def forward(self, params: Tree, tokens: torch.Tensor, *,
                sp_axis: Optional[str] = None) -> torch.Tensor:
        """``tokens [B, T] -> logits [B, T, V]`` in the compute dtype."""
        return self.forward_hidden(params, tokens, sp_axis=sp_axis) @ params["head"].to(self.dtype)

    def forward_hidden(self, params: Tree, tokens: torch.Tensor, *,
                       sp_axis: Optional[str] = None) -> torch.Tensor:
        """``tokens [B, T] -> hidden [B, T, d]`` (the forward without the
        vocabulary head)."""
        T = tokens.shape[1]
        pos = global_positions(sp_axis, T, tokens.device)
        tokens = tokens.long()
        # cast AFTER the gathers (cheaper than casting the [V, d] table)
        x = (params["tok_emb"][tokens] + params["pos_emb"][pos][None]).to(self.dtype)

        def block(x, blk):
            blk = cast_block_params(blk, self.dtype)
            x = x + attention_block(blk, x, self.attn, sp_axis)
            hin = _rms(x, blk["ln2"])
            return x + gelu(hin @ blk["mlp_in"]) @ blk["mlp_out"]

        remat = self.remat and torch.is_grad_enabled()
        for blk in params["blocks"]:
            if remat:
                # the block's activations are recomputed in the backward
                x = checkpoint(block, x, blk, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, blk)
        return x

    def loss(self, params: Tree, tokens: torch.Tensor,
             axis_name: Optional[str] = None) -> torch.Tensor:
        """Next-token cross-entropy of ``tokens`` over the global sequence
        (``axis_name``: the sequence axis, over which ``tokens`` is this
        rank's shard); per chunk of positions (``chunked_nll``, the chunk
        dividing the local length) when ``loss_chunk`` is set."""
        if self.loss_chunk:
            x = self.forward_hidden(params, tokens, sp_axis=axis_name)
            return next_token_loss(tokens, axis_name,
                                   chunked_nll(x, params["head"], self.loss_chunk, self.dtype))
        logits = self.forward(params, tokens, sp_axis=axis_name)
        return next_token_loss(tokens, axis_name, softmax_nll(logits))


# --------------------------------------------------------------------------
# the dense ND mesh: the reference's spec setup, tp-less
# --------------------------------------------------------------------------


def nd_spec_setup(model: TransformerLM, axis_sizes: dict, dp_axis: Optional[str],
                  sp_axis: Optional[str]) -> tuple:
    """Mesh and shape checks of the dense ND step (the reference's
    ``nd_spec_setup`` without ``--tp``) -> ``(axes, n_total)``: the axes
    that take part and the number of ranks they span. Every leaf is
    replicated (the reference's ``P()`` specs)."""
    axes = [a for a in (dp_axis, sp_axis) if a is not None]
    if not axes:
        raise ValueError("need at least one of dp_axis/sp_axis")
    for a in axes:
        if a not in axis_sizes:
            raise ValueError(f"axis {a!r} not in mesh axes {sorted(axis_sizes)}")
    if sp_axis and model.attn in ("ulysses", "ulysses_flash"):
        validate_ulysses_heads(model.n_heads, axis_sizes[sp_axis], sp_axis)
    n_total = 1
    for a in axes:
        n_total *= axis_sizes[a]
    return axes, n_total
