"""Dense decoder-only transformer LM: the single-device training surface.

Port of ``theanompi_tpu/models/transformer.py`` for one device: pre-norm
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
``ulysses`` the plain oracle (``ops/ring_attention.py``). Sequence and
tensor parallelism, the chunked loss, remat, MoE blocks and the paged
decode functions come in later slices; asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from theanompi_tpu_torch.models.contract import as_dtype
from theanompi_tpu_torch.nn.layers import gelu
from theanompi_tpu_torch.ops.flash_attention import flash_attention
from theanompi_tpu_torch.ops.ring_attention import full_attention_reference

Tree = Any

FLASH_ATTN = ("flash", "ulysses_flash", "ring_flash")


def _no_sp(sp_axis: Optional[str]) -> None:
    if sp_axis is not None:
        raise ValueError(
            f"sequence parallelism (sp_axis={sp_axis!r}) is not ported yet "
            "(ROADMAP.md); the port trains the LM on one device per replica"
        )


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
    causal attention, output projection; returns the residual delta."""
    _no_sp(sp_axis)
    hin = _rms(x, blk["ln1"])
    qkv = torch.einsum("btd,dchk->btchk", hin, blk["qkv"])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, T, H, hd]
    if attn in FLASH_ATTN:
        # no SP axis: both SP schemes degenerate to their local step
        att = flash_attention(q, k, v, causal=True)
    else:
        att = full_attention_reference(q, k, v, causal=True)
    return torch.einsum("bthk,hkd->btd", att, blk["proj"])


def global_positions(sp_axis: Optional[str], T: int, device=None) -> torch.Tensor:
    """Position ids of a window of ``T`` positions (one device: 0..T-1)."""
    _no_sp(sp_axis)
    return torch.arange(T, device=device)


def next_token_loss(tokens: torch.Tensor, sp_axis: Optional[str],
                    nll_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Mean next-token NLL over the batch: the target of position t is the
    token at t+1, and the last position (no target) is masked.
    ``nll_fn(targets) -> [B, T]`` gives the per-position NLL."""
    _no_sp(sp_axis)
    B, T = tokens.shape
    # the wrapped target of the last position is masked out below
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.ones((B, T), dtype=torch.float32, device=tokens.device)
    valid[:, T - 1] = 0.0
    nll = nll_fn(targets)
    return torch.sum(nll * valid) / torch.sum(valid)


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
        if self.remat:
            raise ValueError("remat=True (per-block activation checkpointing) is not "
                             "ported yet (ROADMAP.md)")
        if self.loss_chunk:
            raise ValueError("loss_chunk (the chunked loss) is not ported yet (ROADMAP.md)")
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
        for blk in params["blocks"]:
            blk = cast_block_params(blk, self.dtype)
            x = x + attention_block(blk, x, self.attn, sp_axis)
            hin = _rms(x, blk["ln2"])
            x = x + gelu(hin @ blk["mlp_in"]) @ blk["mlp_out"]
        return x

    def loss(self, params: Tree, tokens: torch.Tensor,
             axis_name: Optional[str] = None) -> torch.Tensor:
        """Next-token cross-entropy of ``tokens`` (``axis_name``: the
        sequence axis, which only the unported SP path sets)."""
        logits = self.forward(params, tokens, sp_axis=axis_name)
        return next_token_loss(tokens, axis_name, softmax_nll(logits))
