"""Transformer LM models under the zoo contract.

Port of ``theanompi_tpu/models/lm.py`` (the dense models): the SAME
training loop and engine that train the CNN zoo train an LM —

    python -m theanompi_tpu_torch.cli BSP 1 transformer_lm TransformerLM_136M --synthetic

Token batches come from ``lm_synthetic`` / ``lm_text`` (``data/lm.py``):
"images" are token windows ``[B, T] int32`` and labels are the same
windows (next-token targets are shifted in-model; the last position is
masked). ``MoELMModel`` and ``TransformerLM_350M`` (per-block remat)
come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.models.transformer import (
    TransformerLM,
    next_token_loss,
    softmax_nll,
)
from theanompi_tpu_torch.nn.layers import PLAIN
from theanompi_tpu_torch.tree import tree_map


@dataclasses.dataclass
class LMRecipe(Recipe):
    """Recipe with the LM architecture knobs. ``input_shape`` is
    ``(seq_len,)`` and ``num_classes`` the vocabulary size."""

    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    # "ring" = exact full attention (the plain oracle without SP);
    # "flash" / "ring_flash" / "ulysses_flash" = the flash kernels
    attn: str = "ring"
    remat: bool = False
    loss_chunk: Optional[int] = None


class TransformerLMModel(Model):
    """Dense decoder-only LM under the zoo contract; ``self.arch`` is the
    functional :class:`TransformerLM`."""

    name = "transformer_lm"
    is_lm = True
    is_moe = False

    def __init__(self, recipe: Optional[LMRecipe] = None, pool_kernel: bool = False):
        if pool_kernel:
            raise ValueError(f"{type(self).__name__} has no max pool; pool_kernel=True "
                             "would do nothing")
        self.recipe = recipe or self.default_recipe()
        r = self.recipe
        self.arch = TransformerLM(
            vocab=r.num_classes,
            d_model=r.d_model,
            n_heads=r.n_heads,
            n_layers=r.n_layers,
            d_ff=r.d_ff,
            max_len=r.input_shape[0],
            attn=r.attn,
            remat=r.remat,
            dtype=r.compute_dtype,
            loss_chunk=r.loss_chunk,
        )

    @classmethod
    def default_recipe(cls) -> LMRecipe:
        return LMRecipe(
            batch_size=32,
            n_epochs=5,
            optimizer="adam",
            schedule="constant",
            sched_kwargs={"lr": 1e-3},
            lr_unit="step",
            input_shape=(128,),
            num_classes=64,
            dataset="lm_synthetic",
        )

    def init(self, gen: torch.Generator, device="cpu") -> tuple:
        params = self.arch.init(gen)
        return tree_map(lambda t: t.to(device).requires_grad_(True), params), {}

    def apply(self, params, state, tokens, *, train: bool = False, gen=None):
        # token ids stay integers: no cast to the compute dtype
        del train, gen  # no dropout in this LM
        return self.arch.forward(params, tokens), state

    def loss(self, logits, labels):
        # labels ARE the token window [B, T]; targets are shifted in-model
        return next_token_loss(labels, None, softmax_nll(logits))

    def metrics(self, logits, labels) -> dict:
        preds = torch.argmax(logits[:, :-1].float(), dim=-1)
        err = (preds != labels[:, 1:].long()).float().mean()
        return {"error": err}

    def param_layouts(self, params):
        return tree_map(lambda _: PLAIN, params)


class TransformerLM_136M(TransformerLMModel):
    """GPT-2-small-scale config (~136M params): 12 layers x d=768 (12
    heads of 64), d_ff 3072, T=1024, 32k vocab, flash attention; bf16
    compute with fp32 params and fp32 softmax/norm statistics; Adam at
    lr 3e-4, batch 8 sequences."""

    name = "transformer_lm_136m"

    @classmethod
    def default_recipe(cls) -> LMRecipe:
        return LMRecipe(
            batch_size=8,
            n_epochs=1,
            optimizer="adam",
            schedule="constant",
            sched_kwargs={"lr": 3e-4},
            lr_unit="step",
            input_shape=(1024,),
            num_classes=32768,
            dataset="lm_synthetic",
            compute_dtype=torch.bfloat16,
            d_model=768,
            n_heads=12,
            n_layers=12,
            d_ff=3072,
            attn="flash",
        )
