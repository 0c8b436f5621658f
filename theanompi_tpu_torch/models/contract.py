"""The model contract (port of ``theanompi_tpu/models/contract.py``).

A model is a **Recipe** (the hyperparameters it owns) plus

- ``init(gen, device) -> (params, state)``: trees of tensors on
  ``device``; params are leaves that require grad;
- ``apply(params, state, images, train, gen) -> (logits, state)``:
  images NHWC, cast to ``recipe.compute_dtype`` first;
- ``loss(logits, labels)`` and ``metrics(logits, labels)``, in fp32;
- ``param_layouts(params)``: one layout tag per param leaf
  (``nn.layers.PLAIN`` or ``CONV_KERNEL``), which the gradient exchange
  and the wire codec follow to flatten a leaf in the reference's order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from theanompi_tpu_torch.tree import tree_map

Tree = Any


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown compute dtype {dtype!r}")
    return out


@dataclasses.dataclass
class Recipe:
    """Model-owned training recipe."""

    batch_size: int = 128
    n_epochs: int = 10
    optimizer: str = "momentum"
    opt_kwargs: dict = dataclasses.field(default_factory=dict)
    schedule: str = "constant"
    sched_kwargs: dict = dataclasses.field(default_factory=lambda: {"lr": 0.01})
    lr_unit: str = "epoch"  # 'epoch' | 'step': unit of the schedule's input
    input_shape: tuple = (32, 32, 3)  # (H, W, C)
    num_classes: int = 10
    compute_dtype: Any = torch.float32  # bfloat16 for the big ImageNet models
    # cross-replica BN over this mesh axis (None = per-replica stats,
    # averaged across ranks after each BSP step; nn.BatchNorm)
    bn_axis_name: Optional[str] = None
    dataset: str = "synthetic"
    val_batch_size: Optional[int] = None

    def replace(self, **kw) -> "Recipe":
        return dataclasses.replace(self, **kw)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return nll.mean()


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> int32 keys in XLA's total order: ``-NaN < -inf < ... < -0.0
    < +0.0 < ... < +inf < +NaN`` (the bits, with the magnitude flipped
    for negative values, as XLA's comparator does)."""
    bits = x.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _share(hits: torch.Tensor) -> torch.Tensor:
    """Mean of a 0/1 vector as XLA computes ``jnp.mean``: the sum (exact
    below 2^24 rows) times the fp32 reciprocal of the count."""
    n = torch.full((), hits.numel(), dtype=torch.float32, device=hits.device)
    return hits.float().sum() * torch.reciprocal(n)


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """top-1 / top-5 error, equal to the reference's bit for bit. Top-5
    membership follows ``jax.lax.top_k``: the label is in the top k when
    fewer than k entries come before it in XLA's total order, equal keys
    at a lower index first (``torch.topk`` promises no order among equal
    values). Top-1 takes the first maximum, as ``jnp.argmax`` does."""
    logits = logits.float()
    labels = labels.long()
    err1 = _share(logits.argmax(dim=-1) != labels)
    k = min(5, logits.shape[-1])
    key = _total_order_key(logits)
    key_y = torch.gather(key, -1, labels[:, None])
    lower = torch.arange(key.shape[-1], device=key.device)[None] < labels[:, None]
    rank = (key > key_y).sum(dim=-1) + ((key == key_y) & lower).sum(dim=-1)
    errk = 1.0 - _share(rank < k)
    return {"error": err1, "top5_error": errk}


class Model:
    """Base model. Subclasses set ``default_recipe`` and ``build`` (the
    network as an ``nn.Layer``); everything else is inherited."""

    name = "model"
    recipe: Recipe

    def __init__(self, recipe: Optional[Recipe] = None, pool_kernel: bool = False):
        self.recipe = recipe or self.default_recipe()
        # route the model's 3x3/stride-1 max pools to the pool kernel
        # (ops/pool.py); ``build`` reads it
        self.pool_kernel = bool(pool_kernel)
        self.net = self.build()
        if self.pool_kernel and not self.kernel_pools():
            raise ValueError(
                f"{type(self).__name__} has no 3x3/stride-1 max pool that the pool "
                "kernel can take at this recipe's shapes; pool_kernel=True would do nothing"
            )

    @classmethod
    def default_recipe(cls) -> Recipe:
        raise NotImplementedError

    def build(self):
        raise NotImplementedError

    @property
    def input_shape(self) -> tuple:
        return (self.recipe.batch_size, *self.recipe.input_shape)

    def kernel_pools(self) -> list:
        """Names of the pools that run the pool kernel at this recipe's
        shapes (none unless the model routes some)."""
        return []

    def init_tree(self, gen: torch.Generator) -> tuple:
        """``(params, state)`` drawn on the CPU from ``gen``."""
        return self.net.init(gen, self.input_shape)

    def init(self, gen: torch.Generator, device="cpu") -> tuple:
        """Draw params on the CPU from ``gen``, then place them on
        ``device``; params come back as leaves that require grad."""
        params, state = self.init_tree(gen)
        params = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        state = tree_map(lambda t: t.to(device), state)
        return params, state

    def apply(self, params, state, images, *, train: bool = False, gen=None):
        images = images.to(as_dtype(self.recipe.compute_dtype))
        return self.net.apply(params, state, images, train=train, gen=gen)

    def loss(self, logits, labels):
        return softmax_cross_entropy(logits, labels)

    def param_layouts(self, params) -> Tree:
        return self.net.param_layouts(params)

    def metrics(self, logits, labels) -> dict:
        return classification_metrics(logits, labels)

    def optimizer(self):
        from theanompi_tpu_torch.ops import get_optimizer

        return get_optimizer(self.recipe.optimizer, **self.recipe.opt_kwargs)

    def schedule(self):
        from theanompi_tpu_torch.ops import get_schedule

        return get_schedule(self.recipe.schedule, **self.recipe.sched_kwargs)
