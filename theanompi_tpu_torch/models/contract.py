"""The model contract (port of ``theanompi_tpu/models/contract.py``).

A model is a **Recipe** (the hyperparameters it owns) plus

- ``init(gen, device) -> (params, state)``: trees of tensors on
  ``device``; params are leaves that require grad;
- ``apply(params, state, images, train, gen) -> (logits, state)``:
  images NHWC, cast to ``recipe.compute_dtype`` first;
- ``loss(logits, labels)`` and ``metrics(logits, labels)``, in fp32.
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
    dataset: str = "synthetic"
    val_batch_size: Optional[int] = None

    def replace(self, **kw) -> "Recipe":
        return dataclasses.replace(self, **kw)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return nll.mean()


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """top-1 / top-5 error."""
    logits = logits.float()
    labels = labels.long()
    err1 = (logits.argmax(dim=-1) != labels).float().mean()
    k = min(5, logits.shape[-1])
    topk = torch.topk(logits, k, dim=-1).indices
    errk = 1.0 - (topk == labels[:, None]).any(dim=-1).float().mean()
    return {"error": err1, "top5_error": errk}


class Model:
    """Base model. Subclasses set ``default_recipe`` and ``build`` (the
    network as an ``nn.Layer``); everything else is inherited."""

    name = "model"
    recipe: Recipe

    def __init__(self, recipe: Optional[Recipe] = None):
        self.recipe = recipe or self.default_recipe()
        self.net = self.build()

    @classmethod
    def default_recipe(cls) -> Recipe:
        raise NotImplementedError

    def build(self):
        raise NotImplementedError

    @property
    def input_shape(self) -> tuple:
        return (self.recipe.batch_size, *self.recipe.input_shape)

    def init(self, gen: torch.Generator, device="cpu") -> tuple:
        """Draw params on the CPU from ``gen``, then place them on
        ``device``; params come back as leaves that require grad."""
        params, state = self.net.init(gen, self.input_shape)
        params = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        state = tree_map(lambda t: t.to(device), state)
        return params, state

    def apply(self, params, state, images, *, train: bool = False, gen=None):
        images = images.to(as_dtype(self.recipe.compute_dtype))
        return self.net.apply(params, state, images, train=train, gen=gen)

    def loss(self, logits, labels):
        return softmax_cross_entropy(logits, labels)

    def metrics(self, logits, labels) -> dict:
        return classification_metrics(logits, labels)

    def optimizer(self):
        from theanompi_tpu_torch.ops import get_optimizer

        return get_optimizer(self.recipe.optimizer, **self.recipe.opt_kwargs)

    def schedule(self):
        from theanompi_tpu_torch.ops import get_schedule

        return get_schedule(self.recipe.schedule, **self.recipe.sched_kwargs)
