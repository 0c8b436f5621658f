"""Train/eval step construction (port of ``theanompi_tpu/train.py``).

The reference jits forward + backward + optimizer update into one XLA
program. PyTorch runs eagerly, so here a step is a Python function over
device tensors that never waits on the device: the loss, metrics, LR and
step counter all stay device tensors, the LR is evaluated on the device
from the step counter, and the optimizer writes parameters in place.
The caller decides when to read metrics back.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.ops.optimizers import apply_updates
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any


class TrainState(NamedTuple):
    """Params + model state (BN stats) + optimizer state + the
    device-resident int32 step counter that drives the LR schedule."""

    params: Tree
    model_state: Tree
    opt_state: Tree
    step: torch.Tensor


def init_train_state(model: Model, gen: torch.Generator, device=None,
                     optimizer=None) -> TrainState:
    """Params drawn from ``gen`` (a CPU generator) and placed on ``device``
    (``None``: the CUDA card, raising without one; ``"cpu"`` only when
    asked for); optimizer state from ``optimizer`` (default: the recipe's
    rule)."""
    device = resolve_device(device)
    params, model_state = model.init(gen, device)
    opt = optimizer or model.optimizer()
    with torch.no_grad():
        opt_state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(params, model_state, opt_state, step)


def make_schedule_fn(model: Model, steps_per_epoch: int = 1):
    """``step -> lr`` honoring the recipe's schedule unit."""
    schedule = model.schedule()
    per_epoch = float(max(1, steps_per_epoch))
    by_epoch = model.recipe.lr_unit == "epoch"

    def schedule_lr(step):
        return schedule(step / per_epoch if by_epoch else step)

    return schedule_lr


def loss_and_grads(model: Model, params, model_state, images, labels, gen):
    """Forward + backward -> ``(loss, logits, new_model_state, grads)``.
    ``grads`` is a tree shaped like ``params`` (from ``torch.autograd.grad``,
    so nothing accumulates into ``.grad``)."""
    leaves = tree_leaves(params)
    logits, new_model_state = model.apply(params, model_state, images, train=True, gen=gen)
    loss = model.loss(logits, labels)
    flat = torch.autograd.grad(loss, leaves)
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), logits.detach(), new_model_state, grads


def _optimizer_for(model: Model, fused_update: bool):
    if fused_update:
        from theanompi_tpu_torch.ops.fused_update import fuse_optimizer

        return fuse_optimizer(model.recipe.optimizer, **model.recipe.opt_kwargs)
    return model.optimizer()


def make_train_step(
    model: Model,
    steps_per_epoch: int = 1,
    accum_steps: int = 1,
    fused_update: bool = False,
):
    """Build the step ``(state, images, labels, gen) -> (state, metrics)``.

    ``fused_update``: swap the recipe's optimizer for its fused one-pass
    form (ops/fused_update.py — one CUDA kernel per leaf on the card).
    SGD-family rules only; others refuse. The returned state shares its
    param and optimizer-state tensors with the input state: they are
    updated in place.

    ``accum_steps > 1``: the batch is split into that many microbatches
    whose fp32-accumulated gradients average before the single update.
    """
    optimizer = _optimizer_for(model, fused_update)
    schedule_lr = make_schedule_fn(model, steps_per_epoch)
    accum_steps = max(1, int(accum_steps))

    def train_step(state: TrainState, images, labels, gen):
        if accum_steps == 1:
            loss, logits, new_model_state, grads = loss_and_grads(
                model, state.params, state.model_state, images, labels, gen,
            )
            with torch.no_grad():
                metrics = {"loss": loss, **model.metrics(logits, labels)}
        else:
            B = images.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} must be divisible by accum_steps={accum_steps}")
            mb = B // accum_steps
            model_state = state.model_state
            gsum = None
            ms = []
            for i in range(accum_steps):
                x, y = images[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb]
                loss, logits, model_state, grads = loss_and_grads(
                    model, state.params, model_state, x, y, gen,
                )
                with torch.no_grad():
                    ms.append({"loss": loss, **model.metrics(logits, y)})
                    # fp32 accumulation whatever the param dtype
                    g32 = tree_map(lambda g: g.float(), grads)
                    gsum = g32 if gsum is None else tree_map(torch.add, gsum, g32)
            new_model_state = model_state
            with torch.no_grad():
                grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype), gsum, state.params)
                metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

        lr = schedule_lr(state.step)
        if optimizer.apply is not None:
            # fused one-pass epilogue: params and velocity rewritten in place
            _, new_opt_state = optimizer.apply(grads, state.opt_state, state.params, lr)
        else:
            with torch.no_grad():
                updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                          state.params, lr)
            apply_updates(state.params, updates)
        metrics = {**metrics, "lr": lr}
        new_state = TrainState(state.params, new_model_state, new_opt_state, state.step + 1)
        return new_state, metrics

    return train_step


def make_eval_step(model: Model):
    """``(state, images, labels) -> metrics`` (loss + errors) in eval mode."""
    from theanompi_tpu_torch.models.zoo import infer_fn

    fwd = infer_fn(model)

    def eval_step(state: TrainState, images, labels):
        logits = fwd(state.params, state.model_state, images)
        with torch.no_grad():
            return {"loss": model.loss(logits, labels), **model.metrics(logits, labels)}

    return eval_step
