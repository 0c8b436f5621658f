"""Train/eval step construction (port of ``theanompi_tpu/train.py``).

The reference jits forward + backward + optimizer update into one XLA
program. PyTorch runs eagerly, so here a step is a Python function over
device tensors that never waits on the device: the loss, metrics, LR and
step counter all stay device tensors, the LR is evaluated on the device
from the step counter, and the optimizer writes parameters in place.
The caller decides when to read metrics back.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.graphs import StepGraph, eager_steps
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.ops.optimizers import apply_updates
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any


class TrainState(NamedTuple):
    """Params + model state (BN stats) + optimizer state + the
    device-resident int32 step counter that drives the LR schedule.

    ``ef``: this rank's wire-codec error-feedback residuals
    (``parallel/codec.py``), one f32 tensor per param leaf; ``()`` (the
    default) whenever the codec carries no state."""

    params: Tree
    model_state: Tree
    opt_state: Tree
    step: torch.Tensor
    ef: Tree = ()


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
    so nothing accumulates into ``.grad``). ``logits`` is what the model's
    training forward returns, detached: a tensor, or a tuple of them
    (GoogLeNet's main and auxiliary logits), which ``model.metrics`` takes."""
    leaves = tree_leaves(params)
    logits, new_model_state = model.apply(params, model_state, images, train=True, gen=gen)
    loss = model.loss(logits, labels)
    flat = torch.autograd.grad(loss, leaves)
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), tree_map(torch.Tensor.detach, logits), new_model_state, grads


def _optimizer_for(model: Model, fused_update: bool):
    if fused_update:
        from theanompi_tpu_torch.ops.fused_update import fuse_optimizer

        return fuse_optimizer(model.recipe.optimizer, **model.recipe.opt_kwargs)
    return model.optimizer()


def make_input_transform(spec: Optional[dict], device=None) -> Optional[Callable]:
    """A dataset's ``device_transform`` (``{"mean", "scale"}``) as the
    step's input transform: ``(x.float() - mean) * scale`` in fp32 on
    ``device``, with ``mean`` a scalar, a per-channel vector or a
    crop-sized ``[H, W, C]`` plane over NHWC batches (the reference's
    ``launch/worker.py`` closure). ``None`` for ``None``. Plain PyTorch,
    as the reference's is ``jnp`` inside the step."""
    if spec is None:
        return None
    device = resolve_device(device)
    mean = torch.as_tensor(np.asarray(spec["mean"], np.float32), device=device)
    scale = torch.tensor(float(spec["scale"]), dtype=torch.float32, device=device)

    def input_transform(x: torch.Tensor) -> torch.Tensor:
        return (x.float() - mean) * scale

    return input_transform


def make_train_step(
    model: Model,
    steps_per_epoch: int = 1,
    accum_steps: int = 1,
    fused_update: bool = False,
    grad_sync=None,
    input_transform: Optional[Callable] = None,
):
    """Build the step ``(state, images, labels, gen) -> (state, metrics)``.

    ``fused_update``: swap the recipe's optimizer for its fused one-pass
    form (ops/fused_update.py — on the card, one multi-tensor CUDA kernel
    launch over all leaves per (param dtype, grad dtype) group).
    SGD-family rules only; others refuse. The returned state shares its
    param and optimizer-state tensors with the input state: they are
    updated in place.

    ``accum_steps > 1``: the batch is split into that many microbatches
    whose fp32-accumulated gradients average before the single update.

    ``grad_sync``: the exchanger hook (``parallel/strategies.py``), run on
    the (accumulated) gradients before the update; ``None`` means a
    single replica. A ``stateful`` sync runs as ``grads, ef =
    sync(grads, state.ef)``, threading the codec's residuals.

    ``input_transform``: applied to the images first, on the card (e.g.
    ``make_input_transform``: uint8 batches normalized in the step, so
    the host gathers, pins and copies 4x fewer bytes).
    """
    optimizer = _optimizer_for(model, fused_update)
    schedule_lr = make_schedule_fn(model, steps_per_epoch)
    accum_steps = max(1, int(accum_steps))

    def train_step(state: TrainState, images, labels, gen):
        if input_transform is not None:
            images = input_transform(images)
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

        new_ef = state.ef
        if grad_sync is not None:
            with torch.no_grad():
                if getattr(grad_sync, "stateful", False):
                    grads, new_ef = grad_sync(grads, state.ef)
                else:
                    grads = grad_sync(grads)

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
        new_state = TrainState(state.params, new_model_state, new_opt_state, state.step + 1,
                               new_ef)
        return new_state, metrics

    return train_step


def make_multi_step(step_fn: Callable, k: int, stacked: bool = False, *, device=None,
                    capture: bool = True):
    """Fuse ``k`` successive train steps into one call (port of the
    reference's ``make_multi_step``, a ``lax.scan`` of k steps).

    Returns ``run(state, images, labels, gen, after_step=None) ->
    (state, metrics)``, ``metrics`` a dict of fp32 tensors stacked over
    the k steps. ``stacked=True``: ``images`` and ``labels`` hold k
    batches along their first dimension (a tensor, or a sequence of k
    tensors); ``stacked=False``: the one batch is reused by every step
    (the benchmark's mode). The mode is explicit, as in the reference.
    ``gen`` draws every step's dropout masks in turn, as k sequential
    steps would. ``after_step()`` runs after each step is enqueued.

    On the card (``device``: ``None`` is the current CUDA device) the
    steps replay one captured CUDA graph (``graphs.StepGraph``; its first
    call runs the first step eagerly, then captures), and nothing waits
    for the device inside a call. ``capture=False``, and the CPU
    (``device="cpu"``, which must be asked for), run the plain loop of k
    eager steps: the benchmark's eager baseline. ``run.graph`` is the
    ``StepGraph``, or ``None``."""
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = resolve_device(device)
    graph = StepGraph(step_fn, device) if capture and device.type == "cuda" else None

    def run(state: TrainState, images, labels, gen, after_step=None):
        if stacked:
            if len(images) != k or len(labels) != k:
                raise ValueError(f"stacked=True expects {k} batches, got {len(images)} "
                                 f"images and {len(labels)} labels")
            xs, ys = images, labels
        else:
            xs, ys = [images] * k, [labels] * k
        if graph is not None:
            return graph.run(state, xs, ys, gen, after_step)
        return eager_steps(step_fn, state, xs, ys, gen, device, after_step)

    run.graph = graph
    return run


def view_mean(logits: torch.Tensor, views: int) -> torch.Tensor:
    """Each image's logits averaged over its ``views`` view-major rows, in
    fp32 as XLA computes ``jnp.mean`` (the sum times the reciprocal of
    the count), returned in the logits' dtype."""
    n = torch.full((), views, dtype=torch.float32, device=logits.device)
    x = logits.float().reshape(-1, views, logits.shape[-1])
    return (x.sum(dim=1) * torch.reciprocal(n)).to(logits.dtype)


def make_eval_step(model: Model, input_transform: Optional[Callable] = None, views: int = 1):
    """``(state, images, labels) -> metrics`` (loss + errors) in eval mode.

    ``input_transform`` as in ``make_train_step``. ``views > 1``:
    multi-view evaluation (10-crop: 4 corners + center, each mirrored):
    ``images`` holds ``len(labels) * views`` rows, view-major per image,
    and each image's logits are averaged over its views before the loss
    and metrics."""
    from theanompi_tpu_torch.models.zoo import infer_fn

    fwd = infer_fn(model)

    def eval_step(state: TrainState, images, labels):
        if input_transform is not None:
            images = input_transform(images)
        logits = fwd(state.params, state.model_state, images)
        with torch.no_grad():
            if views > 1:
                logits = view_mean(logits, views)
            return {"loss": model.loss(logits, labels), **model.metrics(logits, labels)}

    return eval_step
