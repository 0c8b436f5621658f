"""Optimizer update rules over parameter trees.

Port of ``theanompi_tpu/ops/optimizers.py``: the same
``Optimizer(name, init, update, apply)`` contract and the same
AlexNet-era semantics —

- weight decay folded into the gradient: ``g += wd * p``;
- classical momentum: ``v = mu*v - lr*g``; ``p += v``;
- Nesterov momentum:  ``v = mu*v - lr*g``; ``p += mu*v - lr*g``;

with all arithmetic in the dtype of the optimizer state (fp32, even for
bf16 params).

``update(grads, state, params, lr) -> (updates, new_state)`` is pure: it
allocates new tensors and leaves its inputs alone. ``apply_updates`` and
the fused ``apply`` form write the parameters IN PLACE under
``torch.no_grad()`` (PyTorch idiom; the reference returned new arrays),
so a parameter tensor keeps its identity across steps.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params, lr) ->
    (updates, state)``; optional ``apply(grads, state, params, lr) ->
    (params, state)``, the fused one-pass form that rewrites params (and
    state) in place (ops/fused_update.py). ``train.make_train_step``
    prefers ``apply`` when present."""

    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Any], tuple]
    apply: Any = None


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p += u`` leafwise in place (in the param dtype); returns params."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


def _acc_like(params: Tree, dtype=torch.float32) -> Tree:
    """Zero accumulator tree in the accumulation dtype, with each param's
    device and memory layout (a conv weight's channels_last strides)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype), params)


def _decayed(grads: Tree, params: Tree, weight_decay: float, dtype=torch.float32) -> Tree:
    """Fold L2 weight decay into the gradient."""
    if weight_decay:
        return tree_map(lambda g, p: g.to(dtype) + weight_decay * p.to(dtype), grads, params)
    return tree_map(lambda g: g.to(dtype), grads)


def sgd(weight_decay: float = 0.0) -> Optimizer:
    """Vanilla SGD: ``p -= lr * (g + wd*p)``. Stateless."""

    def init(params):
        return ()

    def update(grads, state, params, lr):
        g = _decayed(grads, params, weight_decay)
        return tree_map(lambda gi: -lr * gi, g), state

    return Optimizer("sgd", init, update)


def momentum_sgd(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """Classical momentum SGD: ``v = mu*v - lr*(g + wd*p)``; ``p += v``."""

    def init(params):
        return {"vel": _acc_like(params)}

    def update(grads, state, params, lr):
        g = _decayed(grads, params, weight_decay)
        vel = tree_map(lambda v, gi: momentum * v - lr * gi, state["vel"], g)
        return vel, {"vel": vel}

    return Optimizer("momentum", init, update)


def nesterov_sgd(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """Nesterov momentum: ``v = mu*v - lr*g``; ``p += mu*v - lr*g``."""

    def init(params):
        return {"vel": _acc_like(params)}

    def update(grads, state, params, lr):
        g = _decayed(grads, params, weight_decay)
        vel = tree_map(lambda v, gi: momentum * v - lr * gi, state["vel"], g)
        updates = tree_map(lambda v, gi: momentum * v - lr * gi, vel, g)
        return updates, {"vel": vel}

    return Optimizer("nesterov", init, update)


def rmsprop(decay: float = 0.9, eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """RMSProp: ``s = rho*s + (1-rho)*g^2``; ``p -= lr * g / (sqrt(s) + eps)``."""

    def init(params):
        return {"sq": _acc_like(params)}

    def update(grads, state, params, lr):
        g = _decayed(grads, params, weight_decay)
        sq = tree_map(lambda s, gi: decay * s + (1.0 - decay) * torch.square(gi), state["sq"], g)
        updates = tree_map(lambda gi, s: -lr * gi / (torch.sqrt(s) + eps), g, sq)
        return updates, {"sq": sq}

    return Optimizer("rmsprop", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction."""

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        return {
            "m": _acc_like(params),
            "v": _acc_like(params),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(grads, state, params, lr):
        g = _decayed(grads, params, weight_decay)
        t = state["t"] + 1
        m = tree_map(lambda mi, gi: b1 * mi + (1.0 - b1) * gi, state["m"], g)
        v = tree_map(lambda vi, gi: b2 * vi + (1.0 - b2) * torch.square(gi), state["v"], g)
        tf = t.float()
        scale = lr * torch.sqrt(1.0 - torch.pow(b2, tf)) / (1.0 - torch.pow(b1, tf))
        updates = tree_map(lambda mi, vi: -scale * mi / (torch.sqrt(vi) + eps), m, v)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer("adam", init, update)


_REGISTRY: dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd,
    "momentum": momentum_sgd,
    "nesterov": nesterov_sgd,
    "rmsprop": rmsprop,
    "adam": adam,
}


def get_optimizer(name: str, **kwargs) -> Optimizer:
    """Look up an optimizer builder by name (recipes name their rule)."""
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; available: {sorted(_REGISTRY)}") from None
    try:
        return builder(**kwargs)
    except TypeError as e:
        hint = (
            " (clip_norm is a --fused-update-only knob — ops/fused_update.py)"
            if "clip_norm" in kwargs else ""
        )
        raise ValueError(f"optimizer {name!r} does not accept {sorted(kwargs)}: {e}{hint}") from None
