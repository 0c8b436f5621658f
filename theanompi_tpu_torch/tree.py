"""Minimal pytree helpers over nested dicts / tuples / lists of tensors.

The port keeps the reference's parameter trees (nested dicts keyed by
layer name). Leaves are visited in the order ``jax.tree_util`` uses —
dict keys sorted, sequences in order — so a leaf index means the same
leaf in both packages.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable

import torch

Tree = Any


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure); returns a tree of ``tree``'s structure. Leaves are visited
    in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


__all__ = ["digest", "tree_leaves", "tree_map"]


def digest(tensors) -> str:
    """SHA-256 (hex, 16 digits) of the tensors' bytes, in order: equal
    digests mean bit-identical tensors (the summary's replica checks)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]
