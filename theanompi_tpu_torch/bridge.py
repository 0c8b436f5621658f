"""Carry parameter and optimizer-state trees between the reference's
layout (numpy arrays, as ``np.asarray`` gives them from the JAX
package's pytrees) and the port's tensors. Test support: the parity
tests feed both packages the same weights through here.

The one layout difference is the conv kernel: the reference stores HWIO
with ``I = cin / groups``, the port OIHW with the same ``I``. Both
``feature_group_count`` and PyTorch's ``groups`` split channels into
contiguous blocks, so ``transpose(3, 2, 0, 1)`` maps one to the other
with no reordering across groups. Which leaves are conv kernels (or
their velocities) is said per leaf by a tree of layout tags
(``layouts``, from ``Model.param_layouts``). The parity tests' trees
that come without their model take :func:`default_layouts`, the Conv
layer's naming; the training path never does (the exchange and the
codec take the model's tags). Every other leaf, of any rank (the LM's
``qkv [d, 3, H, hd]``), keeps the reference's shape. Dense weights keep the ``(in, out)``
layout, and both packages flatten NHWC before ``fc6``, so its rows need
no permuting.

bfloat16 leaves travel as float32 numpy arrays (numpy has no bfloat16);
the values are exact either way. The round trip is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from theanompi_tpu_torch.nn.layers import (
    CONV_KERNEL,
    PLAIN,
    from_reference_layout,
    to_reference_layout,
)
from theanompi_tpu_torch.tree import tree_map

Tree = Any


def default_layouts(tree, key=None):
    """Layout tags for a tree that comes without its model (the parity
    tests' gradient, velocity and residual trees): the Conv layer's
    naming, a 4-D leaf named ``"w"`` is its kernel, every other leaf
    ``PLAIN``. A model's own trees take the tags it declares
    (``Model.param_layouts``)."""
    if isinstance(tree, dict):
        return {k: default_layouts(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(default_layouts(t, key) for t in tree)
    if tree is None:
        return None
    return CONV_KERNEL if key == "w" and len(tree.shape) == 4 else PLAIN


def _leaf_from_jax(a, layout: str, device, requires_grad: bool) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    t = from_reference_layout(t, layout).to(device)  # a conv kernel: HWIO -> OIHW
    if requires_grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _leaf_to_jax(t: torch.Tensor, layout: str) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    # a C-ordered copy (np.ascontiguousarray would turn a 0-d leaf 1-d)
    return np.array(to_reference_layout(t, layout).numpy(), order="C")  # OIHW -> HWIO


def tree_from_jax(tree: Tree, device="cpu", requires_grad: bool = False,
                  layouts: Tree = None) -> Tree:
    """Any reference tree (params, velocities, BN stats) -> the port's.
    ``layouts``: a tag per leaf (``Model.param_layouts``), or ``None`` for
    ``default_layouts(tree)``."""
    layouts = default_layouts(tree) if layouts is None else layouts
    return tree_map(lambda a, lay: _leaf_from_jax(a, lay, device, requires_grad), tree, layouts)


def tree_to_jax(tree: Tree, layouts: Tree = None) -> Tree:
    """Any port tree -> numpy arrays in the reference's layout."""
    layouts = default_layouts(tree) if layouts is None else layouts
    return tree_map(_leaf_to_jax, tree, layouts)


def params_from_jax(np_tree: Tree, device="cpu", layouts: Tree = None) -> Tree:
    """Reference params -> the port's params (leaves that require grad)."""
    return tree_from_jax(np_tree, device, requires_grad=True, layouts=layouts)


def params_to_jax(params: Tree, layouts: Tree = None) -> Tree:
    return tree_to_jax(params, layouts)


def opt_state_from_jax(np_state: Tree, device="cpu") -> Tree:
    """Reference optimizer state (e.g. ``{"vel": tree}``) -> the port's."""
    return tree_from_jax(np_state, device)


def opt_state_to_jax(state: Tree) -> Tree:
    return tree_to_jax(state)
