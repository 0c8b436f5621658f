"""Carry parameter and optimizer-state trees between the reference's
layout (numpy arrays, as ``np.asarray`` gives them from the JAX
package's pytrees) and the port's tensors. Test support: the parity
tests feed both packages the same weights through here.

The one layout difference is the conv kernel: the reference stores HWIO
with ``I = cin / groups``, the port OIHW with the same ``I``. Both
``feature_group_count`` and PyTorch's ``groups`` split channels into
contiguous blocks, so ``transpose(3, 2, 0, 1)`` maps one to the other
with no reordering across groups. Every 4-D leaf is a conv kernel (or
the velocity of one). Dense weights keep the ``(in, out)`` layout, and
both packages flatten NHWC before ``fc6``, so its rows need no permuting.

bfloat16 leaves travel as float32 numpy arrays (numpy has no bfloat16);
the values are exact either way. The round trip is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from theanompi_tpu_torch.nn.layers import from_reference_layout, to_reference_layout
from theanompi_tpu_torch.tree import tree_map

Tree = Any


def _leaf_from_jax(a, device, requires_grad: bool) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    t = from_reference_layout(t).to(device)  # HWIO -> OIHW
    if requires_grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _leaf_to_jax(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(to_reference_layout(t).numpy())  # OIHW -> HWIO


def tree_from_jax(tree: Tree, device="cpu", requires_grad: bool = False) -> Tree:
    """Any reference tree (params, velocities, BN stats) -> the port's."""
    return tree_map(lambda a: _leaf_from_jax(a, device, requires_grad), tree)


def tree_to_jax(tree: Tree) -> Tree:
    """Any port tree -> numpy arrays in the reference's layout."""
    return tree_map(_leaf_to_jax, tree)


def params_from_jax(np_tree: Tree, device="cpu") -> Tree:
    """Reference params -> the port's params (leaves that require grad)."""
    return tree_from_jax(np_tree, device, requires_grad=True)


def params_to_jax(params: Tree) -> Tree:
    return tree_to_jax(params)


def opt_state_from_jax(np_state: Tree, device="cpu") -> Tree:
    """Reference optimizer state (e.g. ``{"vel": tree}``) -> the port's."""
    return tree_from_jax(np_state, device)


def opt_state_to_jax(state: Tree) -> Tree:
    return tree_to_jax(state)
