"""Carry parameter and optimizer-state trees between the reference's
layout (numpy arrays, as ``np.asarray`` gives them from the JAX
package's pytrees) and the port's tensors. The parity tests feed both
packages the same weights through here, and checkpoints carry a
TrainState in the reference's file layout through here.

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

A whole ``TrainState`` maps to the flat entries of the reference's
checkpoint file (``utils/checkpoint.py``) through :func:`state_entries`
/ :func:`state_to_flat` and back through :func:`state_from_flat`: the
entry names are the reference's tree paths (``.params/00_conv1/w``,
``.opt_state/vel/...``, ``.step``), every parameter-shaped leaf (a
param, its velocity or Adam moment, its residual) follows the model's
layout tag, and ``.ef/<leaf>`` is the ``[n, ...]`` stack of every rank's
residual, as the reference keeps its residuals (hier's ``:ef``: ``.ef``,
the ``[n, seg]`` stack of the ranks' shard rows, or ``.ef/<bucket>``).
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
from theanompi_tpu_torch.tree import tree_leaves, tree_map
from theanompi_tpu_torch.utils.checkpoint import to_numpy

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
    return to_numpy(to_reference_layout(t, layout))  # OIHW -> HWIO


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


# --------------------------------------------------------------------------
# TrainState <-> the reference's checkpoint entries
# --------------------------------------------------------------------------


def _paths(tree: Tree, prefix: str) -> list:
    """``(key, leaf)`` pairs in ``tree_leaves`` order, each key the
    reference's tree path (dict keys and sequence indices joined by
    ``/``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _paths(t, f"{prefix}/{i}")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _opt_layouts(opt_state: Tree, layouts: Tree) -> Tree:
    """Layout tags of an optimizer state: each param-shaped tree of it
    (``vel``, Adam's ``m`` and ``v``) takes the params' tags, a lone
    tensor (Adam's ``t``) is ``PLAIN``."""
    if isinstance(opt_state, dict):
        return {k: PLAIN if isinstance(v, torch.Tensor) else layouts
                for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)) and not tree_leaves(opt_state):
        return opt_state
    raise ValueError(f"unsupported optimizer state {type(opt_state).__name__}")


def _state_pairs(state, layouts: Tree) -> list:
    """``(key, tensor, layout)`` of every leaf of ``state`` but ``ef``."""
    out = []
    for field, lays in (("params", layouts), ("model_state", None),
                        ("opt_state", _opt_layouts(state.opt_state, layouts))):
        tree = getattr(state, field)
        tags = tree_leaves(lays) if lays is not None else [PLAIN] * len(tree_leaves(tree))
        pairs = _paths(tree, f".{field}")
        if len(tags) != len(pairs):
            raise ValueError(f"{len(tags)} layout tags for the {len(pairs)} leaves of .{field}")
        out += [(k, t, lay) for (k, t), lay in zip(pairs, tags)]
    out.append((".step", state.step, PLAIN))
    return out


def _ef_layouts(ef: Tree, layouts: Tree) -> list:
    """Layout tags of the residual leaves: a param-shaped tree (a dict,
    the codec's one residual a leaf) takes the params' tags; hier's shard
    rows (a tensor, or a tuple of one a bucket) are ``PLAIN``."""
    if isinstance(ef, dict):
        return tree_leaves(layouts)
    return [PLAIN] * len(tree_leaves(ef))


def state_entries(state, layouts: Tree, ef_ranks: list = None) -> dict:
    """The checkpoint entries of a TrainState, as tensors in the
    reference's layout (views where no copy is needed): params, model
    state, optimizer state, ``.step``, and ``.ef/<leaf>``, the stack
    ``[n, ...]`` of ``ef_ranks`` (every rank's residual tree in rank
    order; required when ``state.ef`` has leaves). ``layouts``: the
    params' tags (``Model.param_layouts``)."""
    entries = {k: to_reference_layout(t.detach(), lay) for k, t, lay in _state_pairs(state, layouts)}
    if tree_leaves(state.ef):
        if not ef_ranks:
            raise ValueError("state.ef has residuals: the .ef stack needs every rank's "
                             "residual tree (ef_ranks)")
        lays = _ef_layouts(state.ef, layouts)
        for i, (k, _) in enumerate(_paths(state.ef, ".ef")):
            rows = [to_reference_layout(tree_leaves(r)[i].detach(), lays[i]) for r in ef_ranks]
            entries[k] = torch.stack([r.to(rows[0].device) for r in rows])
    return entries


def state_to_flat(state, layouts: Tree, ef_ranks: list = None) -> dict:
    """:func:`state_entries` as numpy arrays (bf16 as f32), the dict the
    reference's checkpoint holds."""
    return {k: to_numpy(t) for k, t in state_entries(state, layouts, ef_ranks).items()}


def _entry(flat: dict, key: str) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint is missing {key!r} — structure mismatch "
                       f"(available: {sorted(flat)[:8]}...)")
    return np.asarray(flat[key])


def _restored(arr: np.ndarray, tmpl: torch.Tensor, layout: str, key: str) -> torch.Tensor:
    want = tuple(to_reference_layout(tmpl, layout).shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, expected {want}")
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        # the reference's bf16 leaf (read as raw 2-byte records where
        # ml_dtypes is not loaded): widen exactly to f32
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    # a C-ordered copy (np.ascontiguousarray would turn a 0-d leaf 1-d)
    src = from_reference_layout(torch.from_numpy(np.array(arr, order="C")), layout)
    out = torch.empty_like(tmpl, requires_grad=False)  # the template's strides
    with torch.no_grad():
        out.copy_(src)
    return out.requires_grad_(tmpl.requires_grad)


def state_from_flat(flat: dict, template, layouts: Tree, rank: int = 0, world: int = 1):
    """A TrainState shaped like ``template`` (its structure, dtypes,
    devices, strides and ``requires_grad``; its values are ignored) from
    checkpoint entries (``utils/checkpoint.py::load_checkpoint``). Rank
    ``rank`` of ``world`` takes row ``rank`` of each ``.ef`` stack. Raises
    naming the entry on a missing key (KeyError), a wrong shape or an
    ``.ef`` stack of another world size (ValueError); nothing is
    resharded. Entries the template lacks are ignored, as the reference
    ignores them."""
    leaves = [_restored(_entry(flat, k), t, lay, k)
              for k, t, lay in _state_pairs(template, layouts)]
    stacks = sorted(k for k in flat if k == ".ef" or k.startswith(".ef/"))
    for k in stacks:
        n = np.shape(flat[k])[0] if np.ndim(flat[k]) else None
        if n != world:
            raise ValueError(f"checkpoint leaf {k!r} stacks the residuals of {n} ranks; this "
                             f"run has {world} (a resume onto another world is elastic: "
                             "--elastic reshards the checkpoint)")
    lays = _ef_layouts(template.ef, layouts)
    rows = [_restored(_entry(flat, k)[rank], t, lays[i], k)
            for i, (k, t) in enumerate(_paths(template.ef, ".ef"))]
    return _rebuilt(template, leaves, rows)


def _rebuilt(template, leaves: list, ef_rows: list):
    """``template`` with its leaves but ``ef``'s (in ``_state_pairs``
    order) and its residuals (in ``ef``'s leaf order) replaced."""
    it = iter(leaves)
    # a state without model state (the ND engine's) has no such field
    rebuilt = {f: tree_map(lambda _: next(it), getattr(template, f))
               for f in ("params", "model_state", "opt_state") if f in template._fields}
    ef_it = iter(ef_rows)
    ef = tree_map(lambda _: next(ef_it), template.ef) if ef_rows else template.ef
    return template._replace(**rebuilt, step=next(it), ef=ef)


# --------------------------------------------------------------------------
# per-worker rules (EASGD, GoSGD): the reference's stacked state
# --------------------------------------------------------------------------

WORKERS = ".workers/"


def tree_entries(tree: Tree, prefix: str, layouts: Tree = None) -> dict:
    """``{prefix/<path>: tensor}`` of ``tree`` in the reference's layout
    (``layouts``: the tree's tags; ``None``: every leaf ``PLAIN``)."""
    pairs = _paths(tree, prefix)
    tags = tree_leaves(layouts) if layouts is not None else [PLAIN] * len(pairs)
    return {k: to_reference_layout(t.detach(), lay) for (k, t), lay in zip(pairs, tags)}


def tree_from_entries(flat: dict, prefix: str, template: Tree, layouts: Tree = None) -> Tree:
    """Inverse of :func:`tree_entries`: a tree shaped like ``template``."""
    pairs = _paths(template, prefix)
    tags = tree_leaves(layouts) if layouts is not None else [PLAIN] * len(pairs)
    it = iter(_restored(_entry(flat, k), t, lay, k) for (k, t), lay in zip(pairs, tags))
    return tree_map(lambda _: next(it), template)


def stacked_entries(rows: list, prefix: str, layouts: Tree = None) -> dict:
    """Every worker's ``tree`` (``rows``, in worker order) as the
    reference's stack: ``{prefix/<path>: [n_workers, ...]}``."""
    per = [tree_entries(r, prefix, layouts) for r in rows]
    return {k: torch.stack([p[k].to(per[0][k].device) for p in per]) for k in per[0]}


def _worker_row(flat: dict, key: str, row: int, n_workers: int) -> np.ndarray:
    arr = _entry(flat, key)
    n = arr.shape[0] if arr.ndim else None
    if n != n_workers:
        raise ValueError(f"checkpoint leaf {key!r} stacks {n} workers; this run has "
                         f"{n_workers} (a resume onto another worker count is elastic: "
                         "--elastic reshards the checkpoint, utils/checkpoint.load_resharded)")
    return arr[row]


def stacked_row(flat: dict, prefix: str, template: Tree, row: int, n_workers: int,
                layouts: Tree = None) -> Tree:
    """Row ``row`` of a stack of :func:`stacked_entries`, shaped like
    ``template``; raises naming the entry when the stack holds another
    number of workers."""
    pairs = _paths(template, prefix)
    sub = {k: _worker_row(flat, k, row, n_workers) for k, _ in pairs}
    return tree_from_entries(sub, prefix, template, layouts)


def worker_entries(rows: list, layouts: Tree) -> dict:
    """Every worker's TrainState (``rows``, in worker order, their ``ef``
    left out) as the reference's ``.workers/.params/…``,
    ``.workers/.model_state/…``, ``.workers/.opt_state/…`` and
    ``.workers/.step`` stacks ``[n_workers, ...]``."""
    per = [{k: to_reference_layout(t.detach(), lay) for k, t, lay in _state_pairs(r, layouts)}
           for r in rows]
    return {WORKERS + k: torch.stack([p[k].to(per[0][k].device) for p in per])
            for k in per[0]}


def worker_from_flat(flat: dict, template, layouts: Tree, row: int, n_workers: int):
    """Worker ``row``'s TrainState (shaped like ``template``, whose ``ef``
    it keeps) from the ``.workers/`` stacks of a checkpoint of
    ``n_workers`` workers; raises naming the entry when a stack holds
    another number of workers (ValueError) or is missing (KeyError)."""
    sub = {}
    for k, _, _ in _state_pairs(template, layouts):
        sub[k] = _worker_row(flat, WORKERS + k, row, n_workers)
    return state_from_flat(sub, template._replace(ef=()), layouts)._replace(ef=template.ef)


# --------------------------------------------------------------------------
# the parts of a checkpoint each rank holds: sharded sets and reshard
# targets, with no collective
# --------------------------------------------------------------------------


def state_parts(state, layouts: Tree, rank: int = 0, world: int = 1) -> list:
    """``(entry, tensor, row, rows)`` of every entry of a BSP TrainState
    this rank holds, in the reference's layout (views): the replicated
    leaves (``row`` None) and its own row ``rank`` of each ``.ef`` stack
    of ``world`` rows."""
    parts = [(k, to_reference_layout(t.detach(), lay), None, 1)
             for k, t, lay in _state_pairs(state, layouts)]
    if tree_leaves(state.ef):
        lays = _ef_layouts(state.ef, layouts)
        parts += [(k, to_reference_layout(t.detach(), lays[i]), rank, world)
                  for i, (k, t) in enumerate(_paths(state.ef, ".ef"))]
    return parts


def worker_parts(worker, layouts: Tree, row: int, n_workers: int) -> list:
    """``(entry, tensor, row, rows)`` of one worker's ``.workers/`` rows
    (its ``ef`` left out); ``row`` -1 where another rank of the worker's
    group writes them."""
    return [(WORKERS + k, to_reference_layout(t.detach(), lay), row, n_workers)
            for k, t, lay in _state_pairs(worker._replace(ef=()), layouts)]


def _np_dtype(v) -> np.dtype:
    if isinstance(v, torch.Tensor):
        dt = torch.float32 if v.dtype == torch.bfloat16 else v.dtype
        return torch.empty((), dtype=dt).numpy().dtype
    return np.asarray(v).dtype


def _global_shape(v, row, rows) -> tuple:
    if isinstance(row, dict):
        return tuple(row["shape"])
    return (rows, *tuple(v.shape)) if row is not None else tuple(v.shape)


def entry_shapes(parts: list) -> dict:
    """``{entry: (global shape, numpy dtype)}`` of a checkpoint from any
    rank's parts (``utils/checkpoint.load_resharded``'s target)."""
    return {k: (_global_shape(v, row, rows), _np_dtype(v)) for k, v, row, rows in parts}


def shard_layout(parts: list, rank: int) -> tuple:
    """This rank's pieces of a sharded set: ``(entries, layout)``,
    ``entries`` ``{name: tensor or array}`` to snapshot and ``layout``
    ``{name: (entry, global shape, bounds)}``. Rank 0 writes the
    replicated entries whole; every rank writes the rows it owns, and the
    pieces at global bounds it is the writer of (``nd_state_parts``)."""
    entries, layout = {}, {}
    for k, v, row, rows in parts:
        shape = tuple(v.shape)
        if isinstance(row, dict):
            if row["write"]:
                name = f"{k}@{rank}"
                entries[name] = v
                layout[name] = (k, tuple(row["shape"]), [list(b) for b in row["bounds"]])
        elif row is None:
            if rank != 0:
                continue
            entries[k] = v
            layout[k] = (k, shape, [[0, d] for d in shape])
        elif row >= 0:
            name = f"{k}@{row}"
            entries[name] = v.unsqueeze(0) if isinstance(v, torch.Tensor) else np.asarray(v)[None]
            layout[name] = (k, (rows, *shape), [[row, row + 1], *([0, d] for d in shape)])
    return entries, layout


# --------------------------------------------------------------------------
# the dense ND mesh: entries of sharded leaves in the reference's global
# layout
# --------------------------------------------------------------------------


def nd_local_entries(state, layouts: Tree) -> dict:
    """This rank's pieces of every entry of an ND state, in the
    reference's layout: its shard of each leaf, and its residual as one
    row ``[1, ...]`` of its ``.ef`` stack."""
    out = {k: to_reference_layout(t.detach(), lay) for k, t, lay in _state_pairs(state, layouts)}
    if tree_leaves(state.ef):
        lays = _ef_layouts(state.ef, layouts)
        for i, (k, t) in enumerate(_paths(state.ef, ".ef")):
            out[k] = to_reference_layout(t.detach(), lays[i]).unsqueeze(0)
    return out


def nd_state_entries(pieces: list, coords_list: list, spec_of) -> dict:
    """The global entries from the ranks' ``nd_local_entries`` (``pieces``,
    one dict a rank, host tensors, with each rank's ``coords``): a
    replicated entry is the first rank's, a sharded one its pieces joined
    at their bounds. ``spec_of(entry)`` gives each entry's spec."""
    from theanompi_tpu_torch.models.transformer import join_shards, spec_axes

    out = {}
    for k, first in pieces[0].items():
        spec = spec_of(k)
        if not spec_axes(spec):
            out[k] = first
            continue
        out[k] = torch.from_numpy(join_shards([to_numpy(p[k]) for p in pieces], spec,
                                              coords_list))
    return out


def nd_state_parts(state, layouts: Tree, spec_of, coords: dict) -> list:
    """``(entry, tensor, row, rows)`` of every entry this rank holds
    (``state_parts``' form): a replicated entry ``row`` None (rank 0
    writes it), a sharded one ``row`` ``{"shape": global shape,
    "bounds": its [start, stop) a dimension, "write": bool}``, written by
    the rank at index 0 of every axis its spec does not name (a
    tp-sharded leaf by the rank at data 0, seq 0 of its model index; an
    ``.ef`` row by its own rank)."""
    from theanompi_tpu_torch.models.transformer import global_shape, spec_axes, spec_bounds

    parts = []
    for k, v in nd_local_entries(state, layouts).items():
        spec = spec_of(k)
        named = spec_axes(spec)
        if not named:
            parts.append((k, v, None, 1))
            continue
        shape = global_shape(v.shape, spec, coords)
        write = all(i == 0 for a, (i, _) in coords.items() if a not in named)
        parts.append((k, v, {"shape": shape, "bounds": spec_bounds(shape, spec, coords),
                             "write": write}, None))
    return parts


def nd_state_from_flat(flat: dict, template, layouts: Tree, spec_of, coords: dict):
    """An ND state shaped like ``template`` (this rank's shards) from the
    global checkpoint entries: each entry cut to this rank's piece by its
    spec, an ``.ef`` stack to this rank's row. Raises naming the entry on
    a missing key (KeyError) or a wrong shape, an ``.ef`` stack of another
    mesh included (ValueError)."""
    from theanompi_tpu_torch.models.transformer import shard_leaf, spec_axes, spec_bounds

    def cut(k):
        arr = _entry(flat, k)
        spec = spec_of(k)
        if not spec_axes(spec):
            return arr
        try:
            spec_bounds(arr.shape, spec, coords)
        except ValueError as e:
            raise ValueError(f"checkpoint leaf {k!r} of shape {tuple(arr.shape)} does not "
                             f"split over this mesh ({e})") from None
        return shard_leaf(arr, spec, coords)

    leaves = [_restored(cut(k), t, lay, k) for k, t, lay in _state_pairs(template, layouts)]
    lays = _ef_layouts(template.ef, layouts)
    rows = []
    for i, (k, t) in enumerate(_paths(template.ef, ".ef")):
        piece = cut(k)
        if piece.shape[0] != 1:
            raise ValueError(f"checkpoint leaf {k!r} stacks the residuals of "
                             f"{np.shape(flat[k])[0]} ranks, not this mesh's (a resume "
                             "onto another mesh is elastic: --elastic reshards it)")
        rows.append(_restored(piece[0], t, lays[i], k))
    return _rebuilt(template, leaves, rows)
