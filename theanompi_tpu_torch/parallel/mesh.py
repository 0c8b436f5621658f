"""Rank, world and mesh-axis helpers of data-parallel BSP (port of the
parts of ``theanompi_tpu/parallel/mesh.py`` the one-process-per-card
model needs).

The reference runs one SPMD program over a ``("data",)`` mesh, or over a
``("dcn", "data")`` mesh under ``--slices r`` (``make_multislice_mesh``:
rows are slices, so ranks ``s·i … s·i+s−1`` form slice ``i``). Here each
rank is a process on its own card, so a mesh position is the rank, and a
mesh axis is a ``torch.distributed`` process group: :class:`AxisGroups`
maps each axis name to the group of this rank along it.

- flat run: ``"data"`` is the whole world;
- ``--slices r`` over ``n = r·s`` ranks: ``"data"`` is this rank's slice
  (``s`` ranks), ``"dcn"`` the ranks at its position in every slice
  (``r`` ranks), ``("dcn", "data")`` the world;
- EASGD / GoSGD worker groups of ``g`` ranks (``--group-size``, the
  reference's ``make_worker_group_mesh``): ranks ``w·g … w·g+g−1`` are
  worker ``w`` and its ``"data"`` axis, ``"worker"`` the ranks at the
  same position in every group (one a worker), ``("worker", "data")``
  the world. ``--slices`` only validates that no group straddles a
  slice (:func:`worker_groups`); the rules' mesh has no ``"dcn"`` axis;
- the dense ND mesh over ``n = dp·tp·sp`` ranks (``--tp``, ``--sp``:
  the reference's ``("data", "model", "seq")`` mesh of shape ``(dp, tp,
  sp)``, seq innermost, then model, then data): rank ``r = (d·tp +
  t)·sp + s`` sits at ``(d, t, s)`` (:func:`nd_coords`). ``"seq"`` is
  the ``sp`` ranks of fixed ``(d, t)``, ``"model"`` the ``tp`` ranks of
  fixed ``(d, s)``, ``"data"`` the ``dp`` ranks of fixed ``(t, s)``,
  ``("data", "seq")`` the ranks of fixed ``t`` (the sync of the leaves
  sharded on the model axis) and ``("data", "model", "seq")`` the world;
  every combination of the three is keyed, in mesh order. An axis of
  one rank has no group, and a rank's index along it is 0.

The groups of a run are bound to the process (:func:`bind_axes`, which
``BSPEngine`` calls), as ``torch.distributed``'s default group is:
a collective inside a layer (cross-replica BatchNorm) finds its group by
the axis name (:func:`axis_group`). Outside a bound run, on one rank, an
axis name is unbound and raises ``NameError``, as the reference's
``lax.pmean`` does outside ``shard_map`` (its one-device BSP step runs
without one).
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DCN_AXIS = "dcn"
WORKER_AXIS = "worker"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
ND_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)  # the dense ND mesh's, in mesh order


def inv_f32(n: int) -> float:
    """fl(1/n) in f32, exactly representable as a Python float: the
    reference divides by the constant n, which XLA compiles into a
    multiply by this (exact for n a power of two)."""
    return float(np.float32(1.0 / n))


def host_local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """The rows ``[r·B/n, (r+1)·B/n)`` of the global batch that rank
    ``r`` of ``n`` reads — the reference's shard of the ``data`` axis
    (of both axes, slice-major, under ``--slices``)."""
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} does not split evenly over {world} ranks"
        )
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The rank's own random stream (dropout masks), seeded from
    ``(seed, rank)`` — the counterpart of the reference's
    ``fold_linear_index``, which folds the device's mesh index into the
    key. Its bits cannot match ``jax.random``'s."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)


def slice_topology(world: int, n_slices: Optional[int]) -> tuple:
    """``(n_slices, per_slice)`` of ``world`` ranks (one slice without
    ``n_slices``); raises unless the slices divide the world."""
    r = int(n_slices or 1)
    if r < 1 or world % r:
        raise ValueError(f"{world} ranks do not divide into {r} slices")
    return r, world // r


def worker_groups(world: int, group_size: int = 1, n_slices: Optional[int] = None) -> tuple:
    """``(n_workers, group_size)`` of an EASGD / GoSGD run of ``world``
    ranks, with the reference's checks (``make_worker_group_mesh``): the
    groups must divide the ranks, the slices too, and no group may
    straddle a slice (its every-step gradient psum would cross it)."""
    g = max(1, int(group_size or 1))
    if world % g:
        raise ValueError(f"{world} devices do not divide into groups of {g}")
    if n_slices is not None and n_slices > 1 and world % n_slices:
        raise ValueError(f"{world} devices do not divide into {n_slices} slices")
    if g > 1 and n_slices is not None and n_slices > 1:
        per = world // n_slices
        for w in range(world // g):
            row = {(w * g + i) // per for i in range(g)}
            if len(row) > 1:
                raise ValueError(
                    f"worker group {w} would span slices {sorted(row)}: group_size {g} must "
                    f"divide the per-slice chip count ({world} devices / {n_slices} slices)")
    return world // g, g


def _axis_key(name):
    if isinstance(name, (tuple, list)):
        name = tuple(name)
        return name[0] if len(name) == 1 else name
    return name


def nd_shape(world: int, tp: int = 1, sp: int = 1) -> tuple:
    """``(dp, tp, sp)`` of the dense ND mesh of ``world`` ranks with a
    model axis of ``tp`` and a sequence axis of ``sp``; raises unless
    ``tp · sp`` divides the ranks (the reference's message)."""
    tp, sp = int(tp), int(sp)
    if tp < 1 or sp < 1 or world % (tp * sp):
        raise ValueError(f"{world} devices do not divide --tp {tp} x --sp {sp}")
    return world // (tp * sp), tp, sp


def nd_coords(rank: int, tp: int, sp: int) -> tuple:
    """``(d, t, s)`` of ``rank`` on the dense ND mesh: ``rank = (d·tp +
    t)·sp + s``."""
    ds, s = divmod(int(rank), sp)
    d, t = divmod(ds, tp)
    return d, t, s


def _nd_partition(axes: tuple, dp: int, tp: int, sp: int) -> list:
    """The groups of ranks along ``axes`` (a subset of ``ND_AXES``) of the
    ``(dp, tp, sp)`` mesh: ranks that differ only on those axes, each
    group in rank order, the groups in the order of their first rank."""
    groups: dict = {}
    for r in range(dp * tp * sp):
        coords = dict(zip(ND_AXES, nd_coords(r, tp, sp)))
        key = tuple(coords[a] for a in ND_AXES if a not in axes)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


class AxisGroups:
    """This rank's process group and size along each mesh axis of a run
    of ``world`` ranks in ``n_slices`` slices, in worker groups of
    ``group_size`` ranks (EASGD / GoSGD), or, given ``tp`` or ``sp``, on
    the ``(dp, tp, sp)`` dense ND mesh (module docstring; an axis of one
    rank maps to ``(None, 1)``). Every rank must build it, in the same
    order (``dist.new_group`` is collective over the world)."""

    def __init__(self, world: int, n_slices: Optional[int] = None, group_size: int = 1,
                 sp: Optional[int] = None, tp: Optional[int] = None):
        if not dist.is_initialized() or dist.get_world_size() != world:
            have = dist.get_world_size() if dist.is_initialized() else "no process group"
            raise RuntimeError(f"mesh axes over {world} ranks need a process group of "
                               f"{world} ranks ({have} here)")
        self.world_group = dist.group.WORLD
        rank = dist.get_rank()
        if sp is not None or tp is not None:
            shape = nd_shape(world, tp or 1, sp or 1)
            self.groups = {}
            made: dict = {}  # one process group for each distinct partition
            for k in range(1, 4):
                for axes in itertools.combinations(ND_AXES, k):
                    part = _nd_partition(axes, *shape)
                    n = len(part[0])
                    key = tuple(map(tuple, part))
                    if key not in made:
                        if n == 1:
                            made[key] = None
                        elif n == world:
                            made[key] = self.world_group
                        else:  # every rank creates every group, in one order
                            grps = [dist.new_group(g) for g in part]
                            made[key] = grps[[rank in g for g in part].index(True)]
                    self.groups[_axis_key(axes)] = (made[key], n)
            return
        g = int(group_size or 1)
        if g > 1:
            n_workers, g = worker_groups(world, g)
            data = worker = None
            for w in range(n_workers):  # every rank creates every group, in one order
                grp = dist.new_group(list(range(w * g, w * g + g)))
                data = grp if rank // g == w else data
            for d in range(g):
                grp = dist.new_group(list(range(d, world, g)))
                worker = grp if rank % g == d else worker
            self.groups = {DATA_AXIS: (data, g), WORKER_AXIS: (worker, n_workers),
                           (WORKER_AXIS, DATA_AXIS): (self.world_group, world)}
            return
        self.topology = r, s = slice_topology(world, n_slices)
        if r == 1:
            self.groups = {DATA_AXIS: (self.world_group, world)}
            return
        ici = dcn = None
        for i in range(r):  # every rank creates every group, in one order
            g = dist.new_group(list(range(s * i, s * i + s)))
            ici = g if rank // s == i else ici
        for j in range(s):
            g = dist.new_group(list(range(j, world, s)))
            dcn = g if rank % s == j else dcn
        self.groups = {DATA_AXIS: (ici, s), DCN_AXIS: (dcn, r),
                       (DCN_AXIS, DATA_AXIS): (self.world_group, world)}

    def __getitem__(self, name) -> tuple:
        key = _axis_key(name)
        try:
            return self.groups[key]
        except (KeyError, TypeError):
            raise NameError(
                f"unknown mesh axis name {name!r}; this run's axes are "
                f"{sorted(map(str, self.groups))}") from None


_GROUPS: dict = {}  # (n_slices, per_slice, group_size) or ("nd", dp, tp, sp) -> AxisGroups
_BOUND: Optional[AxisGroups] = None  # the run's, which axis_group reads


def bind_axes(world: int, n_slices: Optional[int] = None, group_size: int = 1,
              sp: Optional[int] = None, tp: Optional[int] = None) -> AxisGroups:
    """Bind the mesh axes of a run of ``world`` ranks in ``n_slices``
    slices (or in worker groups of ``group_size``, or, given ``tp`` or
    ``sp``, on the ``(dp, tp, sp)`` dense ND mesh) to this process,
    building its groups the first time (every rank calls it, in the same
    order); returns them."""
    global _BOUND
    g = int(group_size or 1)
    nd = sp is not None or tp is not None
    if nd:
        key = ("nd", *nd_shape(world, tp or 1, sp or 1))
    else:
        key = (*((1, world) if g > 1 else slice_topology(world, n_slices)), g)
    axes = _GROUPS.get(key)
    if axes is None or axes.world_group is not dist.group.WORLD:
        axes = _GROUPS[key] = AxisGroups(world, None if g > 1 or nd else n_slices, g, sp, tp)
    _BOUND = axes
    return axes


def axis_group(name) -> tuple:
    """``(group, size)`` of this rank along the mesh axis ``name`` (or a
    tuple of names) of the bound run; ``NameError`` when no run of
    several ranks is bound (one rank, as the reference's unbound
    ``pmean``) or the run has no such axis."""
    if _BOUND is None or not dist.is_initialized() or _BOUND.world_group is not dist.group.WORLD:
        raise NameError(
            f"unbound axis name: {name!r} — a cross-replica collective needs a BSP run of "
            "several ranks (the reference's one-device step has no mapped axis either)")
    return _BOUND[name]


class _AllReduceMean(torch.autograd.Function):
    """``pmean`` over a group, whose transpose is a ``pmean`` of the
    cotangent: each rank's backward then carries the other ranks'
    dependence on its input, as the reference's ``psum`` transpose does
    (``theanompi_tpu/train.py``: classic pmap AD), and the exchange's
    mean of the ranks' gradients is the gradient of the mean loss."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y * inv_f32(n)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g * inv_f32(ctx.n), None, None


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the mesh axis ``axis_name``
    (one ``all_reduce``), differentiable (:class:`_AllReduceMean`)."""
    group, n = axis_group(axis_name)
    return _AllReduceMean.apply(x, group, n)


def axis_index(name) -> int:
    """This rank's position along the mesh axis ``name`` of the bound run
    (the reference's ``lax.axis_index``; 0 on an axis of one rank)."""
    group, n = axis_group(name)
    return 0 if n == 1 else dist.get_rank(group)


# --------------------------------------------------------------------------
# the reference's collectives over one axis, differentiable
# --------------------------------------------------------------------------


def _staged(t: torch.Tensor) -> bool:
    """gloo moves host memory only in its point-to-point ops (a CUDA
    tensor aborts the process in its socket write); its all-to-all is
    staged the same way."""
    return t.is_cuda and dist.get_backend() == "gloo"


class PendingHop:
    """A posted exchange of :func:`post_hop`: ``wait()`` returns the
    received tensors, on the device they were sent from."""

    def __init__(self, works, recvs, devices):
        self._works, self._recvs, self._devices = works, recvs, devices

    def wait(self) -> list:
        for work in self._works:
            work.wait()
        return [r.to(d) if r.device != d else r for r, d in zip(self._recvs, self._devices)]


def post_hop(sends, n: int, shift: int = 1, group=None) -> PendingHop:
    """Post one batched point-to-point exchange: each tensor of ``sends``
    to the rank ``shift`` ahead among the ``n`` ranks of ``group``
    (``None``: the world; positions are ranks within the group), a tensor
    of the same shape received from the rank ``shift`` behind for each.
    Returns at once; the sends must not change until ``wait()``. Under
    gloo a card's tensors go through the host (``_staged``). Every rank
    posts its exchanges in the same order, which keeps the pairs of
    NCCL's sends and receives matched (at ``n = 2`` both peers are one
    rank)."""
    me = dist.get_rank(group) if group is not None else dist.get_rank()

    def peer(pos):  # a group position -> the global rank P2POp takes
        return dist.get_global_rank(group, pos) if group is not None else pos

    to, frm = peer((me + shift) % n), peer((me - shift) % n)
    ops, recvs, devices = [], [], []
    for t in sends:
        out = t.contiguous().cpu() if _staged(t) else t.contiguous()
        recv = torch.empty_like(out)
        ops += [dist.P2POp(dist.isend, out, to, group=group),
                dist.P2POp(dist.irecv, recv, frm, group=group)]
        recvs.append(recv)
        devices.append(t.device)
    return PendingHop(dist.batch_isend_irecv(ops), recvs, devices)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` by ``shift`` over ``n`` ranks of ``group``: one
    batched exchange; its transpose is the opposite shift."""

    @staticmethod
    def forward(ctx, x, group, n, shift):
        ctx.group, ctx.n, ctx.shift = group, n, shift
        return post_hop([x.detach()], n, shift, group).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return post_hop([g], ctx.n, -ctx.shift, ctx.group).wait()[0], None, None, None


def ppermute(x: torch.Tensor, axis_name, shift: int = 1) -> torch.Tensor:
    """``x`` of the rank ``shift`` behind along ``axis_name`` (each rank
    sends its own ``shift`` ahead), differentiable."""
    group, n = axis_group(axis_name)
    if n == 1:
        return x
    return _PPermute.apply(x, group, n, int(shift))


def _all_to_all(x: torch.Tensor, group, n: int, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled ``lax.all_to_all``: ``x`` cut into ``n`` blocks along
    ``split_dim``, block ``j`` sent to rank ``j``; the blocks received are
    joined along ``concat_dim`` in rank order. One ``all_to_all_single``
    over a contiguous ``[n, ...]`` stack of the blocks."""
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"into {n} blocks")
    stack = torch.stack(x.chunk(n, dim=split_dim))
    staged = _staged(stack)
    send = stack.cpu() if staged else stack.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """Tiled ``lax.all_to_all``; its transpose is the inverse all-to-all
    (split and concat dims swapped)."""

    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _all_to_all(x.detach(), group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, axis_name, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all over ``axis_name`` (``_all_to_all``), differentiable."""
    group, n = axis_group(axis_name)
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, split_dim, concat_dim)


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over a group, whose transpose is a ``psum`` of the
    cotangent (the reference's, under ``check_vma=False``): each rank's
    backward then carries every rank's dependence on its input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis_name``, differentiable
    (:class:`_AllReduceSum`)."""
    group, n = axis_group(axis_name)
    if n == 1:
        return x
    return _AllReduceSum.apply(x, group)


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis_name``,
    with no gradient: the reference's ``lax.pmax`` of a
    ``stop_gradient`` (its vocab-sharded cross-entropy's stabilizer). One
    ``all_reduce(MAX)`` on both backends."""
    group, n = axis_group(axis_name)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if n > 1:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y
