"""The dense ND LM engine: the dense branch of the reference's
``NDEngine`` (``theanompi_tpu/parallel/nd.py``) over the ``(data, model,
seq)`` mesh.

The reference runs one SPMD program over the mesh ``("data", "model",
"seq")`` of shape ``(dp, tp, sp)`` (the model axis only under ``--tp``,
the seq axis only under ``--sp``). Here each rank is a process on its own
card (``launch/session.py``), at ``(d, t, s)`` of that mesh with ``rank =
(d·tp + t)·sp + s`` (``parallel/mesh.py``: each axis, and each set of
axes, is a process group). Tokens are ``P(data, seq)`` and replicated
over the model axis: rank ``(d, t, s)`` takes rows ``d·B/dp …`` of the
global batch (the training loop gathers them) and columns ``s·T/sp …``
(the step slices them). Params follow the model's specs
(``TransformerLM.tp_param_specs`` under ``--tp``, Megatron's heads, FFN
and vocabulary sharding; else every leaf replicated): every rank draws
the whole tree from the seed, as the reference's ``init`` does, and
keeps its shard; Adam's m and v are sharded like their params. The
forward runs the LM's hooks (``models/transformer.py``: the psums of the
row-parallel products and the vocab-sharded cross-entropy over
``"model"``; the attention scheme of the recipe's ``attn`` over
``"seq"``, on the ``H / tp`` local heads).

Gradient sync: the reference's ``sync_grads_by_spec``
(``models/transformer.py``): each leaf summed over every participating
axis it is not sharded on, divided by the number of ranks of every
participating axis. That is two exchanges: the replicated leaves over
the world, the tp-sharded ones over the ``("data", "seq")`` ranks of
their model index; each one fp32 ``all_reduce`` of its packed leaves.
With a wire codec (``--wire-codec``) each exchange's leaves are
quantized first, each rank's own part, in one codec round, error
feedback in ``NDTrainState.ef``. A leaf whose psum axes span one rank
has no wire (the tp-sharded leaves under pure ``--tp``): it passes
through untouched, no quantization and no residual. The reference
quantizes such a leaf all the same (its data axis of one device counts
as a wire): a loss of precision with nothing sent, which the port does
not copy. The optimizer, the LR schedule and the step counter are
``train.py``'s, as the reference mirrors ``train.make_train_step``. The
loss reported is the mean over the data axis.

Checkpoints keep the reference's global layout: a sharded leaf's entry
is the whole leaf, an ``.ef`` entry the reference's stack ``[prod of the
leaf's psum axes, *its global shape]`` (``bridge.nd_state_entries``,
``nd_state_parts``, ``nd_state_from_flat``), and the topology manifest
stamps each sharded entry's spec (``leaf_specs``).

Refused, as the reference refuses them under ND
(``theanompi_tpu/launch/worker.py``; the training loop checks its
options, this class its own): ``--fused-update`` with an optimizer that
has no fused kernel (the LM recipes' Adam), a fused update with
``clip_norm``, and ``loss_chunk`` under ``--tp`` (which the reference
ignores without a word).

Step fusion (``fused_train_step``): as ``BSPEngine``'s, one captured CUDA
graph of the step on the card with NCCL, the all-reduces, the ring's
point-to-point exchanges and the all-to-alls inside it; the CPU runs
groups eagerly; gloo ranks on the card are refused
(``bsp.check_fused_ranks``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.graphs import StepGraph, eager_steps
from theanompi_tpu_torch.models.transformer import (
    nd_spec_setup,
    psum_axes,
    shard_leaf,
    spec_axes,
    sync_grads_by_spec,
    tree_leaves_specs,
)
from theanompi_tpu_torch.ops.optimizers import apply_updates
from theanompi_tpu_torch.parallel.bsp import check_fused_ranks
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.distributed import gather_tree
from theanompi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    axis_group,
    bind_axes,
    nd_coords,
    nd_shape,
)
from theanompi_tpu_torch.parallel.strategies import mean_across_ranks
from theanompi_tpu_torch.train import _optimizer_for, make_schedule_fn
from theanompi_tpu_torch.tree import digest, tree_leaves, tree_map

Tree = Any


class NDTrainState(NamedTuple):
    """Params (this rank's shards) + optimizer state (sharded like the
    params) + the int32 step counter, and ``ef``: this rank's wire-codec
    residuals (one f32 tensor a param leaf, in its shard's shape; ``()``
    when the codec carries no state), which the checkpoint stacks as the
    reference does (``.ef/<leaf>``, ``[prod of its psum axes, *global
    shape]``). The LM has no model state: ``model_state`` is an empty
    tree, for the training loop's protocol."""

    params: Tree
    opt_state: Tree
    step: torch.Tensor
    ef: Tree = ()

    @property
    def model_state(self) -> dict:
        return {}


class NDEngine:
    """Engine over the dense ``(data, model, seq)`` mesh of ``n_devices``
    ranks with a model axis of ``tp`` and a sequence axis of ``sp``
    (module docstring), with the training loop's protocol
    (``BSPEngine``'s). ``device``: ``None`` is the current CUDA device
    and raises when there is none; ``"cpu"`` runs on the CPU because it
    was asked for."""

    name = "nd"
    exchange_every = 0
    accum_steps = 1

    def __init__(self, model, n_devices: int = 1, device=None, *, tp: int = 1, sp: int = 1,
                 steps_per_epoch: int = 1, wire_codec=None, fused_update: bool = False):
        if not hasattr(model, "arch") or not getattr(model, "is_lm", False):
            raise ValueError(f"NDEngine needs an LM model exposing .arch (models/lm.py); got "
                             f"{type(model).__name__}")
        if fused_update and model.recipe.opt_kwargs.get("clip_norm") is not None:
            raise ValueError(
                "--fused-update clip_norm is not supported on the ND engine: the fused "
                "global-norm clip would be computed over each device's local param shards, "
                "not the global gradient (drop clip_norm)")
        self.device = resolve_device(device)
        self.model = model
        self.arch = model.arch
        self.n = int(n_devices)
        self.dp, self.tp, self.sp = nd_shape(self.n, tp, sp)
        # the reference's axes: data always, model and seq where they have ranks
        self.tp_axis = MODEL_AXIS if self.tp > 1 else None
        self.sp_axis = SEQ_AXIS if self.sp > 1 else None
        self.sizes = {DATA_AXIS: self.dp, MODEL_AXIS: self.tp, SEQ_AXIS: self.sp}
        # the checks of the reference's spec setup and the optimizer's,
        # before any collective
        self.axes, self.n_total, self.specs = nd_spec_setup(
            self.arch, self.sizes, DATA_AXIS, self.tp_axis, self.sp_axis)
        self._spec_l = tree_leaves_specs(self.specs)
        self.optimizer = _optimizer_for(model, fused_update)
        if self.n > 1:
            if not dist.is_initialized() or dist.get_world_size() != self.n:
                have = dist.get_world_size() if dist.is_initialized() else "no process group"
                raise RuntimeError(
                    f"the ND engine over {self.n} devices runs one process per rank in a "
                    f"process group of {self.n} ranks ({have} here): launch it through "
                    "theanompi_tpu_torch.launch.session or the CLI")
            bind_axes(self.n, tp=self.tp, sp=self.sp)
        self.rank = dist.get_rank() if self.n > 1 else 0
        self.dp_index, self.tp_index, self.sp_index = nd_coords(self.rank, self.tp, self.sp)
        self.coords = self._coords(self.rank)
        # one rank has no wire
        self.codec = get_codec(wire_codec) if self.n > 1 else get_codec(None)
        self.schedule_lr = make_schedule_fn(model, steps_per_epoch)
        self.graph = None  # the captured step, made by the first fused group on the card
        self._path_spec: dict = {}  # "/blocks/0/qkv" -> spec, made with the state

    def _coords(self, rank: int) -> dict:
        """``{axis: (index, size)}`` of ``rank`` on the mesh."""
        index = nd_coords(rank, self.tp, self.sp)
        return {a: (i, self.sizes[a]) for a, i in zip((DATA_AXIS, MODEL_AXIS, SEQ_AXIS), index)}

    # -- the step ----------------------------------------------------------

    def local_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's columns ``s·T/sp …`` of its rows' token windows."""
        T = tokens.shape[1]
        if T % self.sp:
            raise ValueError(f"sequence length {T} not divisible by --sp {self.sp}")
        t = T // self.sp
        return tokens[:, self.sp_index * t:(self.sp_index + 1) * t]

    def _data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axis (the reference's ``pmean`` of the
        loss over the batch axes): the global batch's mean loss."""
        if self.n == 1 or self.dp == 1:
            return x
        group, _ = axis_group(DATA_AXIS)
        return mean_across_ranks([x], self.dp, group)[0]

    def _loss(self, params, tokens):
        return self.arch.loss(params, self.local_tokens(tokens), self.sp_axis,
                              tp_axis=self.tp_axis)

    def train_step(self, state: NDTrainState, tokens, labels, gen):
        """One step -> ``(state, {"loss", "lr"})``; params and the
        optimizer state are written in place where the optimizer does."""
        del labels, gen  # labels ARE the tokens; the LM draws no dropout
        params = state.params
        leaves = tree_leaves(params)
        loss = self._loss(params, tokens)
        it = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            # each rank's own part quantized before the sums, where a codec is set
            grads, new_ef = sync_grads_by_spec(
                grads, self.specs, self.axes, self.n_total, self.model.param_layouts(grads),
                self.codec, state.ef, sizes=self.sizes)
            loss = self._data_mean(loss.detach())
            lr = self.schedule_lr(state.step)
            if self.optimizer.apply is not None:
                _, new_opt = self.optimizer.apply(grads, state.opt_state, params, lr)
            else:
                updates, new_opt = self.optimizer.update(grads, state.opt_state, params, lr)
                apply_updates(params, updates)
        return NDTrainState(params, new_opt, state.step + 1, new_ef), {"loss": loss, "lr": lr}

    def fused_train_step(self, state, tokens, labels, gen, after_step=None):
        """``len(tokens)`` steps in one call -> ``(state, metrics)``, each
        metric an fp32 vector over the group: on the card the steps
        replay one captured graph, on the CPU they run eagerly."""
        check_fused_ranks(self.n, max(2, len(tokens)), self.device,
                          dist.get_backend() if self.n > 1 else None)
        if self.device.type == "cuda":
            if self.graph is None:
                self.graph = StepGraph(self.train_step, self.device)
            return self.graph.run(state, tokens, labels, gen, after_step)
        return eager_steps(self.train_step, state, tokens, labels, gen, self.device, after_step)

    def eval_step(self, state: NDTrainState, tokens, labels) -> dict:
        """``{"loss"}`` of a validation batch, the mean over the data axis."""
        del labels
        with torch.no_grad():
            loss = self._loss(state.params, tokens)
        return {"loss": self._data_mean(loss)}

    # -- state and the training loop's protocol ------------------------------

    def _shard(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        """This rank's shard of a whole leaf (the leaf itself when it is
        replicated), a new contiguous tensor that keeps ``requires_grad``."""
        if not spec_axes(spec):
            return leaf
        with torch.no_grad():
            piece = shard_leaf(leaf.detach(), spec, self.coords).contiguous().clone()
        return piece.requires_grad_(leaf.requires_grad)

    def init_state(self, gen: torch.Generator) -> NDTrainState:
        """The whole params from ``gen`` (every rank draws the same, from
        the same seed), this rank's shards kept; the optimizer's state of
        the shards, step 0, and with error feedback this rank's zero
        residuals."""
        whole, _ = self.model.init(gen, self.device)
        it = iter(self._spec_l)
        params = tree_map(lambda p: self._shard(p, next(it)), whole)
        del whole
        self._path_spec = {path: spec for (path, _), spec
                           in zip(bridge._paths(params, ""), self._spec_l)}
        with torch.no_grad():
            opt_state = self.optimizer.init(params)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return NDTrainState(params, opt_state, step, self.codec.init_ef(params))

    def get_step(self, state) -> int:
        """The device step counter, read back (a host sync)."""
        return int(state.step.item())

    def replica(self, state):
        """This rank's state: its shards and the replicated leaves."""
        return state

    def entry_spec(self, key: str) -> tuple:
        """The spec of a checkpoint entry in the reference's global
        layout: a param and its Adam moments or velocity the param's, an
        ``.ef`` stack ``(its psum axes, *the param's)`` (the reference's
        ``P(psum_axes or None, *spec)``), anything else replicated
        ``()``."""
        if key.startswith(".ef/"):
            spec = self._path_spec[key[len(".ef"):]]
            return (psum_axes(spec, self.axes) or None, *spec)
        if key.startswith(".params/"):
            return self._path_spec[key[len(".params"):]]
        parts = key.split("/", 2)  # .opt_state/<m, v or vel>/<param path>
        if parts[0] == ".opt_state" and len(parts) == 3:
            return self._path_spec.get("/" + parts[2], ())
        return ()

    def leaf_specs(self, state, layouts) -> dict:
        """``{entry: spec}`` of every entry of a checkpoint of ``state``,
        each in the reference's ``spec_to_json`` form (a list of one item
        a dimension: None or the list of its axes), a replicated entry
        None: the per-leaf specs of the topology manifest."""
        out = {}
        for k in bridge.nd_local_entries(state, layouts):
            spec = self.entry_spec(k)
            out[k] = ([None if e is None else list(spec_axes((e,))) for e in spec]
                      if spec_axes(spec) else None)
        return out

    def _owners(self) -> list:
        """The ranks a gathered save reads: every rank where each holds its
        own residuals, else the ranks at data 0, seq 0 (one a model
        index)."""
        if self.codec.active and self.codec.error_feedback:
            return list(range(self.n))
        return [t * self.sp for t in range(self.tp)]

    def state_entries(self, state, layouts):
        """Rank 0: the checkpoint's entries of ``state`` in the
        reference's global layout (sharded leaves joined, every rank's
        residuals stacked as ``.ef``); None on the other ranks.
        Collective."""
        local = bridge.nd_local_entries(state, layouts)
        if self.n == 1:
            return local
        ranks = self._owners()
        got = gather_tree(local, self.n, ranks)
        if self.rank != 0:
            return None
        return bridge.nd_state_entries(got, [self._coords(r) for r in ranks], self.entry_spec)

    def restore(self, flat: dict, template, layouts):
        """This rank's state from the global checkpoint entries (its
        shards, its residual row)."""
        return bridge.nd_state_from_flat(flat, template, layouts, self.entry_spec, self.coords)

    def checkpoint_parts(self, state, layouts) -> list:
        """``bridge.nd_state_parts`` of this rank (no collective)."""
        return bridge.nd_state_parts(state, layouts, self.entry_spec, self.coords)

    def mesh_topology(self) -> dict:
        """The reference's ``mesh_topology`` of its dense ND mesh: the data
        axis always (``launch/worker.py`` builds it so), the model axis
        under ``--tp``, the seq axis under ``--sp``."""
        axes = [DATA_AXIS] + [a for a in (MODEL_AXIS, SEQ_AXIS) if self.sizes[a] > 1]
        return {"shape": [self.sizes[a] for a in axes], "axes": axes}

    def stack_axes(self) -> list:
        """The mesh axes a replicated leaf's ``.ef`` stack runs over."""
        return list(self.axes)

    def elastic_spec(self) -> dict:
        """Per-leaf reshard policies of the topology manifest (the
        reference's ``NDEngine.elastic_spec``): params and optimizer
        accumulators keep their global shapes on any mesh; the residual
        stacks belong to each rank's quantization history: ``reset``."""
        return {"policies": {".ef": {"policy": "reset"}}}

    def summary_fields(self, batch: int) -> dict:
        """The run summary's fields of the engine."""
        T = self.model.recipe.input_shape[0]
        return {"slices": 1, "dp": self.dp, "tp": self.tp, "sp": self.sp,
                "attn": self.arch.attn, "tokens_per_step": batch * T,
                "digests": "replica_digest: equal on the ranks of one tp_index; "
                           "replicated_digest: equal on every rank"}

    def _replicated(self, tree) -> list:
        """The leaves of a param-shaped tree that no axis shards."""
        return [x for x, spec in zip(tree_leaves(tree), self._spec_l) if not spec_axes(spec)]

    def rank_summary(self, state) -> dict:
        """This rank's digests: ``replica_digest`` of its shards and
        replicated leaves (params and optimizer state), equal bit for bit
        on the ranks of one model index; ``replicated_digest`` of the
        replicated leaves alone, equal on every rank. ``ef_unwired_norm``:
        the norm of the residuals of the leaves with no wire, which no
        codec round touches (0)."""
        opt = state.opt_state
        rep = self._replicated(state.params)
        if isinstance(opt, dict):
            for k in sorted(opt):
                rep += [opt[k]] if isinstance(opt[k], torch.Tensor) else self._replicated(opt[k])
        unwired = [r for r, spec in zip(tree_leaves(state.ef), self._spec_l)
                   if math.prod(self.sizes[a] for a in psum_axes(spec, self.axes)) == 1]
        return {"replica_digest": digest(tree_leaves((state.params, state.opt_state))),
                "replicated_digest": digest(rep), "tp_index": self.tp_index,
                "ef_unwired_norm": float(sum(torch.sum(r.double() ** 2) for r in unwired)) ** 0.5}
