"""The sequence-parallel LM engine: the dense branch of the reference's
``NDEngine`` (``theanompi_tpu/parallel/nd.py``) over a ``(data, seq)``
mesh.

The reference runs one SPMD program over the mesh ``("data", "seq")`` of
shape ``(dp, sp)``. Here each rank is a process on its own card
(``launch/session.py``), at ``(rank // sp, rank % sp)`` of that mesh
(``parallel/mesh.py``: ``"seq"`` is its row's process group, ``"data"``
its column's). Tokens are ``P(data, seq)``: rank ``(d, s)`` takes rows
``d·B/dp …`` of the global batch (the training loop gathers them) and
columns ``s·T/sp …`` (the step slices them). The forward runs the LM's
sequence-parallel hooks (``models/transformer.py``: the attention scheme
of the recipe's ``attn`` over ``"seq"``, global positions, the boundary
targets and the loss summed over the axis). Every leaf is replicated, so
the gradient sync is the reference's ``sync_grads_by_spec`` for
replicated leaves: BSP's ``psum`` exchange over every rank
(``parallel/strategies.py``: one fp32 ``all_reduce`` of the packed
gradients times ``fl(1/n)``), through the wire codec (``--wire-codec``:
each rank's contribution quantized first, error feedback in
``NDTrainState.ef``) where one is set. The optimizer, the LR
schedule and the step counter are ``train.py``'s, as the reference
mirrors ``train.make_train_step``. The loss reported is the mean over
the data axis.

Refused, as the reference refuses them under ND
(``theanompi_tpu/launch/worker.py``; the training loop checks its
options, this class its own): ``--fused-update`` with an optimizer that
has no fused kernel (the LM recipes' Adam), and a fused update with
``clip_norm``.

Step fusion (``fused_train_step``): as ``BSPEngine``'s, one captured CUDA
graph of the step on the card with NCCL, the ring's point-to-point
exchanges and the all-to-alls inside it; the CPU runs groups eagerly;
gloo ranks on the card are refused (``bsp.check_fused_ranks``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.graphs import StepGraph, eager_steps
from theanompi_tpu_torch.models.transformer import nd_spec_setup
from theanompi_tpu_torch.ops.optimizers import apply_updates
from theanompi_tpu_torch.parallel.bsp import check_fused_ranks
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.distributed import gather_tree
from theanompi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    axis_group,
    bind_axes,
    nd_shape,
)
from theanompi_tpu_torch.parallel.strategies import get_strategy, mean_across_ranks
from theanompi_tpu_torch.train import _optimizer_for, make_schedule_fn
from theanompi_tpu_torch.tree import digest, tree_leaves, tree_map

Tree = Any


class NDTrainState(NamedTuple):
    """Params + optimizer state + the int32 step counter, and ``ef``:
    this rank's wire-codec residuals (one f32 tensor a param leaf; ``()``
    when the codec carries no state), which the checkpoint stacks over
    every rank (``.ef/<leaf>``, ``[dp·sp, ...]`` in rank order, the
    reference's stack over the leaf's psum axes). The LM has no model
    state: ``model_state`` is an empty tree, for the training loop's
    protocol."""

    params: Tree
    opt_state: Tree
    step: torch.Tensor
    ef: Tree = ()

    @property
    def model_state(self) -> dict:
        return {}


class NDEngine:
    """Engine over the dense ``(data, seq)`` mesh of ``n_devices`` ranks
    with a sequence axis of ``sp`` (module docstring), with the training
    loop's protocol (``BSPEngine``'s). ``device``: ``None`` is the
    current CUDA device and raises when there is none; ``"cpu"`` runs on
    the CPU because it was asked for."""

    name = "nd"
    exchange_every = 0
    accum_steps = 1

    def __init__(self, model, n_devices: int = 1, device=None, *, sp: int = 1,
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
        self.dp, self.sp = nd_shape(self.n, sp)
        # the checks of the reference's spec setup and the optimizer's,
        # before any collective
        self.axes, self.n_total = nd_spec_setup(self.arch, {DATA_AXIS: self.dp, SEQ_AXIS: self.sp},
                                                DATA_AXIS, SEQ_AXIS)
        self.optimizer = _optimizer_for(model, fused_update)
        if self.n > 1:
            if not dist.is_initialized() or dist.get_world_size() != self.n:
                have = dist.get_world_size() if dist.is_initialized() else "no process group"
                raise RuntimeError(
                    f"the ND engine over {self.n} devices runs one process per rank in a "
                    f"process group of {self.n} ranks ({have} here): launch it through "
                    "theanompi_tpu_torch.launch.session or the CLI")
            bind_axes(self.n, sp=self.sp)
        self.rank = dist.get_rank() if self.n > 1 else 0
        self.dp_index, self.sp_index = divmod(self.rank, self.sp)
        # one rank has no sequence axis to bind, and no wire
        self.sp_axis = SEQ_AXIS if self.n > 1 else None
        self.codec = get_codec(wire_codec) if self.n > 1 else get_codec(None)
        # the reference's sync_grads_by_spec for replicated leaves: each
        # gradient summed over every rank, divided by their number
        self.grad_sync = get_strategy("psum", self.n_total, codec=self.codec,
                                      layouts=model.param_layouts)
        self.schedule_lr = make_schedule_fn(model, steps_per_epoch)
        self.graph = None  # the captured step, made by the first fused group on the card

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

    def train_step(self, state: NDTrainState, tokens, labels, gen):
        """One step -> ``(state, {"loss", "lr"})``; params and the
        optimizer state are written in place where the optimizer does."""
        del labels, gen  # labels ARE the tokens; the LM draws no dropout
        params = state.params
        leaves = tree_leaves(params)
        loss = self.arch.loss(params, self.local_tokens(tokens), self.sp_axis)
        it = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            new_ef = state.ef
            if self.codec.active:  # each rank's own part quantized before the sum
                grads, new_ef = self.grad_sync(grads, state.ef)
            else:
                grads = self.grad_sync(grads)
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
            loss = self.arch.loss(state.params, self.local_tokens(tokens), self.sp_axis)
        return {"loss": self._data_mean(loss)}

    # -- state and the training loop's protocol ------------------------------

    def init_state(self, gen: torch.Generator) -> NDTrainState:
        """Params from ``gen`` (every rank draws the same, from the same
        seed), the optimizer's state, step 0, and with error feedback this
        rank's zero residuals."""
        params, _ = self.model.init(gen, self.device)
        with torch.no_grad():
            opt_state = self.optimizer.init(params)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return NDTrainState(params, opt_state, step, self.codec.init_ef(params))

    def get_step(self, state) -> int:
        """The device step counter, read back (a host sync)."""
        return int(state.step.item())

    def replica(self, state):
        """This rank's replica: the whole state (every leaf replicated)."""
        return state

    def state_entries(self, state, layouts):
        """Rank 0: the checkpoint's entries of ``state`` in the
        reference's layout, every rank's residuals stacked as ``.ef``;
        None on the other ranks. Collective."""
        ef_ranks = gather_tree(state.ef, self.n) if tree_leaves(state.ef) else None
        return bridge.state_entries(state, layouts, ef_ranks) if self.rank == 0 else None

    def restore(self, flat: dict, template, layouts):
        """This rank's state from checkpoint entries (its residual row)."""
        return bridge.state_from_flat(flat, template, layouts, rank=self.rank, world=self.n)

    def checkpoint_parts(self, state, layouts) -> list:
        """``bridge.state_parts`` of this rank (no collective)."""
        return bridge.state_parts(state, layouts, self.rank, self.n)

    def mesh_topology(self) -> dict:
        """The reference's ``mesh_topology`` of its dense ND mesh: shape
        ``(dp, sp)``, axes ``("data", "seq")``, the data axis named even
        at ``dp = 1`` (``launch/worker.py`` builds it so)."""
        return {"shape": [self.dp, self.sp], "axes": [DATA_AXIS, SEQ_AXIS]}

    def stack_axes(self) -> list:
        """The mesh axes the ``.ef`` stacks run over (every rank)."""
        return [DATA_AXIS, SEQ_AXIS]

    def elastic_spec(self) -> dict:
        """Per-leaf reshard policies of the topology manifest (the
        reference's ``NDEngine.elastic_spec``): params and optimizer
        accumulators keep their global shapes on any mesh; the residual
        stacks belong to each rank's quantization history: ``reset``."""
        return {"policies": {".ef": {"policy": "reset"}}}

    def summary_fields(self, batch: int) -> dict:
        """The run summary's fields of the engine."""
        T = self.model.recipe.input_shape[0]
        return {"slices": 1, "dp": self.dp, "sp": self.sp, "attn": self.arch.attn,
                "tokens_per_step": batch * T}

    def rank_summary(self, state) -> dict:
        """This rank's digest of its replica, equal on every rank when the
        replicas agree bit for bit."""
        return {"replica_digest": digest(tree_leaves((state.params, state.opt_state)))}
