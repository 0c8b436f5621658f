"""BSP data-parallel training engine (port of ``theanompi_tpu/parallel/bsp.py``).

The reference compiles forward, backward, the gradient exchange and the
update into one SPMD program over a ``("data",)`` mesh, or a ``("dcn",
"data")`` mesh under ``--slices``. Here every rank is a process on its
own card (``launch/session.py`` spawns them), in a ``torch.distributed``
process group whose mesh axes ``parallel/mesh.py`` binds: each rank runs
forward and backward on its shard of the global batch, the exchange
(``parallel/strategies.py``: ``psum``, the rings, ``hier`` over the
slices, optionally through a wire codec and in buckets posted from the
backward with ``allreduce_buckets``) turns its gradients into the mean
over ranks, and every rank applies the same update, so the replicas
stay identical. BatchNorm with an ``axis_name`` (``Recipe.bn_axis_name``)
averages its batch statistics across the ranks of that axis inside the
step. Metrics and model state (BN statistics) are averaged across all
ranks after the step, as the reference's ``pmean``.

``n_devices == 1`` keeps the reference's shortcut: no collective and no
codec — the step is exactly ``train.make_train_step`` (the strategy,
codec and bucket arguments are still validated).

Step fusion (``fused_train_step``, the CLI's ``--steps-per-dispatch``):
a group of steps replays one captured CUDA graph of the step on the card
(``graphs.StepGraph``), the ranks' NCCL collectives inside it (every
communicator meets its first collective in the graph's eager warm-up
step), or runs eagerly on the CPU. gloo ranks on the card are refused
(``check_fused_ranks``): gloo's CUDA collectives cannot be captured.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.graphs import StepGraph, eager_steps
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.distributed import gather_tree
from theanompi_tpu_torch.parallel.mesh import bind_axes, slice_topology
from theanompi_tpu_torch.parallel.strategies import (
    bucketed,
    get_strategy,
    hier_ef_template,
    mean_across_ranks,
)
from theanompi_tpu_torch.train import (
    TrainState,
    _optimizer_for,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from theanompi_tpu_torch.tree import digest, tree_leaves


def check_fused_ranks(n_devices: int, steps_per_dispatch: int, device, backend=None) -> None:
    """Refuse captured groups of steps over several gloo ranks on the
    card: gloo runs a CUDA tensor's collective through host copies on
    its own threads, which a CUDA graph cannot capture. NCCL ranks, one
    rank, and the CPU (eager groups) may group."""
    if n_devices > 1 and steps_per_dispatch > 1 and torch.device(device).type == "cuda" \
            and backend == "gloo":
        raise ValueError(
            f"steps_per_dispatch={steps_per_dispatch} with {n_devices} gloo ranks on the "
            "card: a group of steps replays a captured CUDA graph, and gloo's collectives "
            "of CUDA tensors cannot be captured; use the nccl backend (one card a rank), "
            "or steps_per_dispatch=1")


class BSPEngine:
    """Rule engine over the BSP step: ``init_state`` / ``train_step`` /
    ``eval_step`` / ``get_step``, the engine protocol of the reference's
    training loop.

    ``device``: ``None`` is the current CUDA device and raises when there
    is none; ``"cpu"`` runs on the CPU because it was asked for.
    ``n_devices > 1`` needs this process to be one rank of an initialized
    process group of that many ranks. ``input_transform`` runs on the
    images first in both steps (``train.make_input_transform``);
    ``eval_views`` is the validation batches' views per image;
    ``accum_steps`` splits each rank's batch into that many microbatches
    whose gradients average before the one update. ``n_slices``: the
    ranks form that many slices of ``n / n_slices`` (``parallel/mesh.py``;
    the ``hier`` strategy needs more than one, the rings refuse it).
    ``allreduce_buckets``: the exchange in buckets of about that many
    MB (``strategies.bucketed``; ``psum`` and ``hier`` only)."""

    name = "bsp"
    exchange_every = 0  # the allreduce is inside every step

    def __init__(
        self,
        model: Model,
        n_devices: int = 1,
        device=None,
        steps_per_epoch: int = 1,
        fused_update: bool = False,
        strategy: str = "psum",
        wire_codec=None,
        input_transform=None,
        eval_views: int = 1,
        accum_steps: int = 1,
        n_slices=None,
        allreduce_buckets: float = 0.0,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.n = int(n_devices)
        self.fused_update = bool(fused_update)
        self.strategy = strategy
        self.codec = get_codec(wire_codec)
        self.allreduce_buckets = float(allreduce_buckets or 0.0)
        if self.n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.axis_sizes = slice_topology(self.n, n_slices)
        if strategy == "hier" and self.axis_sizes[0] < 2:
            raise ValueError(
                "strategy 'hier' is the cross-slice hierarchical exchange — it needs a "
                "multislice mesh (--slices N with N > 1); on a single slice the flat "
                "'psum' is already optimal")
        sync_kw = dict(layouts=model.param_layouts,
                       axis_sizes=self.axis_sizes if n_slices else None)
        if self.n > 1:
            if not dist.is_initialized() or dist.get_world_size() != self.n:
                have = dist.get_world_size() if dist.is_initialized() else "no process group"
                raise RuntimeError(
                    f"BSP over {self.n} devices runs one process per rank in a "
                    f"process group of {self.n} ranks ({have} here): launch it "
                    "through theanompi_tpu_torch.launch.session or the CLI"
                )
            bind_axes(self.n, n_slices)
        self.rank = dist.get_rank() if self.n > 1 else 0
        # the exchange and the codec flatten each leaf in the reference's
        # order, which the model's layout tags decide
        if self.allreduce_buckets:
            grad_sync = bucketed(strategy, self.n, self.allreduce_buckets, self.codec, **sync_kw)
        else:
            grad_sync = get_strategy(strategy, self.n, codec=self.codec, **sync_kw)
        if self.n == 1:
            grad_sync = None  # validated only: one rank has no collective
        self.grad_sync = grad_sync
        self.accum_steps = int(accum_steps)
        self._step = make_train_step(model, steps_per_epoch, accum_steps=self.accum_steps,
                                     fused_update=fused_update, grad_sync=grad_sync,
                                     input_transform=input_transform)
        self.graph = None  # the captured step, made by the first fused group on the card
        self._eval = make_eval_step(model, input_transform=input_transform, views=eval_views)

    def init_state(self, gen: torch.Generator) -> TrainState:
        """Params from ``gen`` (every rank draws the same, from the same
        seed); with ``n > 1`` and error feedback, this rank's zero
        residuals."""
        state = init_train_state(self.model, gen, self.device,
                                 optimizer=_optimizer_for(self.model, self.fused_update))
        if self.n > 1 and self.strategy == "hier" and self.codec.error_feedback:
            # hier feeds the error back on its cross-slice shard: one row
            # a rank (a bucket), not one residual a leaf
            bucket_bytes = getattr(self.grad_sync, "bucket_bytes", None)
            state = state._replace(ef=hier_ef_template(state.params, self.axis_sizes,
                                                       bucket_bytes))
        elif self.n > 1:
            state = state._replace(ef=self.codec.init_ef(state.params))
        return state

    def train_step(self, state, images, labels, gen):
        state, metrics = self._step(state, images, labels, gen)
        if self.n == 1:
            return state, metrics
        keys = sorted(metrics)
        ms = tree_leaves(state.model_state)
        avg = mean_across_ranks([metrics[k] for k in keys] + ms, self.n)
        with torch.no_grad():
            for m, a in zip(ms, avg[len(keys):]):
                m.copy_(a)
        return state, dict(zip(keys, avg[:len(keys)]))

    def fused_train_step(self, state, images, labels, gen, after_step=None):
        """``len(images)`` steps over the batches ``images[i]``,
        ``labels[i]`` (host or device tensors) in one call -> ``(state,
        metrics)``, each metric an fp32 vector over the group (the
        reference's ``fused_train_step``). On the card the steps replay
        one captured graph, shared by groups of every size; on the CPU
        they run eagerly. ``after_step()`` runs after each step is
        enqueued."""
        # a fused call is a group, however short its trimmed last one
        check_fused_ranks(self.n, max(2, len(images)), self.device,
                          dist.get_backend() if self.n > 1 else None)
        if self.device.type == "cuda":
            if self.graph is None:
                self.graph = StepGraph(self.train_step, self.device)
            return self.graph.run(state, images, labels, gen, after_step)
        return eager_steps(self.train_step, state, images, labels, gen, self.device, after_step)

    def eval_step(self, state, images, labels):
        metrics = self._eval(state, images, labels)
        if self.n == 1:
            return metrics
        keys = sorted(metrics)
        return dict(zip(keys, mean_across_ranks([metrics[k] for k in keys], self.n)))

    def get_step(self, state) -> int:
        """The device step counter, read back (a host sync)."""
        return int(state.step.item())

    # -- what the training loop reads: the same protocol as the per-worker
    # -- rules' engines (parallel/workers.py) -------------------------------

    def replica(self, state):
        """This rank's replica: the whole state."""
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
        """``bridge.state_parts`` of this rank: the entries of a sharded
        set or of a reshard target, with no collective."""
        return bridge.state_parts(state, layouts, self.rank, self.n)

    def mesh_topology(self) -> dict:
        """The reference's ``mesh_topology`` of this run's mesh:
        ``("data",)`` over the ranks, ``("dcn", "data")`` under
        ``--slices``."""
        r, s = self.axis_sizes
        if r > 1:
            return {"shape": [r, s], "axes": ["dcn", "data"]}
        return {"shape": [self.n], "axes": ["data"]}

    def stack_axes(self) -> list:
        """The mesh axes the ``.ef`` stacks run over (every rank)."""
        return list(self.mesh_topology()["axes"])

    def elastic_spec(self) -> dict:
        """Per-leaf reshard policies stamped into every checkpoint's
        topology manifest (the reference's ``BSPEngine.elastic_spec``):
        the state is replicated (``global``), except the codec's
        error-feedback residuals, which belong to each rank's own
        quantization history and mean nothing on another world:
        ``reset``."""
        return {"policies": {".ef": {"policy": "reset"}}}

    def summary_fields(self, batch: int) -> dict:
        """The run summary's fields of the rule."""
        return {"slices": self.axis_sizes[0]}

    def rank_summary(self, state) -> dict:
        """This rank's summary fields: the digest of its replica, equal on
        every rank when the replicas agree bit for bit."""
        return {"replica_digest": digest(tree_leaves((state.params, state.opt_state)))}
