"""The training loop: epochs, validation, summary.

Port of ``theanompi_tpu/launch/worker.py::run_training`` for the rules
``bsp``, ``easgd`` and ``gosgd``, with the reference's dataset/recipe
checks, the epoch loop with ``max_steps``, a validation pass per epoch,
``print_freq`` logging, and a summary dict whose keys match the
reference's where they exist (``steps``, ``epochs``, ``val``,
``images_per_sec``, ``train_loop_s``).
For an LM (``model.is_lm``) ``--synthetic`` means the ``lm_synthetic``
token dataset, a batch row is one token window, and ``images_per_sec``
counts sequences.
Checkpoints and resume (``ckpt_dir``, ``resume``): after validation at
each epoch end, and after a ``max_steps`` cut, every rank gathers its
error-feedback residuals and dropout generator state to rank 0, which
writes ``ckpt_<step>.npz`` in the reference's format
(``utils/checkpoint.py``; the engine's ``state_entries``), on the writer
thread of an ``AsyncCheckpointer`` unless ``async_checkpoint=False``.
With ``ckpt_sharded`` every rank writes its own member of a sharded set
instead (the engine's ``checkpoint_parts``: rank 0 the replicated
leaves, each rank its rows of the stacks), with no collective. Every
save carries the topology manifest (the engine's ``mesh_topology`` and
``elastic_spec``, and ``base_world``, the world the base LR was set for,
carried on from the checkpoint a run resumed from).
``resume=True`` loads the newest verified checkpoint on every rank (all
ranks must resolve the same step), restores each rank's residual row and
generator, and starts at epoch ``step // steps_per_epoch``, skipping the
batches of a mid-epoch checkpoint that the restored steps consumed, so
the data and dropout streams continue bit for bit. With ``elastic`` a
checkpoint of another world is resharded onto this one
(``load_resharded``; generator rows of another world restart each rank's
dropout stream from ``(seed, rank)``). ``max_steps`` counts from step 0
of the run's timeline. An exception saves the last whole step first (the
crash save): on one rank, or on every rank with ``ckpt_sharded``; a
gathered save is collective, so without it several ranks skip it. The
JAX package reads these files and the port reads the JAX package's; a
JAX file carries no torch generator state, so the dropout stream then
starts from the seed.
Fault tolerance, at the reference's points: an injector
(``utils/faults.py``) fires its faults before the step they name
(``check_step``), poisons that step's batch, mangles the newest durable
checkpoint after a save and, through the checkpoint writer's hook,
fails or stalls a write. With ``sigterm_grace`` a SIGTERM handler sets a
flag: one rank reads it before each step, several ranks agree on it with
one ``all_reduce`` where the loop drains anyway (so that all stop after
the same step); the loop then saves the step, writes ``resumable.json``
and raises ``Preempted``. ``scrub_interval`` runs the scrubber on rank 0.
The supervisor (``launch/supervisor.py``) retries such runs.
The recorder (``utils/recorder.py``; files on rank 0 under
``save_dir``) gets one ``train`` row a step from the loop's drains,
``val`` and ``epoch`` rows, and prints the reference's console lines.
The dispatcher (``utils/dispatch.py``) decides when the loop drains:
every ``print_freq`` steps and at epoch ends, or with ``dispatch_depth``
K as soon as K steps are in flight.

Rules ``easgd`` and ``gosgd`` (``parallel/easgd.py``, ``parallel/gosgd.py``,
the reference's ``rule_kwargs``: ``avg_freq``, ``alpha``, ``p_push``,
``gossip_every``, ``group_size``; ``bsp`` refuses them). Every rank holds
its own worker; with ``group_size = g`` the ranks form ``n / g`` workers
of ``g`` (BSP inside a group, and with ``g > 1`` BatchNorm over the
group's ``"data"`` axis unless the recipe names another axis or
``bn_axis_name=None`` is given). ``recipe.batch_size`` is then the
PER-WORKER batch: the global batch is ``n_workers × batch_size``, of
which each rank reads its ``host_local_batch_slice`` (a worker's group
reads its worker's rows). The loop calls ``engine.exchange`` after every
``avg_freq``-th step (EASGD; GoSGD gossips inside its step), bracketed
as the recorder's ``comm`` with a sync on the card; a group of steps
runs its exchanges itself. A checkpoint holds the reference's stacked
``EASGDState`` / ``GOSGDState`` (the engines' ``state_entries``); on
resume each rank takes its worker's row; a file of another worker
count is refused by name unless the resume is elastic.

Tensor and sequence parallelism (``tp > 1`` or ``sp > 1``, the CLI's
``--tp`` and ``--sp``): an LM trains on the ``NDEngine``
(``parallel/nd.py``) over the ``(n / (tp·sp), tp, sp)`` mesh of the
reference's dense ND branch; rank ``r = (d·tp + t)·sp + s`` reads the
rows of its data index ``d`` (``[d·B/dp, (d+1)·B/dp)``; every rank of
one ``d`` reads the same rows), holds its model index's shards and its
step takes its sequence index's columns. The reference's ND refusals
hold (another rule, another strategy, ``--slices``, ``--accum-steps``,
rule options, ``--allreduce-buckets``, a classifier, ``tp · sp`` not
dividing the ranks, a sequence or batch the mesh does not divide, heads,
hidden units or vocabulary the model axis does not divide), and
``loss_chunk`` under ``--tp`` is refused, naming both.

Ranks. With ``devices=n > 1`` this function runs in each of n rank
processes of one process group (``launch/session.py`` spawns them). As
in the reference, ``recipe.batch_size`` is the GLOBAL batch: every rank
walks the same shuffled global batches and gathers only its rows
``[r·B/n, (r+1)·B/n)``; its dropout stream is seeded from ``(seed,
rank)``. Rank 0 prints; every rank returns the summary, which carries
each rank's step time, last loss and kernel launch counts, a digest of
each rank's params and optimizer state and one of its model state (BN
statistics), equal on every rank when the replicas agree, and with
several ranks one of its error-feedback residuals.

Hot loop. A ``PrefetchLoader`` thread (``tmpi-prefetch``, pinned to
``TMPI_LOADER_CPUS`` when set) gathers each host batch (uint8 datasets
through the native gather and crop, ``native/``) into pinned memory
(``data/loader.py::pinned_array``; a batch made elsewhere is copied
there); the loop copies it to the card with ``non_blocking=True`` and
dispatches the step, which never waits on the device. A dataset with a ``device_transform``
ships uint8 batches, and the step computes ``(x - mean) * scale`` on the
card (``train.make_input_transform``); one with ``val_views > 1`` ships
that many view-major rows per validation image, whose logits the eval
step averages. The host reads losses back only every ``print_freq``
steps and at epoch ends. Step time comes from CUDA events recorded after
every step (``time.perf_counter`` on the CPU, where ops are
synchronous); the first ``WARMUP_STEPS`` steps of a run are left out of
the steady-state figures, as they are from ``feed_wait_ms``, the host
time the loop spent waiting for the loader a step (near 0 when the card,
not the feed, paces the run).

Groups (``steps_per_dispatch = k > 1``, the reference's fused dispatch):
the loop takes up to k batches of one epoch at a time, the last group of
a run trimmed to land on ``max_steps``, and runs them through
``BSPEngine.fused_train_step``: on the card each step replays one
captured CUDA graph of the step (``graphs.py``), its batch copied from
pinned memory into the graph's input buffer; on the CPU the steps run
eagerly. Each step keeps its recorder row, its CUDA-event interval and
its wait, and saves fall where the per-step loop's do (epoch ends, the
``max_steps`` cut), since no group crosses them. A group enqueues
without waiting for the card, so the drains every ``print_freq`` steps,
or ``dispatch_depth``, bound how far the host runs ahead.
"""

from __future__ import annotations

import itertools
import math
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch import bridge, native
from theanompi_tpu_torch.data import get_dataset
from theanompi_tpu_torch.data.loader import PrefetchLoader, host_tensors, pinned_array
from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.contract import Model
from theanompi_tpu_torch.models.transformer import check_tp_loss_chunk
from theanompi_tpu_torch.ops.kernels import launch_counts
from theanompi_tpu_torch.parallel.bsp import BSPEngine, check_fused_ranks
from theanompi_tpu_torch.parallel.codec import get_codec
from theanompi_tpu_torch.parallel.distributed import agree_on_step, all_gather_objects
from theanompi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    host_local_batch_slice,
    nd_shape,
    rank_generator,
    slice_topology,
    worker_groups,
)
from theanompi_tpu_torch.parallel.workers import Clock
from theanompi_tpu_torch.train import make_input_transform
from theanompi_tpu_torch.tree import digest, tree_leaves
from theanompi_tpu_torch.utils.checkpoint import (
    TORCH_RNG_KEY,
    AsyncCheckpointer,
    CheckpointScrubber,
    checkpoint_step,
    clear_resumable_marker,
    integrity_manifest,
    latest_checkpoint,
    load_checkpoint,
    load_resharded,
    manifest_digest,
    read_topology_manifest,
    save_checkpoint,
    save_checkpoint_sharded,
    set_write_fault_hook,
    shard_pieces,
    to_numpy,
    write_resumable_marker,
)
from theanompi_tpu_torch.utils.dispatch import MetricsDispatcher
from theanompi_tpu_torch.utils.faults import FaultInjector, Preempted
from theanompi_tpu_torch.utils.recorder import Recorder

# summary["losses"] keeps the most recent per-step losses
LOSS_HISTORY = 1000
# host batches the prefetch thread may hold ready (19.8 MB each for
# AlexNet's uint8 ImageNet batch, 79 MB for its float32 synthetic one)
PREFETCH_DEPTH = 2
# first steps of a run left out of the steady-state step time (cuDNN
# set-up, the kernel library's first load)
WARMUP_STEPS = 2


# the reference's rule options; BSP takes none of them
RULE_KWARGS = {"easgd": ("avg_freq", "alpha", "group_size"),
               "gosgd": ("p_push", "avg_freq", "gossip_every", "group_size")}


def host_blocked_frac(host_blocked_s: float, train_loop_s: float) -> Optional[float]:
    """The share of the training loop the host spent blocked on the card
    (the dispatcher's waits), as the reference reports it: at most 1,
    rounded to 6 places, ``None`` when the loop took no time."""
    if train_loop_s <= 0:
        return None
    return round(min(1.0, host_blocked_s / train_loop_s), 6)


def _checkpoint_entries(engine, state, layouts, step_gen, devices: int, rank: int):
    """The entries of a checkpoint of ``state`` on rank 0 (None on the
    others): the state in the reference's layout (the engine's
    ``state_entries``: BSP's every rank's residuals as ``.ef`` stacks,
    EASGD's / GoSGD's every worker stacked) and every rank's dropout
    generator state as ``__torch_rng__`` (``[n, L]`` uint8). Collective:
    every rank calls it, on the training thread."""
    entries = engine.state_entries(state, layouts)
    gens = all_gather_objects(step_gen.get_state().numpy(), devices)
    if rank != 0:
        return None
    entries[TORCH_RNG_KEY] = np.stack(gens)
    return entries


def run_training(
    rule: str = "bsp",
    model_cls: type = None,
    devices: int = 1,
    *,
    device=None,
    fused_update: bool = False,
    pool_kernel: bool = False,
    strategy: str = "psum",
    wire_codec: str = "none",
    n_epochs: Optional[int] = None,
    max_steps: Optional[int] = None,
    dataset: Optional[str] = None,
    dataset_kwargs: Optional[dict] = None,
    recipe_overrides: Optional[dict] = None,
    seed: int = 0,
    save_dir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    async_checkpoint: bool = True,
    resume: bool = False,
    print_freq: int = 40,
    steps_per_dispatch: int = 1,
    accum_steps: int = 1,
    n_slices: Optional[int] = None,
    allreduce_buckets: float = 0.0,
    dispatch_depth: Optional[int] = None,
    ckpt_sharded: bool = False,
    scrub_interval: float = 0.0,
    elastic: bool = False,
    elastic_lr_scale: str = "none",
    sigterm_grace: float = 0.0,
    inject_faults=None,
    fault_ledger: Optional[str] = None,
    return_recorder: bool = False,
    tp: int = 1,
    sp: int = 1,
    **rule_kwargs,
) -> dict:
    """Train ``model_cls`` under a sync rule (``bsp``, ``easgd``,
    ``gosgd``); returns a summary dict.

    ``device``: ``None`` runs on the current CUDA device and raises when
    there is none; ``"cpu"`` runs on the CPU because it was asked for.
    ``devices``: how many ranks (cards) the rule spans; more than one
    needs this process to be a rank of a process group of that size.
    ``strategy`` / ``wire_codec``: the gradient exchange
    (``parallel/strategies.py``, ``parallel/codec.py``). ``pool_kernel``:
    the model routes its 3x3/stride-1 max pools to the pool kernels
    (``ops/pool.py``; a model with no such pool refuses). ``save_dir``:
    the recorder's JSONL log and pickled history. ``ckpt_dir``,
    ``async_checkpoint``, ``resume``: checkpoints (module docstring).
    ``steps_per_dispatch``: steps a group (module docstring; gloo ranks
    on the card are refused, ``bsp.check_fused_ranks``).
    ``accum_steps``: microbatches a step, their gradients averaged
    before the one update (each rank's batch must divide by it).
    ``n_slices``: the ranks in that many slices (``--slices``; the
    ``hier`` strategy's two hops run over them). ``allreduce_buckets``:
    the exchange in buckets of about that many MB, posted from the
    backward (``--allreduce-buckets``; ``psum`` and ``hier``).
    ``dispatch_depth``: at most that many steps in flight before the
    host waits for the oldest (``utils/dispatch.py``; None: drains every
    ``print_freq`` steps and at epoch ends). ``ckpt_sharded``: each rank
    writes its member of a sharded set, with no collective.
    ``scrub_interval``: seconds between the background scrubber's passes
    over ``ckpt_dir`` (0: off). ``elastic``: a resume onto another world
    reshards the checkpoint (``load_resharded``); ``elastic_lr_scale``
    ``"linear"`` scales the recipe's base LR by this world over the
    manifest's ``base_world``. ``sigterm_grace``: > 0 installs a SIGTERM
    handler; the loop then checkpoints, marks the run resumable and
    raises ``Preempted``. ``inject_faults``: fault specs
    (``utils/faults.py``), with ``fault_ledger`` the fired-fault file.
    ``return_recorder``: the summary carries the run's ``Recorder`` as
    ``recorder`` (its per-step ``wait`` and ``step`` times). ``tp > 1``
    or ``sp > 1``: an LM over the ``(devices / (tp·sp), tp, sp)`` mesh
    of a model axis and a sequence axis (``parallel/nd.py``, module
    docstring).
    ``rule_kwargs``: EASGD's ``avg_freq``, ``alpha``, ``group_size``;
    GoSGD's ``p_push``, ``avg_freq``, ``gossip_every``, ``group_size``
    (module docstring)."""
    run_start_t = time.time()
    device = resolve_device(device)
    k = int(steps_per_dispatch)
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    if int(accum_steps) < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    check_fused_ranks(devices, k, device,
                      dist.get_backend() if devices > 1 and dist.is_initialized() else None)
    if model_cls is None:
        raise ValueError("model_cls is required")
    rule = rule.lower()
    tp, sp = int(tp or 1), int(sp or 1)
    nd_active = tp > 1 or sp > 1
    if nd_active:
        # what the reference refuses under its ND axes, in its words
        what = "/".join(f for f, n in (("--tp", tp), ("--sp", sp)) if n > 1)
        if rule != "bsp":
            raise ValueError(f"{what} compose with the BSP rule only")
        if strategy != "psum":
            raise ValueError(f"{what} use the in-step psum sync (strategy 'psum')")
        if n_slices and n_slices > 1:
            raise ValueError(f"{what} do not compose with --slices yet")
        if int(accum_steps) != 1:
            raise ValueError(f"{what} do not compose with --accum-steps yet")
        if rule_kwargs:
            raise ValueError(f"{what} got unexpected options {sorted(rule_kwargs)}")
        if allreduce_buckets:
            raise ValueError(
                "--allreduce-buckets buckets the BSP in-step gradient allreduce only (ZeRO's "
                "scatter/gather and the ND sharded-axis psums own their own schedules; "
                "EASGD/GoSGD exchange periodically — there is no every-step allreduce to "
                "bucket)")
        if not getattr(model_cls, "is_lm", False):
            raise ValueError(
                f"{what} needs an LM model (theanompi_tpu_torch.models.lm TransformerLMModel); "
                f"{model_cls.__name__} is classifier-shaped")
        if getattr(model_cls, "is_moe", False):
            raise ValueError("MoELMModel is not ported yet (ROADMAP.md queue 1 item 1); "
                             f"{what} trains the dense TransformerLMModel")
        if tp > 1:
            over = model_cls.default_recipe().replace(**(recipe_overrides or {}))
            check_tp_loss_chunk(over, MODEL_AXIS)
        nd_shape(devices, tp, sp)  # the mesh: tp x sp must divide the devices
    if allreduce_buckets and rule != "bsp":
        raise ValueError(
            "--allreduce-buckets buckets the BSP in-step gradient allreduce only "
            "(EASGD/GoSGD exchange periodically — there is no every-step allreduce to "
            "bucket)")
    if rule not in ("bsp", *RULE_KWARGS):
        raise ValueError(f"unknown rule {rule!r}; available: bsp, easgd, gosgd")
    if rule == "bsp" and rule_kwargs:
        raise ValueError(
            f"rule 'bsp' got unexpected options {sorted(rule_kwargs)} "
            "(avg_freq/alpha/p_push/group_size apply to EASGD/GoSGD only)")
    if rule != "bsp":
        extra = sorted(set(rule_kwargs) - set(RULE_KWARGS[rule]))
        if extra:
            raise ValueError(f"rule {rule!r} got unexpected options {extra} (it takes "
                             f"{', '.join(RULE_KWARGS[rule])})")
        if strategy != "psum":
            raise ValueError("strategy applies to the BSP rule only")
    rule_kwargs = {k: v for k, v in rule_kwargs.items() if v is not None}
    group_size = int(rule_kwargs.get("group_size", 1))
    # the ranks' worker layout (raises when the groups or slices do not fit)
    n_workers = worker_groups(devices, group_size, n_slices)[0] if rule != "bsp" else devices

    if elastic_lr_scale not in ("none", "linear"):
        raise ValueError(f"elastic_lr_scale must be 'none' or 'linear', got {elastic_lr_scale!r}")
    if dispatch_depth is not None and int(dispatch_depth) < 1:
        raise ValueError(f"dispatch_depth must be >= 1, got {dispatch_depth}")

    recipe = model_cls.default_recipe()
    if recipe_overrides:
        recipe = recipe.replace(**recipe_overrides)
    # the LR-scale anchor, the world the base LR was set for: carried
    # through every manifest as elastic.base_world, so the scale stays
    # this world / base over any number of reshards (read on every resume:
    # a plain resume in an elastic sequence keeps the anchor)
    base_world = resume_path = None
    if resume and ckpt_dir:
        t0 = time.perf_counter()
        # verify=True walks back past a corrupt or truncated newest file
        resume_path = latest_checkpoint(ckpt_dir, verify=True)
        verify_ms = (time.perf_counter() - t0) * 1e3
        manifest = read_topology_manifest(resume_path) if resume_path else None
        if manifest and manifest.get("mesh"):
            saved_world = int(np.prod(manifest["mesh"]["shape"]))
            base_world = int((manifest.get("elastic") or {}).get("base_world") or saved_world)
            if (elastic and elastic_lr_scale == "linear" and devices != base_world
                    and "lr" in (recipe.sched_kwargs or {})):
                sk = dict(recipe.sched_kwargs)
                sk["lr"] = float(sk["lr"]) * devices / base_world
                recipe = recipe.replace(sched_kwargs=sk)
                print(f"[elastic] linear LR rescale: world {base_world} -> {devices}, base lr "
                      f"now {sk['lr']:g}", flush=True)
    if (group_size > 1 and recipe.bn_axis_name is None
            and "bn_axis_name" not in (recipe_overrides or {})):
        # a worker group is statistically one worker: BN statistics over
        # its data axis (an explicit bn_axis_name=None keeps them per rank)
        recipe = recipe.replace(bn_axis_name=DATA_AXIS)
    model: Model = model_cls(recipe, pool_kernel=pool_kernel)

    dataset = dataset or recipe.dataset
    if dataset == "synthetic" and getattr(model, "is_lm", False):
        # `--synthetic` on an LM means synthetic TOKENS, not float images
        dataset = "lm_synthetic"
    dataset_kwargs = dict(dataset_kwargs or {})
    if dataset in ("synthetic", "imagenet_synthetic"):
        # synthetic stand-ins default to the MODEL's shapes
        if dataset == "synthetic":
            dataset_kwargs.setdefault("image_shape", tuple(recipe.input_shape))
        else:
            dataset_kwargs.setdefault("crop", recipe.input_shape[0])
        dataset_kwargs.setdefault("n_classes", recipe.num_classes)
    elif dataset in ("lm_synthetic", "lm_text"):
        # token datasets default to the MODEL's sequence length / vocab
        dataset_kwargs.setdefault("seq_len", recipe.input_shape[0])
        if dataset == "lm_synthetic":
            dataset_kwargs.setdefault("vocab", recipe.num_classes)
    # BSP: recipe.batch_size is the global batch; EASGD / GoSGD: the
    # per-worker batch, so the global batch is n_workers of them
    batch = recipe.batch_size * (n_workers if rule != "bsp" else 1)
    if (batch // max(1, devices)) % int(accum_steps):
        raise ValueError(f"each rank's batch ({batch} / {devices} ranks) must divide into "
                         f"accum_steps={accum_steps} microbatches")

    data = get_dataset(dataset, **dataset_kwargs)
    if tuple(data.image_shape) != tuple(recipe.input_shape):
        raise ValueError(
            f"dataset {dataset!r} yields images {tuple(data.image_shape)} but "
            f"model {model_cls.__name__} expects {tuple(recipe.input_shape)}; "
            "pass --dataset-arg values matching the recipe (or override "
            "recipe.input_shape)"
        )
    if data.n_classes != recipe.num_classes:
        raise ValueError(
            f"dataset {dataset!r} has {data.n_classes} classes but model head "
            f"expects {recipe.num_classes} (override recipe.num_classes or the "
            "dataset's n_classes)"
        )
    steps_per_epoch = data.n_train_batches(batch)
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset has {data.n_train} train examples < the global batch {batch} "
            f"({'= recipe.batch_size' if rule == 'bsp' else '= n_workers x recipe.batch_size'})"
        )
    n_epochs = n_epochs if n_epochs is not None else recipe.n_epochs
    vbatch = recipe.val_batch_size or batch
    if nd_active:
        # tokens shard P(data, seq): the sequence divides sp, the batch dp
        T = recipe.input_shape[0]
        if T % sp:
            raise ValueError(f"sequence length {T} not divisible by --sp {sp}")
        dp = nd_shape(devices, tp, sp)[0]
        for name, b in (("batch", batch), ("val batch", vbatch)):
            if b % dp:
                raise ValueError(f"global {name} {b} not divisible by {dp} "
                                 "(batch-axis devices x microbatches)")
    else:
        for what, b in (("global batch", batch), ("val batch", vbatch)):
            if b % devices:
                raise ValueError(f"{what} {b} not divisible by {devices} devices")
    if data.n_val and vbatch > data.n_val:
        raise ValueError(
            f"val batch {vbatch} exceeds the dataset's {data.n_val} val "
            "examples — validation would silently run zero batches "
            "(set recipe val_batch_size or enlarge the val split)"
        )

    # uint8 batches normalized on the card, multi-view validation: the
    # dataset's opt-ins (reference worker.py:604-616)
    input_transform = make_input_transform(getattr(data, "device_transform", None), device)
    eval_views = int(getattr(data, "val_views", 1))
    common = dict(steps_per_epoch=steps_per_epoch, fused_update=fused_update,
                  wire_codec=wire_codec, input_transform=input_transform,
                  eval_views=eval_views, accum_steps=accum_steps, n_slices=n_slices)
    if nd_active:
        from theanompi_tpu_torch.parallel.nd import NDEngine

        engine = NDEngine(model, devices, device, tp=tp, sp=sp,
                          steps_per_epoch=steps_per_epoch, wire_codec=wire_codec,
                          fused_update=fused_update)
    elif rule == "bsp":
        engine = BSPEngine(model, devices, device, strategy=strategy,
                           allreduce_buckets=allreduce_buckets, **common)
    elif rule == "easgd":
        from theanompi_tpu_torch.parallel.easgd import EASGDEngine

        engine = EASGDEngine(model, devices, device, **common, **rule_kwargs)
    else:
        from theanompi_tpu_torch.parallel.gosgd import GOSGDEngine

        engine = GOSGDEngine(model, devices, device, seed=seed, **common, **rule_kwargs)
    rank = dist.get_rank() if devices > 1 else 0
    # a rank reads its row of the mesh's batch axis: under --tp / --sp
    # the data axis's (the model and sequence axes' ranks share its rows)
    row, row_ranks = (engine.dp_index, engine.dp) if nd_active else (rank, devices)
    shard = host_local_batch_slice(batch, row, row_ranks)
    vshard = host_local_batch_slice(vbatch, row, row_ranks)
    state = engine.init_state(torch.Generator().manual_seed(seed))
    layouts = model.param_layouts(engine.replica(state).params)
    # dropout masks: an explicit generator per rank on its card (the
    # global RNG is never touched)
    step_gen = (rank_generator(seed + 1, rank, device) if devices > 1
                else torch.Generator(device=device).manual_seed(seed + 1))
    pin = device.type == "cuda"
    clock = Clock(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the topology stamp of every save: the engine's mesh, its reshard
    # policies, and the LR-scale anchor (a fresh run anchors to its world)
    mesh = engine.mesh_topology()
    topology = {"mesh": mesh, "stack_axes": engine.stack_axes(),
                "elastic": {**engine.elastic_spec(),
                            "base_world": int(base_world or np.prod(mesh["shape"]))}}
    if hasattr(engine, "leaf_specs"):  # the ND engine's sharded entries
        topology["leaf_specs"] = engine.leaf_specs(state, layouts)

    def parts(state) -> list:
        """This rank's parts of a checkpoint, its dropout generator's row
        included (no collective)."""
        return engine.checkpoint_parts(state, layouts) + [
            (TORCH_RNG_KEY, step_gen.get_state(), rank, devices)]

    summary: dict = {"epochs": [], "rule": rule, "model": model.name,
                     "device": str(device), "fused_update": bool(fused_update),
                     "pool_kernel": bool(pool_kernel),
                     "batch_size": batch, "devices": devices, "strategy": strategy,
                     "wire_codec": get_codec(wire_codec).spec, "dataset": dataset,
                     "device_normalize": input_transform is not None, "eval_views": eval_views,
                     "steps_per_dispatch": k, "accum_steps": engine.accum_steps,
                     "allreduce_buckets": float(allreduce_buckets or 0.0),
                     "bn_axis_name": recipe.bn_axis_name, "resumed_from_step": None,
                     "ckpt_sharded": bool(ckpt_sharded), "elastic": bool(elastic),
                     "resharded_from_world": None, "mesh": mesh, "run_start_t": run_start_t,
                     "tp": tp, "sp": sp,
                     **engine.summary_fields(batch)}

    start_epoch = 0
    if resume and ckpt_dir:
        path = resume_path
        if devices > 1:
            agree_on_step(checkpoint_step(path), devices)
        if path:
            t0 = time.perf_counter()
            reshard = None
            if elastic:
                flat, reshard = load_resharded(path, bridge.entry_shapes(parts(state)), mesh)
            else:
                flat = load_checkpoint(path)
            state = engine.restore(flat, state, layouts)
            saved = flat.get(TORCH_RNG_KEY)
            own = step_gen.get_state()
            rng_restored = saved is not None and saved.shape == (devices, own.numel())
            if rng_restored:
                step_gen.set_state(torch.from_numpy(saved[rank].copy()))
            elif rank == 0:
                print(f"[rank 0] {path} holds no dropout generator state of this run "
                      f"({'none' if saved is None else f'shape {saved.shape}'}; this run's "
                      f"{devices} x {own.numel()} bytes): the dropout stream starts from the "
                      "seed, each rank's from (seed, rank), as a fresh run's does", flush=True)
            sync()
            load_ms = (time.perf_counter() - t0) * 1e3
            step0 = engine.get_step(state)
            start_epoch = step0 // steps_per_epoch
            summary["resumed_from_step"] = step0
            if reshard is not None and reshard["resharded"]:
                summary["resharded_from_world"] = reshard["from_world"]
                # the replicated params as loaded, digested as the file holds them
                params = {key: to_numpy(v) for key, v, row, _ in parts(state)
                          if row is None and key.startswith((".params/", ".center_params/"))}
                summary["reshard"] = {**reshard, "step": step0, "load_ms": load_ms,
                                      "per_rank_batch": batch // row_ranks,
                                      "params_digest": manifest_digest(integrity_manifest(params))}
                if rank == 0:
                    print(f"[elastic] resharded {path} onto this world: {reshard['from_world']} "
                          f"-> {reshard['to_world']} ranks, {reshard['leaves']} leaves, "
                          f"{len(reshard['reset'])} reset, per-rank batch {batch // row_ranks}",
                          flush=True)
            # what the resumed run holds, digested as a save would write
            # it: equal to the digest the writer recorded at that step
            entries = _checkpoint_entries(engine, state, layouts, step_gen, devices, rank)
            if rank == 0:
                if not rng_restored:
                    entries.pop(TORCH_RNG_KEY)
                file_digest = manifest_digest(integrity_manifest(
                    {k: to_numpy(v) for k, v in entries.items()}))
                summary["resume"] = {"path": path, "step": step0, "verify_ms": verify_ms,
                                     "load_ms": load_ms, "digest": file_digest,
                                     "torch_rng_restored": rng_restored,
                                     "torch_rng": ("restored" if rng_restored else
                                                   "restarted from (seed, rank)")}
                print(f"resumed from {path} at step {step0}", flush=True)

    def place(batch):
        return host_tensors(batch, pin)

    def to_device(t):
        return t.to(device, non_blocking=True)

    rec = Recorder(rank=rank, print_freq=print_freq if rank == 0 else 0,
                   save_dir=save_dir if rank == 0 else None, run_name=f"{model.name}_{rule}")
    writer = (AsyncCheckpointer()
              if ckpt_dir and async_checkpoint and (rank == 0 or ckpt_sharded) else None)
    saves: list = []  # sync saves of this rank; the writer keeps its own records
    all_keys = list(bridge.entry_shapes(parts(state))) if ckpt_sharded else None

    def save(state, step: int, sync_write: bool = False) -> None:
        """Without ``ckpt_sharded`` collective: every rank gathers, rank 0
        writes. With it, every rank writes its member, with no
        collective. On the writer thread unless there is none or
        ``sync_write``."""
        t0 = time.perf_counter()
        if ckpt_sharded:
            entries, layout = bridge.shard_layout(parts(state), rank)
            shard_spec = {"rank": rank, "world": devices, "layout": layout, "keys": all_keys}
            if writer is not None and not sync_write:
                writer.save(ckpt_dir, entries, step, topology=topology, shard=shard_spec)
                return
            flat = {name: to_numpy(v) for name, v in entries.items()}
            info = {"step": step, "gather_ms": (time.perf_counter() - t0) * 1e3}
            info["path"] = save_checkpoint_sharded(ckpt_dir, shard_pieces(flat, layout), step,
                                                   rank, devices, info=info, topology=topology,
                                                   keys=all_keys)
            info["loop_ms"] = (time.perf_counter() - t0) * 1e3
            saves.append(info)
            return
        entries = _checkpoint_entries(engine, state, layouts, step_gen, devices, rank)
        if rank != 0:
            return
        if writer is not None and not sync_write:
            writer.save(ckpt_dir, entries, step, topology=topology)
            return
        flat = {name: to_numpy(v) for name, v in entries.items()}
        info = {"step": step, "gather_ms": (time.perf_counter() - t0) * 1e3}
        info["path"] = save_checkpoint(ckpt_dir, flat, step, info=info, topology=topology)
        info["loop_ms"] = (time.perf_counter() - t0) * 1e3
        saves.append(info)

    # injected faults fire at fixed steps (utils/faults.py); the storage
    # faults inside the checkpoint write, through the process-wide hook
    faults = FaultInjector(inject_faults, ledger=fault_ledger, rank=rank) if inject_faults else None
    if faults is not None:
        set_write_fault_hook(faults.write_fault)
        faults.set_topology(*slice_topology(devices, n_slices))
    scrubber = None
    if ckpt_dir and scrub_interval and scrub_interval > 0 and rank == 0:
        scrubber = CheckpointScrubber(ckpt_dir, interval=float(scrub_interval))
        scrubber.start()
    # SIGTERM sets a flag the loop reads: one rank before each step;
    # several ranks agree on it where the loop drains anyway, so that all
    # of them stop after the same step
    preempt = {"flag": False}
    prev_sigterm, sigterm_installed = None, False
    if sigterm_grace and sigterm_grace > 0:
        if threading.current_thread() is threading.main_thread():
            def on_sigterm(signum, frame):
                preempt["flag"] = True
                print(f"[rank {rank}] SIGTERM: will checkpoint and exit within the "
                      f"{sigterm_grace}s grace window", flush=True)

            prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
            sigterm_installed = True
        else:
            print(f"[rank {rank}] WARNING: sigterm_grace needs the main thread (a signal "
                  "handler cannot be installed from a session's background thread); "
                  "preemption grace is off for this run", flush=True)

    def preempted() -> bool:
        """Did any rank get SIGTERM? Collective with several ranks: call
        it only where every rank is at the same step."""
        if not sigterm_installed or devices == 1:
            return preempt["flag"]
        on = device if dist.get_backend() == "nccl" else torch.device("cpu")
        flag = torch.tensor([1.0 if preempt["flag"] else 0.0], device=on)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    losses: deque = deque(maxlen=LOSS_HISTORY)
    nonfinite = 0
    intervals: list = []  # steady-state step ms, all epochs
    waits: list = []  # host ms waiting for the loader, a step, all epochs
    epoch_step_ms: list = []  # each epoch's steady-state mean
    seen_intervals = 0
    train_loop_s = 0.0
    step_count = summary["resumed_from_step"] or 0
    last_ckpt_step = step_count if summary["resumed_from_step"] is not None else -1
    # a mid-epoch checkpoint: the batches its steps consumed are skipped
    skip_batches = step_count % steps_per_epoch
    torn = False  # True while a step may be half applied (in-place update)
    epoch_ivals: list = []
    read_stream = None  # reads rows of finished steps past newer ones in flight

    def drain(entries: list, partial: bool) -> None:
        """Read the rows of ``entries`` (``(step, metrics, wait_ms,
        start mark, end mark, ready mark)``, the ready mark recorded once
        the metrics were made) back in one copy, and record a row per
        step with its time from its events. ``partial``: newer steps are
        in flight, so the copy runs on a side stream, which waits for
        none of them (the dispatcher waited for these steps' events)."""
        nonlocal nonfinite, read_stream
        keys = sorted(entries[0][1])

        def read():
            return torch.stack([torch.stack([torch.as_tensor(m[key]).float().reshape(())
                                             for key in keys])
                                for _, m, *_ in entries]).cpu().tolist()

        if partial and device.type == "cuda":
            entries[-1][5].synchronize()
            if read_stream is None:
                read_stream = torch.cuda.Stream(device)
            with torch.cuda.stream(read_stream):
                vals = read()
        else:
            vals = read()
        if clock.cuda:
            entries[-1][4].synchronize()
            ivals = [e[3].elapsed_time(e[4]) for e in entries]
        else:
            ivals = [(e[4] - e[3]) * 1e3 for e in entries]
        for (step, _, wait_ms, *_), row, ms in zip(entries, vals, ivals):
            metrics = dict(zip(keys, row))
            nonfinite += not math.isfinite(metrics["loss"])
            losses.append(metrics["loss"])
            rec.note_time("wait", wait_ms / 1e3)
            rec.note_time("step", ms / 1e3)
            rec.train_metrics(step, metrics, n_images=batch)
        epoch_ivals.extend(ivals)

    disp = MetricsDispatcher(drain, dispatch_depth, print_freq)

    try:
        for epoch in range(start_epoch, n_epochs):
            if max_steps and step_count >= max_steps:
                break
            rec.start_epoch()
            t_loop0 = time.perf_counter()
            marks = [clock.mark()]
            epoch_ivals = []
            epoch_waits: list = []
            epoch_steps = 0
            # on the card, the native loader writes each batch into pinned memory
            source = data.train_epoch(epoch, batch, seed=seed, rows=shard,
                                      out=pinned_array if pin else None)
            if skip_batches:
                source = itertools.islice(source, skip_batches, None)
                skip_batches = 0
            with PrefetchLoader(source, place, depth=PREFETCH_DEPTH) as batches:
                while True:
                    if devices == 1 and preempt["flag"]:
                        raise Preempted(step_count)
                    # a group of up to k batches, never past max_steps
                    # and never across an epoch
                    want = min(k, max_steps - step_count) if max_steps else k
                    group = []
                    while len(group) < want:
                        t_wait = time.perf_counter()
                        try:
                            x, y = next(batches)
                        except StopIteration:
                            break
                        group.append((x, y, (time.perf_counter() - t_wait) * 1e3))
                    if not group:
                        break
                    first = step_count
                    if faults is not None:
                        faults.check_step(first + 1, first + len(group))
                    torn = True
                    if k == 1:
                        x, y, _ = group[0]
                        x = to_device(x)
                        if faults is not None:
                            x = faults.poison_batch(x, first + 1)
                        state, metrics = engine.train_step(state, x, to_device(y), step_gen)
                        marks.append(clock.mark())
                        disp.enqueued(first + 1, marks[-1])
                        rows = [metrics]
                        ready = marks[-1]
                    else:
                        xs = [g[0] for g in group]
                        if faults is not None:
                            xs = [faults.poison_batch(x, first + 1 + i) for i, x in enumerate(xs)]
                        done = itertools.count(first + 1)

                        def after_step():
                            marks.append(clock.mark())
                            disp.enqueued(next(done), marks[-1])

                        state, metrics = engine.fused_train_step(
                            state, xs, [g[1] for g in group], step_gen, after_step=after_step)
                        ready = clock.mark()  # after the group's metrics
                        rows = [{key: v[i] for key, v in metrics.items()}
                                for i in range(len(group))]
                    g = len(group)
                    if summary["resumed_from_step"] is not None and "first_step_t" not in summary:
                        # a resumed run's first step has run (one wait, once)
                        sync()
                        summary["first_step_t"] = time.time()
                    entries = []
                    for i, ((_, _, wait_ms), row) in enumerate(zip(group, rows)):
                        step_count += 1
                        epoch_steps += 1
                        epoch_waits.append(wait_ms)
                        entries.append((step_count, row, wait_ms, marks[-g - 1 + i], marks[-g + i],
                                        ready))
                    every = engine.exchange_every
                    if k == 1 and every and step_count % every == 0:
                        # the periodic exchange (EASGD's avg_freq; the reference's
                        # worker loop calls exchanger.exchange() as 'comm')
                        sync()
                        disp.synced()
                        rec.start("comm")
                        state = engine.exchange(state)
                        sync()
                        rec.end("comm")
                    torn = False
                    flushes = disp.n_syncs
                    disp.push(entries, first, step_count)
                    if devices > 1 and sigterm_installed and disp.n_syncs > flushes \
                            and preempted():
                        raise Preempted(step_count)
                    if len(group) < want or (max_steps and step_count >= max_steps):
                        break
            disp.flush()
            if preempted():
                raise Preempted(step_count)
            rec.end_epoch(epoch, n_images=epoch_steps * batch)
            skip = max(0, WARMUP_STEPS - seen_intervals)
            seen_intervals += len(epoch_ivals)
            steady = epoch_ivals[skip:]
            intervals += steady
            epoch_step_ms.append(sum(steady) / len(steady) if steady else None)
            # the wait before a step falls in that step's interval
            waits += epoch_waits[skip:]
            train_loop_s += time.perf_counter() - t_loop0

            val_sum, n_val = None, 0
            for vx, vy in data.val_epoch(vbatch, rows=vshard):
                vx, vy = place((vx, vy))
                vm = engine.eval_step(state, to_device(vx), to_device(vy))
                val_sum = vm if val_sum is None else {k: val_sum[k] + vm[k] for k in vm}
                n_val += 1
            if n_val:
                summary["val"] = {k: float(v) / n_val for k, v in val_sum.items()}
                rec.val_metrics(epoch, summary["val"])
            if ckpt_dir:
                rec.start("checkpoint")
                save(state, step_count)
                rec.end("checkpoint")
                last_ckpt_step = step_count
                if faults is not None:
                    # storage mutations of the newest durable checkpoint
                    # (torn write, bit-rot, a lost member): every rank's
                    # write lands first, then rank 0 mangles it
                    due = faults.storage_mutations_due(step_count)
                    if due:
                        if writer is not None:
                            writer.wait()
                        if devices > 1:
                            dist.barrier()
                        if rank == 0:
                            for spec in due:
                                hit = faults.apply_storage_mutation(spec, ckpt_dir)
                                print(f"[faults] {spec.kind}@{spec.step}: {hit}", flush=True)
            rec.save()
            summary["epochs"].append(epoch)
    except Preempted:
        # the SIGTERM grace path: read the rows in flight, make the save in
        # flight durable, save this step, and mark the run resumable; the
        # raise reaches the supervisor or the CLI as a clean exit
        try:
            disp.flush()
        except Exception as e:  # noqa: BLE001 — must not replace the clean exit
            print(f"dispatch flush failed during preemption (suppressed): {e!r}", flush=True)
        if ckpt_dir:
            if writer is not None:
                try:
                    writer.wait()
                except Exception as e:  # noqa: BLE001
                    print(f"checkpoint writer failed during preemption (suppressed): {e!r}",
                          flush=True)
            if step_count != last_ckpt_step:
                try:
                    save(state, step_count, sync_write=True)
                    last_ckpt_step = step_count
                except Exception as e:  # noqa: BLE001 — the last save still resumes
                    print(f"final preemption checkpoint failed (suppressed; marker points "
                          f"at step {last_ckpt_step}): {e!r}", flush=True)
            if rank == 0:
                write_resumable_marker(ckpt_dir, last_ckpt_step, "sigterm")
        raise
    except Exception as exc:
        # when it failed (the supervisor's time to recovery starts here)
        try:
            exc.t_fail = getattr(exc, "t_fail", time.time())
        except AttributeError:  # an exception type that takes no attributes
            pass
        # the crash save: the newest whole step must not be lost. A
        # gathered save is collective, so with several ranks it runs only
        # in sharded mode, where each rank writes its own member
        if ckpt_dir and step_count > last_ckpt_step:
            if devices > 1 and not ckpt_sharded:
                print(f"[rank {rank}] no crash checkpoint: a save is collective and the "
                      "other ranks may never reach it (--ckpt-sharded saves without one)",
                      flush=True)
            elif torn:
                print(f"[rank {rank}] no crash checkpoint: the exception came inside a step, "
                      "whose in-place update may be half applied", flush=True)
            else:
                try:
                    if writer is not None:
                        writer.wait()
                    save(state, step_count, sync_write=True)
                    print(f"[rank {rank}] crash checkpoint saved at step {step_count}", flush=True)
                except Exception as e:  # noqa: BLE001 — must not mask the training error
                    print(f"crash checkpoint failed during error unwinding (suppressed): {e!r}",
                          flush=True)
        raise
    finally:
        try:
            if writer is not None:
                # a failed background write raises here, but never in
                # place of a training exception already propagating
                if sys.exc_info()[0] is not None:
                    try:
                        writer.close()
                    except Exception as e:  # noqa: BLE001
                        print(f"checkpoint writer failed during error unwinding "
                              f"(suppressed): {e!r}", flush=True)
                else:
                    writer.close()
        finally:
            if faults is not None:
                set_write_fault_hook(None)
            if scrubber is not None:
                scrubber.stop()
            if sigterm_installed:
                signal.signal(signal.SIGTERM, prev_sigterm)
            rec.close()

    if ckpt_dir and rank == 0:
        clear_resumable_marker(ckpt_dir)  # a finished run is not resumable
    summary["steps"] = step_count
    summary["device_steps"] = engine.get_step(state)
    summary["train_loop_s"] = round(train_loop_s, 6)
    recent = intervals[-50:]
    step_ms = sum(recent) / len(recent) if recent else None
    summary["step_ms"] = step_ms
    summary["steady_steps"] = len(intervals)
    summary["epoch_step_ms"] = epoch_step_ms
    summary.update(disp.summary())
    summary["host_blocked_frac"] = host_blocked_frac(disp.host_blocked_s, train_loop_s)
    graph = engine.graph
    summary["captured"] = graph is not None and graph.replays > 0
    summary["graph"] = ({"captures": graph.captures, "replays": graph.replays}
                        if graph is not None else None)
    if faults is not None:
        summary["faults_fired"] = [f"{s.kind}@{s.step}" for s in faults.specs if s.fired]
    if scrubber is not None:
        summary["scrub"] = {"runs": scrubber.runs, "quarantined": scrubber.quarantined_total}
    if ckpt_dir and (rank == 0 or ckpt_sharded):
        summary["checkpoints"] = sorted(
            [dict(r, mode="sync") for r in saves]
            + [dict(r, mode="async") for r in (writer.records if writer else [])],
            key=lambda r: r["step"])
        if writer is not None:
            summary["ckpt_storage_failures"] = writer.storage_failures
    recent_waits = waits[-50:]
    own = {"step_ms": step_ms, "kernel_launches": launch_counts(),
           "final_loss": losses[-1] if losses else None,
           "feed_wait_ms": sum(recent_waits) / len(recent_waits) if recent_waits else None,
           "native_calls": dict(native.LOADER.calls)}
    # what each rank holds at the end: the replicas must agree bit for
    # bit (and a run with its steps grouped must equal one without)
    own.update(engine.rank_summary(state))
    own["model_state_digest"] = digest(tree_leaves(engine.replica(state).model_state))
    per_rank = [own]
    if devices > 1:
        # the error-feedback residuals are each rank's own
        own["ef_digest"] = digest(tree_leaves(state.ef))
        own["ef_norm"] = float(sum(torch.sum(e.double() ** 2) for e in tree_leaves(state.ef))) ** 0.5
        per_rank = [None] * devices
        dist.all_gather_object(per_rank, own)
    for key in per_rank[0]:
        summary[f"{key}_per_rank"] = [r[key] for r in per_rank]
    # a BSP step ends when its slowest rank's does
    slowest = max((t for t in summary["step_ms_per_rank"] if t), default=None)
    summary["images_per_sec"] = batch / (slowest / 1e3) if slowest else 0.0
    summary["losses"] = list(losses)
    summary["nonfinite_steps"] = nonfinite
    if return_recorder:
        summary["recorder"] = rec
    return summary
