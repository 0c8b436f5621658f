"""Command-line launcher of the port (training subcommand).

Port of ``theanompi_tpu/cli.py``'s training path::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --synthetic \\
        --fused-update --max-steps 10 \\
        --dataset-arg 'image_shape=[227,227,3]' --dataset-arg n_classes=1000 \\
        --dataset-arg n_train=1280 --dataset-arg n_val=128

GoogLeNet at full width, its inception pool branches on the pool
kernels (the reference's ``TMPI_PALLAS_POOL=1``)::

    python -m theanompi_tpu_torch.cli BSP 1 googlenet GoogLeNet --synthetic \
        --pool-kernel --fused-update --batch-size 512 --max-steps 6 \
        --dataset-arg n_train=3072 --dataset-arg n_val=512

AlexNet on uint8 ImageNet batches, gathered, cropped and mirrored by the
native loader and normalized on the card (``imagenet_synthetic`` needs no
data; ``imagenet`` reads the ``.npy`` shards of ``data/imagenet.py``)::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet \
        --dataset imagenet_synthetic --fused-update --max-steps 22 \
        --dataset-arg n_train=2816 --dataset-arg n_val=128
    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --dataset imagenet \
        --dataset-arg root=SHARD_DIR --dataset-arg val_crops=10 --fused-update

Several ranks, one process per card over NCCL (the global batch split
across them)::

    python -m theanompi_tpu_torch.cli BSP 4 alexnet AlexNet --synthetic \
        --fused-update --strategy ring_int8 ...
    python -m theanompi_tpu_torch.cli BSP 4 alexnet AlexNet --synthetic \
        --fused-update --strategy psum --wire-codec int8:ef ...

Checkpoints in the reference's ``.npz`` format after each epoch (and
after a ``--max-steps`` cut), and a resume from the newest verified one;
the JAX package resumes from these files and the port from its::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --synthetic \
        --fused-update --max-steps 3 --ckpt-dir CKPT --save-dir LOGS
    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --synthetic \
        --fused-update --max-steps 6 --ckpt-dir CKPT --save-dir LOGS --resume

The rest of the reference's BSP exchange: cross-replica BatchNorm, the
exchange in buckets posted from the backward, and the two-hop ``hier``
exchange over 2 slices of 2 cards (its codec on the cross-slice hop)::

    python -m theanompi_tpu_torch.cli BSP 4 resnet50 ResNet50 \
        --dataset imagenet_synthetic --fused-update --recipe-arg bn_axis_name=data \
        --allreduce-buckets 25 --max-steps 6 --dataset-arg n_train=1536 --dataset-arg n_val=256
    python -m theanompi_tpu_torch.cli BSP 4 alexnet AlexNet --synthetic \
        --fused-update --slices 2 --strategy hier --wire-codec int8:ef ...

Steps in groups of 4, each step a replay of one captured CUDA graph of
the train step (one card, or NCCL ranks on several)::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet \
        --dataset imagenet_synthetic --fused-update --max-steps 22 \
        --steps-per-dispatch 4 --dataset-arg n_train=2816 --dataset-arg n_val=128

Theano-MPI's other two rules, each rank its own worker and
``--batch-size`` the per-worker batch: EASGD (elastic averaging with a
center, config #4's shape) and GoSGD (peer gossip, config #5's), with
worker groups of ``--group-size`` cards (BSP and cross-replica BN inside
a group)::

    python -m theanompi_tpu_torch.cli EASGD 4 resnet50 ResNet50 \
        --dataset imagenet_synthetic --fused-update --avg-freq 8 --max-steps 16 \
        --dataset-arg n_train=4096 --dataset-arg n_val=1024
    python -m theanompi_tpu_torch.cli EASGD 4 resnet50 ResNet50 ... --group-size 2
    python -m theanompi_tpu_torch.cli GOSGD 4 vgg16 VGG16 \
        --dataset imagenet_synthetic --fused-update --wire-codec int8 --max-steps 16 \
        --dataset-arg n_train=2048 --dataset-arg n_val=512

Fault tolerance (``launch/supervisor.py``, ``utils/faults.py``): up to 2
retries of a failed attempt, each resumed from the newest verified
checkpoint; an injected crash before step 5 and a truncated newest file;
per-rank sharded checkpoints and an elastic shrink from 2 ranks to 1;
SIGTERM grace (exit code 75, ``resumable.json``; the next supervised
invocation resumes by itself)::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --synthetic \
        --fused-update --max-steps 8 --ckpt-dir CKPT --max-retries 2 \
        --inject-fault crash@5 --inject-fault ckpt_truncate@4 --obs-dir OBS
    python -m theanompi_tpu_torch.cli BSP 2 alexnet AlexNet --synthetic \
        --device cuda:0 --backend gloo --wire-codec int8:ef --ckpt-dir CKPT \
        --ckpt-sharded --elastic --max-retries 1 --inject-fault shrink@5:1 ...
    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --synthetic \
        --ckpt-dir CKPT --max-retries 1 --sigterm-grace 30 --inject-fault sigterm@3 \
        --fault-ledger LEDGER ...

Tensor and sequence parallelism (``parallel/nd.py``): the LM over a
``(data, model, seq)`` mesh of ``n / (tp·sp)`` by ``--tp`` by ``--sp``
cards, one process a card over NCCL; ``--tp`` shards the heads, the FFN's
hidden units and the vocabulary (Megatron), ``--sp`` the sequence under
the attention of the recipe's ``attn`` (``ring_flash``, ``ulysses_flash``,
``ring`` or ``ulysses``; ``flash`` is refused under ``--sp``)::

    python -m theanompi_tpu_torch.cli BSP 4 transformer_lm TransformerLM_136M \
        --synthetic --tp 4 --max-steps 8
    python -m theanompi_tpu_torch.cli BSP 4 transformer_lm TransformerLM_136M \
        --synthetic --tp 2 --sp 2 --recipe-arg attn=ring_flash --max-steps 8
    python -m theanompi_tpu_torch.cli BSP 4 transformer_lm TransformerLM_136M \
        --synthetic --sp 2 --recipe-arg attn=ulysses_flash --max-steps 8

Runs on the CUDA card(s); ``--device cpu`` runs on the CPU instead
(ranks over gloo), ``--device cuda:0 --backend gloo`` puts every rank on
one card. Without a card and without ``--device cpu`` it fails. The
last line of stdout is rank 0's run summary as one JSON object.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.cli",
        description="Theano-MPI on PyTorch/CUDA: distributed training launcher",
        allow_abbrev=False,
    )
    p.add_argument("rule", choices=["BSP", "bsp", "EASGD", "easgd", "GOSGD", "gosgd"])
    p.add_argument("n_devices", type=int,
                   help="number of ranks: one process per card; BSP splits the global batch "
                        "across them, EASGD/GoSGD give each worker its own batch")
    p.add_argument("modelfile", help="zoo short name, module path or .py file")
    p.add_argument("modelclass", help="model class name (e.g. AlexNet)")
    p.add_argument("--fused-update", action="store_true",
                   help="fuse the optimizer epilogue (weight decay + clip + "
                        "momentum/Nesterov + param write) into one multi-tensor "
                        "CUDA kernel launch over all leaves (ops/fused_update.py); SGD-family "
                        "recipes only (momentum/nesterov/sgd)")
    p.add_argument("--pool-kernel", action="store_true",
                   help="run the model's 3x3/stride-1 max pools (GoogLeNet's inception "
                        "pool branches) through the pool kernels with Theano's "
                        "all-maxima backward (ops/pool.py); the reference's "
                        "TMPI_PALLAS_POOL=1")
    p.add_argument("--strategy", default="psum",
                   help="gradient exchange: psum, psum_bf16, ring, ring_bf16, ring_int8, "
                        "hier (aliases ar, nccl32, nccl16, asa32, asa16, ...). 'hier' is the "
                        "two-hop exchange of --slices N runs: reduce-scatter inside a "
                        "slice, all_reduce of the shard across slices (the only hop "
                        "--wire-codec compresses), all-gather inside the slice")
    p.add_argument("--wire-codec", default="none",
                   help="compress the exchange: none, bf16, int8, with ':ef' for error "
                        "feedback (psum only), e.g. int8:ef")
    p.add_argument("--slices", type=int, default=None,
                   help="the ranks form this many slices (rows of the (dcn, data) mesh: "
                        "ranks s*i .. s*i+s-1 are slice i); BatchNorm's 'data' axis is then "
                        "the slice, 'dcn' the ranks across slices")
    p.add_argument("--allreduce-buckets", type=float, default=0.0, metavar="MB",
                   help="cut the gradient exchange (psum or hier) into buckets of about MB "
                        "fp32 megabytes in reverse layer order, each posted from the "
                        "backward as soon as its gradients are made (with an ':ef' codec, "
                        "after the backward); 0: one exchange")
    p.add_argument("--tp", type=int, default=1,
                   help="LM models: tensor-parallel (Megatron) axis size: heads, FFN "
                        "hidden units and vocabulary sharded over it")
    p.add_argument("--sp", type=int, default=1,
                   help="LM models: sequence-parallel axis size (ring or "
                        "Ulysses attention per the recipe's attn=)")
    for flag, what in (("--pp", "GPipe pipeline stages"),
                       ("--expert", "expert-parallel axis size"),
                       ("--zero", "ZeRO-1 optimizer-state sharding")):
        p.add_argument(flag, type=int, default=None,
                       help=f"the reference's {what}: not ported yet (refused; ROADMAP.md)")
    p.add_argument("--avg-freq", type=int, default=None,
                   help="EASGD/GoSGD: steps between exchanges (reference avg_freq)")
    p.add_argument("--group-size", type=int, default=None,
                   help="EASGD/GoSGD: chips per worker — each async worker is "
                        "a data-parallel group (16 workers on 256 chips = "
                        "--group-size 16)")
    p.add_argument("--alpha", type=float, default=None, help="EASGD elastic rate")
    p.add_argument("--p-push", type=float, default=None, help="GoSGD push probability")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend of several ranks (default: nccl on the "
                        "cards, gloo on the CPU)")
    p.add_argument("--epochs", type=int, default=None, help="override recipe n_epochs")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="override recipe batch")
    p.add_argument("--dataset", default=None,
                   help="override the recipe's dataset: synthetic, imagenet_synthetic (uint8, "
                        "normalized on the card), imagenet (uint8 .npy shards: --dataset-arg "
                        "root=DIR), cifar10, digits, lm_synthetic, lm_text")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the seeded synthetic dataset (no data on disk); the "
                        "shortcut for --dataset synthetic")
    p.add_argument("--dataset-arg", action="append", default=[], metavar="K=V",
                   help="dataset constructor kwarg (repeatable)")
    p.add_argument("--recipe-arg", action="append", default=[], metavar="K=V",
                   help="recipe override (repeatable, JSON values), e.g. "
                        "--recipe-arg 'input_shape=[67,67,3]'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", default=None, help="recorder output dir (JSONL + pickle)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--sync-ckpt", action="store_true",
                   help="write epoch checkpoints synchronously instead "
                        "of on the background writer thread: the save "
                        "is durable before the next step dispatches "
                        "(deterministic durability for preemption-prone "
                        "runs, at the cost of stalling the loop for the "
                        "full gather+write)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--print-freq", type=int, default=40)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run the steps in groups of this many: on the card each step of a "
                        "group replays one captured CUDA graph of the train step (one host "
                        "call a step, no wait for the card inside a group); groups never "
                        "cross an epoch and the last one stops at --max-steps. Several "
                        "ranks on the cards need the nccl backend")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each rank's batch into this many "
                        "microbatches inside the step, their fp32 gradients averaged before "
                        "the one update (large-batch SGD at small-batch activation memory)")
    p.add_argument("--dispatch-depth", type=int, default=None,
                   help="keep at most K steps in flight before the host waits for the "
                        "oldest (utils/dispatch.py); 1 is the reference's per-step sync. "
                        "Default: no bound of its own, metrics read back every "
                        "--print-freq steps and at epoch ends (the rows are the same "
                        "either way; a sync every step costs the host's enqueue time on "
                        "every step)")
    p.add_argument("--ckpt-sharded", action="store_true",
                   help="per-rank sharded checkpoints: each rank writes only its own "
                        "part (ckpt_<step>.proc<r>of<n>.npz), with no gather and no "
                        "collective; a set loads under any rank count, and a crash "
                        "save runs on every rank")
    p.add_argument("--max-retries", type=int, default=0,
                   help="run under the fault-tolerant supervisor (launch/supervisor.py): "
                        "retry a failed run up to N times, each attempt resumed from the "
                        "newest VERIFIED checkpoint after a backoff (requires --ckpt-dir; "
                        "0 = no supervisor)")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   help="supervisor backoff base in seconds: retry k sleeps base * "
                        "2**(k-1), capped at 60s")
    p.add_argument("--retry-jitter", action="store_true",
                   help="decorrelated-jitter retry backoff instead of the plain "
                        "exponential ladder (sleep_k = uniform(base, 3*sleep_{k-1}), "
                        "capped): deterministic under --seed on one host, and the value "
                        "slept is recorded in the retry record")
    p.add_argument("--scrub-interval", type=float, default=0.0,
                   help="background checkpoint scrubber: re-verify the keep-chain every "
                        "N seconds and move corrupt members into <ckpt-dir>/quarantine/ "
                        "(0 = off; the supervisor still scrubs once before each retry)")
    p.add_argument("--fault-ledger", default=None, metavar="PATH",
                   help="fired-fault ledger file for --inject-fault: fired specs are "
                        "appended (fsynced before the fault's side effect) and specs "
                        "already in it arm as fired, so a fault fires once across "
                        "process relaunches")
    p.add_argument("--elastic", action="store_true",
                   help="elastic world size: with --max-retries every retry probes the "
                        "world again (n_devices is the cap) and reshards the newest "
                        "verified checkpoint onto it (utils/checkpoint.load_resharded); "
                        "with --resume alone, a one-shot resume of a checkpoint of "
                        "another world. Requires --ckpt-dir")
    p.add_argument("--elastic-lr-scale", choices=["none", "linear"], default="none",
                   help="with --elastic: scale the recipe's base LR by n_new / n_base on a "
                        "world change (for EASGD/GoSGD, whose global batch grows with the "
                        "world; BSP's global batch does not change, so 'none')")
    p.add_argument("--sigterm-grace", type=float, default=0.0,
                   help="preemption grace window in seconds: > 0 installs a SIGTERM "
                        "handler; the loop then checkpoints, marks the run resumable "
                        "(resumable.json in --ckpt-dir) and exits with code 75 instead of "
                        "dying mid-step (0 = default SIGTERM disposition)")
    p.add_argument("--inject-fault", action="append", default=[], metavar="KIND@STEP",
                   help="deterministic fault injection (repeatable; utils/faults.py): "
                        "crash@K, sigterm@K, sigkill@K, ckpt_truncate@K, nan_batch@K, "
                        "loader_stall@K:S, shrink@K:W, grow@K:W, slice_down@K, enospc@K, "
                        "slow_write@K:S, bitrot@K, partial_set@K; each fires once")
    p.add_argument("--obs-dir", default=None,
                   help="observability output dir; until the port's observability slice "
                        "it holds only the supervisor's records (supervisor.jsonl, "
                        "metrics.jsonl)")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU, 'cuda:K' to put every rank on card K; "
                        "default: card r for rank r")
    return p


def _parse_kv(pairs, flag) -> dict:
    out = {}
    for kv in pairs:
        k, sep, v = kv.partition("=")
        if not sep:
            raise SystemExit(f"{flag} expects K=V, got {kv!r}")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            try:
                out[k] = ast.literal_eval(v)  # Python literals: (16,16,3)
            except (ValueError, SyntaxError):
                out[k] = v
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(list(argv) if argv is not None else sys.argv[1:])
    if args.synthetic and args.dataset not in (None, "synthetic"):
        parser.error(f"--synthetic is --dataset synthetic; it contradicts --dataset {args.dataset}")

    from theanompi_tpu_torch.launch.session import launch_training
    from theanompi_tpu_torch.utils.faults import Preempted

    for flag, on in (("--max-retries", args.max_retries), ("--elastic", args.elastic),
                     ("--sigterm-grace", args.sigterm_grace)):
        if on and not args.ckpt_dir:
            raise SystemExit(f"{flag} requires --ckpt-dir (retries, reshards and the grace "
                             "window all resume from a checkpoint)")
    if args.scrub_interval and not args.ckpt_dir:
        print("WARNING: --scrub-interval needs --ckpt-dir; the checkpoint scrubber is off",
              flush=True)
    for flag in ("pp", "expert", "zero"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not ported yet: ROADMAP.md queue 1 items 1 and 3 (the "
                         "port trains --tp and --sp over the (data, model, seq) mesh)")
    if args.dispatch_depth is not None and args.dispatch_depth < 1:
        parser.error(f"--dispatch-depth must be >= 1, got {args.dispatch_depth}")

    rule_kwargs = {k: getattr(args, k) for k in ("avg_freq", "group_size", "alpha", "p_push")
                   if getattr(args, k) is not None}

    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    for k, v in _parse_kv(args.recipe_arg, "--recipe-arg").items():
        overrides[k] = tuple(v) if isinstance(v, list) else v  # shapes are tuples
    dataset_kwargs = _parse_kv(args.dataset_arg, "--dataset-arg")
    if "image_shape" in dataset_kwargs:
        dataset_kwargs["image_shape"] = tuple(dataset_kwargs["image_shape"])

    if args.max_retries > 0:
        from theanompi_tpu_torch.launch.supervisor import supervise_training

        def run(*a, **kw):
            return supervise_training(*a, max_retries=args.max_retries,
                                      backoff_base=args.retry_backoff,
                                      retry_jitter=args.retry_jitter, obs_dir=args.obs_dir, **kw)
    else:
        run = launch_training
    try:
        summary = run(
            args.rule.lower(),
            args.n_devices,
            args.modelfile,
            args.modelclass,
            backend=args.backend,
            device=args.device,
            fused_update=args.fused_update,
            pool_kernel=args.pool_kernel,
            strategy=args.strategy,
            wire_codec=args.wire_codec,
            n_epochs=args.epochs,
            max_steps=args.max_steps,
            dataset="synthetic" if args.synthetic else args.dataset,
            dataset_kwargs=dataset_kwargs,
            recipe_overrides=overrides,
            seed=args.seed,
            save_dir=args.save_dir,
            ckpt_dir=args.ckpt_dir,
            async_checkpoint=not args.sync_ckpt,
            resume=args.resume,
            print_freq=args.print_freq,
            steps_per_dispatch=args.steps_per_dispatch,
            accum_steps=args.accum_steps,
            n_slices=args.slices,
            allreduce_buckets=args.allreduce_buckets,
            dispatch_depth=args.dispatch_depth,
            ckpt_sharded=args.ckpt_sharded,
            scrub_interval=args.scrub_interval,
            elastic=args.elastic,
            elastic_lr_scale=args.elastic_lr_scale,
            sigterm_grace=args.sigterm_grace,
            inject_faults=args.inject_fault or None,
            fault_ledger=args.fault_ledger,
            tp=args.tp,
            sp=args.sp,
            **rule_kwargs,
        )
    except Preempted as e:
        # checkpointed and marked resumable inside the grace window: a
        # retryable exit (EX_TEMPFAIL); the next supervised invocation
        # resumes from the marker
        print(json.dumps({"preempted": True, "step": e.step, "resumable": True}))
        return 75
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
