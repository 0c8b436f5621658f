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

Steps in groups of 4, each step a replay of one captured CUDA graph of
the train step (one card)::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet \
        --dataset imagenet_synthetic --fused-update --max-steps 22 \
        --steps-per-dispatch 4 --dataset-arg n_train=2816 --dataset-arg n_val=128

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
    p.add_argument("rule", choices=["BSP", "bsp"])
    p.add_argument("n_devices", type=int,
                   help="number of ranks: one process per card, the global batch split across them")
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
                   help="gradient exchange: psum, psum_bf16, ring, ring_bf16, ring_int8 "
                        "(aliases ar, nccl32, nccl16, asa32, asa16, ...)")
    p.add_argument("--wire-codec", default="none",
                   help="compress the exchange: none, bf16, int8, with ':ef' for error "
                        "feedback (psum only), e.g. int8:ef")
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
                        "cross an epoch and the last one stops at --max-steps. One rank "
                        "only on the card for now")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each rank's batch into this many "
                        "microbatches inside the step, their fp32 gradients averaged before "
                        "the one update (large-batch SGD at small-batch activation memory)")
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

    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    for k, v in _parse_kv(args.recipe_arg, "--recipe-arg").items():
        overrides[k] = tuple(v) if isinstance(v, list) else v  # shapes are tuples
    dataset_kwargs = _parse_kv(args.dataset_arg, "--dataset-arg")
    if "image_shape" in dataset_kwargs:
        dataset_kwargs["image_shape"] = tuple(dataset_kwargs["image_shape"])

    summary = launch_training(
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
    )
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
