"""Command-line launcher of the port (training subcommand).

Port of ``theanompi_tpu/cli.py``'s training path::

    python -m theanompi_tpu_torch.cli BSP 1 alexnet AlexNet --synthetic \\
        --fused-update --max-steps 10 \\
        --dataset-arg 'image_shape=[227,227,3]' --dataset-arg n_classes=1000 \\
        --dataset-arg n_train=1280 --dataset-arg n_val=128

Runs on the CUDA card; ``--device cpu`` runs on the CPU instead (without
a card and without that flag it fails). The last line of stdout is the
run summary as one JSON object.
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
    p.add_argument("n_devices", type=int, help="number of cards (this slice: 1)")
    p.add_argument("modelfile", help="zoo short name, module path or .py file")
    p.add_argument("modelclass", help="model class name (e.g. AlexNet)")
    p.add_argument("--fused-update", action="store_true",
                   help="fuse the optimizer epilogue (weight decay + clip + "
                        "momentum/Nesterov + param write) into one CUDA kernel "
                        "launch per leaf (ops/fused_update.py); SGD-family "
                        "recipes only (momentum/nesterov/sgd)")
    p.add_argument("--epochs", type=int, default=None, help="override recipe n_epochs")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="override recipe batch")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the seeded synthetic dataset (no data on disk)")
    p.add_argument("--dataset-arg", action="append", default=[], metavar="K=V",
                   help="dataset constructor kwarg (repeatable)")
    p.add_argument("--recipe-arg", action="append", default=[], metavar="K=V",
                   help="recipe override (repeatable, JSON values), e.g. "
                        "--recipe-arg 'input_shape=[67,67,3]'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-freq", type=int, default=40)
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: the CUDA card")
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
    args = build_parser().parse_args(list(argv) if argv is not None else sys.argv[1:])

    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.launch.worker import run_training

    model_cls = resolve_model(args.modelfile, args.modelclass)
    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    for k, v in _parse_kv(args.recipe_arg, "--recipe-arg").items():
        overrides[k] = tuple(v) if isinstance(v, list) else v  # shapes are tuples
    dataset_kwargs = _parse_kv(args.dataset_arg, "--dataset-arg")
    if "image_shape" in dataset_kwargs:
        dataset_kwargs["image_shape"] = tuple(dataset_kwargs["image_shape"])

    summary = run_training(
        rule=args.rule.lower(),
        model_cls=model_cls,
        devices=args.n_devices,
        device=args.device,
        fused_update=args.fused_update,
        n_epochs=args.epochs,
        max_steps=args.max_steps,
        dataset="synthetic" if args.synthetic else None,
        dataset_kwargs=dataset_kwargs,
        recipe_overrides=overrides,
        seed=args.seed,
        print_freq=args.print_freq,
    )
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
