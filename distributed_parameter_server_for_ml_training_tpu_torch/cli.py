"""Command-line interface of the port.

The in-process ``train`` verb in its baseline, sync, async and sp modes,
with the JAX verb's flags that they honour, plus ``--device``::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode baseline --epochs 1 --synthetic --num-train 2048 \\
        --num-test 500 --emit-metrics

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sync --workers 4 --compression int8 --epochs 1 \\
        --synthetic --num-train 2048 --num-test 500 --emit-metrics

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sp --model vit_b16 --dataset imagenet-synth \\
        --image-size 1024 --workers 2 --batch-size 8 --num-train 8 \\
        --num-test 8 --epochs 1 --emit-metrics

It runs on the card unless ``--device cpu`` is given. ``--mode baseline``
is the reference's single-device recipe (SGD with momentum and weight
decay under MultiStepLR, ``train/baseline.py``); ``--plot`` saves its
results plot, and ``--checkpoint-dir``/``--resume`` are refused until the
checkpoint slice. ``--mode sync``
trains the worker slots of one card with the all-reduce chosen by
``--compression`` (int8 = the quantized reduce-scatter ring, kernels
K2-K4); ``--mode async`` runs the host parameter store with worker
threads, pushing with the store's default codec (fp16, the reference's
cast). ``--mode sp`` trains ``--model vit_tiny|vit_b16`` sequence-parallel
over ``--workers`` sequence slots of one card (ring attention, the flash
kernels K5-K7 per hop from 2,048 tokens per slot); ``--dataset
imagenet-synth --image-size N`` gives it ImageNet-shaped synthetic
images. The default mode stays ``async`` (the JAX CLI's is ``sync``) until
the port has all of the JAX CLI's modes.
"""

from __future__ import annotations

import argparse
import os
import sys


def _env(name: str, default, cast=str):
    v = os.environ.get(name)
    return cast(v) if v is not None else default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_parameter_server_for_ml_training_tpu_torch",
        description="PyTorch/CUDA parameter-server training")
    sub = p.add_subparsers(dest="command", required=True)
    t = sub.add_parser("train", help="in-process training run")
    t.add_argument("--mode", choices=["baseline", "sync", "async", "sp"],
                   default="async",
                   help="baseline = the reference's single-device recipe; "
                        "sync = sync data parallelism over the worker "
                        "slots of one card; async = host parameter store + "
                        "worker threads (the reference's modes); sp = "
                        "sequence-parallel ViT (ring attention over "
                        "--workers sequence slots of one card). The "
                        "default stays async until the port has all of "
                        "the JAX CLI's modes (its default is sync)")
    t.add_argument("--workers", type=int,
                   default=_env("TOTAL_WORKERS_EXPECTED", 4, int))
    t.add_argument("--staleness-bound", type=int,
                   default=_env("STALENESS_BOUND", 5, int))
    t.add_argument("--lr", type=float,
                   default=_env("LEARNING_RATE", 0.1, float),
                   help="server SGD learning rate (server.py:413)")
    t.add_argument("--epochs", type=int, default=_env("NUM_EPOCHS", 3, int))
    t.add_argument("--compression", choices=["none", "bf16", "fp16", "int8"],
                   default="bf16",
                   help="sync all-reduce precision (int8 = quantized "
                        "reduce-scatter ring, ~half bf16's bytes)")
    t.add_argument("--batch-size", type=int,
                   default=_env("BATCH_SIZE", 128, int),
                   help="per-worker batch size (worker.py:462)")
    t.add_argument("--data-dir", default=os.environ.get("CIFAR100_DIR"))
    t.add_argument("--synthetic", action="store_true",
                   help="force the synthetic dataset (no-network envs)")
    t.add_argument("--num-train", type=int, default=None,
                   help="truncate train set (quick runs)")
    t.add_argument("--num-test", type=int, default=None,
                   help="truncate test set (quick runs)")
    t.add_argument("--no-augment", action="store_true")
    t.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    t.add_argument("--model", choices=["resnet18", "vit_b16", "vit_tiny"],
                   default="resnet18",
                   help="baseline trains any; sync and async train "
                        "resnet18; sp a ViT")
    t.add_argument("--dataset", choices=["cifar100", "imagenet-synth"],
                   default="cifar100",
                   help="imagenet-synth = ImageNet-shaped synthetic data "
                        "(1,000 classes) at --image-size")
    t.add_argument("--image-size", type=int, default=224,
                   help="imagenet-synth resolution")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--emit-metrics", action="store_true",
                   help="print METRICS_JSON lines (server.py:367)")
    t.add_argument("--plot", default=None,
                   help="save a results plot (png; baseline)")
    t.add_argument("--checkpoint-dir", default=None,
                   help="save checkpoints each epoch (the checkpoint "
                        "slice; refused until then)")
    t.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    return p


def _load_dataset(args):
    from .data import load_cifar100, synthetic_cifar100, synthetic_imagenet

    if args.dataset == "imagenet-synth":
        ds = synthetic_imagenet(n_train=args.num_train or 10_000,
                                n_test=args.num_test or 1_000,
                                image_size=args.image_size)
    elif args.synthetic:
        ds = synthetic_cifar100()
    else:
        ds = load_cifar100(args.data_dir)
    if args.num_train:
        ds.x_train = ds.x_train[:args.num_train]
        ds.y_train = ds.y_train[:args.num_train]
    if args.num_test:
        ds.x_test = ds.x_test[:args.num_test]
        ds.y_test = ds.y_test[:args.num_test]
    return ds


def cmd_train(args) -> int:
    from .train.distributed import (AsyncTrainer, DistributedConfig,
                                    SyncTrainer)

    if args.mode in ("sync", "async") and args.model != "resnet18":
        raise SystemExit(f"--mode {args.mode} trains resnet18 in the port; "
                         f"--model {args.model} runs with --mode sp or "
                         f"baseline")
    dataset = _load_dataset(args)
    if dataset.synthetic and args.dataset == "cifar100" \
            and not args.synthetic:
        print("note: CIFAR-100 not found on disk; using the synthetic "
              "dataset", file=sys.stderr)
    if args.mode == "baseline":
        from .train.baseline import BaselineConfig, BaselineTrainer
        cfg = BaselineConfig(batch_size=args.batch_size,
                             num_epochs=args.epochs, learning_rate=args.lr,
                             augment=not args.no_augment, dtype=args.dtype,
                             model=args.model,
                             num_classes=dataset.num_classes,
                             seed=args.seed, device=args.device)
        BaselineTrainer(dataset, cfg).train(
            plot_path=args.plot, emit_metrics=args.emit_metrics,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume)
        return 0
    if args.checkpoint_dir or args.resume:
        raise NotImplementedError(
            f"--mode {args.mode} checkpoints come with the checkpoint slice")
    if args.mode == "sp":
        from .train.model_parallel import ModelParallelConfig, SPTrainer
        mp_cfg = ModelParallelConfig(
            model=args.model, num_workers=args.workers,
            learning_rate=args.lr, num_epochs=args.epochs,
            batch_size=args.batch_size, augment=not args.no_augment,
            num_classes=dataset.num_classes, dtype=args.dtype,
            seed=args.seed, device=args.device)
        metrics = SPTrainer(dataset, mp_cfg).train(
            emit_metrics=args.emit_metrics)
        print(f"done: {metrics}", file=sys.stderr)
        return 0
    cfg = DistributedConfig(
        mode=args.mode, num_workers=args.workers, learning_rate=args.lr,
        num_epochs=args.epochs, batch_size=args.batch_size,
        staleness_bound=args.staleness_bound,
        compression=args.compression,
        augment=not args.no_augment, dtype=args.dtype,
        num_classes=dataset.num_classes, seed=args.seed,
        device=args.device)
    trainer = SyncTrainer if args.mode == "sync" else AsyncTrainer
    metrics = trainer(dataset, cfg).train(emit_metrics=args.emit_metrics)
    print(f"done: {metrics}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
