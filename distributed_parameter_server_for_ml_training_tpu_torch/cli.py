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

The verbs ``serve`` and ``worker`` are the reference's own topology: a
gRPC parameter server over the host NumPy store (``comms/service.py``)
and remote workers that train on the card and push to it
(``comms/client.py:RemoteStore``)::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        serve --mode async --workers 2 --push-codec int8 --port 8000 \
        --emit-metrics
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        worker --server 127.0.0.1:8000 --synthetic --num-train 2048 \
        --epochs 1 --emit-metrics

Each package's workers train against the other package's server. The
server draws the initial ResNet-18 weights with the port's ``get_model``
(a torch generator seeded with ``--seed``), so they differ from the JAX
server's flax initialization for the same seed. The flags of the JAX
verbs that name features of later slices are accepted and refused with
the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import os
import sys


def _env(name: str, default, cast=str):
    v = os.environ.get(name)
    return cast(v) if v is not None else default


def _add_common(q) -> None:
    """The data, batch and device flags of the verbs that train."""
    q.add_argument("--lr", type=float,
                   default=_env("LEARNING_RATE", 0.1, float),
                   help="server SGD learning rate (server.py:413)")
    q.add_argument("--epochs", type=int, default=_env("NUM_EPOCHS", 3, int))
    q.add_argument("--batch-size", type=int,
                   default=_env("BATCH_SIZE", 128, int),
                   help="per-worker batch size (worker.py:462)")
    q.add_argument("--data-dir", default=os.environ.get("CIFAR100_DIR"))
    q.add_argument("--synthetic", action="store_true",
                   help="force the synthetic dataset (no-network envs)")
    q.add_argument("--num-train", type=int, default=None,
                   help="truncate train set (quick runs)")
    q.add_argument("--num-test", type=int, default=None,
                   help="truncate test set (quick runs)")
    q.add_argument("--no-augment", action="store_true")
    q.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    q.add_argument("--dataset", choices=["cifar100", "imagenet-synth"],
                   default="cifar100",
                   help="imagenet-synth = ImageNet-shaped synthetic data "
                        "(1,000 classes) at --image-size")
    q.add_argument("--image-size", type=int, default=224,
                   help="imagenet-synth resolution")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--emit-metrics", action="store_true",
                   help="print METRICS_JSON lines (server.py:367)")
    q.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")


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
    t.add_argument("--compression", choices=["none", "bf16", "fp16", "int8"],
                   default="bf16",
                   help="sync all-reduce precision (int8 = quantized "
                        "reduce-scatter ring, ~half bf16's bytes)")
    t.add_argument("--model", choices=["resnet18", "vit_b16", "vit_tiny"],
                   default="resnet18",
                   help="baseline trains any; sync and async train "
                        "resnet18; sp a ViT")
    t.add_argument("--plot", default=None,
                   help="save a results plot (png; baseline)")
    t.add_argument("--checkpoint-dir", default=None,
                   help="save checkpoints each epoch (the checkpoint "
                        "slice; refused until then)")
    t.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    _add_common(t)

    s = sub.add_parser("serve", help="gRPC parameter server")
    s.add_argument("--mode", choices=["sync", "async"],
                   default=_env("SERVER_MODE", "sync"))
    s.add_argument("--workers", type=int,
                   default=_env("TOTAL_WORKERS_EXPECTED", 4, int))
    s.add_argument("--port", type=int, default=_env("SERVER_PORT", 8000, int))
    s.add_argument("--staleness-bound", type=int,
                   default=_env("STALENESS_BOUND", 5, int))
    s.add_argument("--lr", type=float,
                   default=_env("LEARNING_RATE", 0.1, float))
    s.add_argument("--num-classes", type=int, default=100)
    s.add_argument("--model", choices=["resnet18", "resnet50", "vit_b16",
                                       "vit_tiny"],
                   default="resnet18",
                   help="must match the workers' --model (the store is "
                        "keyed by parameter names); the port serves "
                        "resnet18")
    s.add_argument("--image-size", type=int, default=32,
                   help="input resolution used to init the store's params")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--emit-metrics", action="store_true")
    s.add_argument("--push-codec",
                   choices=["default", "fp16", "int8", "int4", "topk",
                            "adaptive", "none"],
                   default="default",
                   help="wire codec workers apply before push ('default' = "
                        "fp16, the reference's cast)")
    s.add_argument("--no-compressed-domain", action="store_true",
                   help="decode every quantized push to fp32 before "
                        "aggregating instead of accumulating in the "
                        "quantized domain")
    s.add_argument("--fetch-codec", choices=["none", "bf16", "fp16"],
                   default="none")
    s.add_argument("--store-backend", choices=["python", "native", "device"],
                   default="python")
    s.add_argument("--elastic", action="store_true")
    s.add_argument("--worker-timeout", type=float, default=None)
    s.add_argument("--sync-quorum", type=float, default=None)
    s.add_argument("--round-deadline", type=float, default=None)
    s.add_argument("--checkpoint-dir", default=None)
    s.add_argument("--restore", action="store_true")
    s.add_argument("--faults", default=None)
    s.add_argument("--jobs", default=None)

    w = sub.add_parser("worker", help="gRPC remote worker")
    w.add_argument("--server",
                   default=_env("PARAMETER_SERVER_ADDRESS",
                                "localhost:8000"),
                   help="PS address (worker.py:457-459)")
    w.add_argument("--worker-name", default=_env("WORKER_NAME", ""))
    w.add_argument("--sync-steps", type=int,
                   default=_env("SYNC_STEPS", 1, int))
    w.add_argument("--k-step-mode", choices=["faithful", "accumulate"],
                   default="faithful")
    w.add_argument("--no-delta-fetch", action="store_true",
                   help="full params on every fetch (reference parity)")
    w.add_argument("--no-error-feedback", action="store_true",
                   help="disable the quantized codecs' error feedback")
    w.add_argument("--topk-frac", type=float,
                   default=_env("DPS_TOPK_FRAC", 0.01, float),
                   help="fraction of entries a topk push keeps per tensor")
    w.add_argument("--model", choices=["resnet18", "resnet50", "vit_b16",
                                       "vit_tiny"],
                   default="resnet18")
    _add_common(w)
    w.add_argument("--shards", default=None)
    w.add_argument("--job", default=None)
    w.add_argument("--heartbeat", type=float, default=0.0)
    w.add_argument("--overlap", action="store_true")
    w.add_argument("--reconnect-timeout", type=float, default=0.0)
    w.add_argument("--faults", default=None)
    return p


#: Flags of the JAX verbs whose features come with later slices, by the
#: ROADMAP item that brings them; any value but the default is refused.
LATER_FLAGS = {
    "elastic": "ROADMAP §1 item 3 (elastic membership)",
    "worker_timeout": "ROADMAP §1 item 3 (membership expiry)",
    "sync_quorum": "ROADMAP §1 item 3 (quorum rounds)",
    "round_deadline": "ROADMAP §1 item 3 (deadline rounds)",
    "fetch_codec": "ROADMAP §1 item 3 (the store's fetch codecs)",
    "heartbeat": "ROADMAP §1 item 3 (the worker's heartbeat)",
    "overlap": "ROADMAP §1 item 3 (the overlapped comms pipeline)",
    "reconnect_timeout": "ROADMAP §1 item 3 (session resume)",
    "checkpoint_dir": "ROADMAP §1 item 5 (checkpoints)",
    "restore": "ROADMAP §1 item 5 (checkpoints)",
    "faults": "ROADMAP §1 item 9 (comms/faults.py)",
    "jobs": "ROADMAP §1 item 9 (tenancy)",
    "job": "ROADMAP §1 item 9 (tenancy)",
    "shards": "ROADMAP §1 item 9 (the sharded tier)",
    "store_backend": "ROADMAP §1 items 4 and 9 (the device store and the "
                     "C++ arena)",
}
_FLAG_DEFAULTS = {"fetch_codec": "none", "store_backend": "python"}


def _refuse_later_flags(args) -> None:
    """Raise for the first flag of a later slice given a value other than
    its default (None, False, 0 or the listed default)."""
    for name, item in LATER_FLAGS.items():
        value = getattr(args, name, None)
        if value in (None, False, _FLAG_DEFAULTS.get(name)):
            continue
        flag = "--" + name.replace("_", "-")
        raise NotImplementedError(
            f"{flag} {value!r} is not ported yet; it comes with {item}")


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


def cmd_serve(args) -> int:
    """The gRPC parameter server over the host NumPy store; exits when
    every registered worker has sent JobFinished."""
    import time

    from .comms.service import ParameterService, serve
    from .models import get_model
    from .ps import make_store
    from .ps.store import StoreConfig
    from .utils.metrics import emit_metrics_json
    from .utils.pytree import params_to_jax

    _refuse_later_flags(args)
    if args.model != "resnet18":
        raise SystemExit(f"serve: the port's parameter server serves "
                         f"resnet18; --model {args.model} is not served")
    # The store lives on the host: the model is built on the CPU only to
    # draw its initial weights (get_model draws them from a CPU generator
    # on every device, so a worker's AsyncTrainer on the card starts from
    # the same weights for the same seed).
    model = get_model(args.model, num_classes=args.num_classes,
                      image_size=args.image_size, device="cpu",
                      seed=args.seed)
    flat, _ = params_to_jax(model)
    store = make_store(
        args.store_backend, flat,
        StoreConfig(mode=args.mode, total_workers=args.workers,
                    learning_rate=args.lr,
                    staleness_bound=args.staleness_bound,
                    push_codec=(None if args.push_codec == "default"
                                else args.push_codec),
                    compressed_domain=not args.no_compressed_domain))
    svc = ParameterService(store)
    server, port = serve(store, port=args.port, service=svc)
    print(f"parameter server up on :{port} (mode={store.config.mode}, "
          f"workers={args.workers}, backend={args.store_backend})",
          file=sys.stderr, flush=True)
    try:
        while not store.wait_all_finished(timeout=1.0):
            pass
        time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(grace=2.0)
    if args.emit_metrics:
        emit_metrics_json(store.metrics())
    return 0


def cmd_worker(args) -> int:
    """One remote worker: trains on ``--device`` (the card unless asked
    for the CPU) against the server at ``--server``."""
    from .comms.client import RemoteStore
    from .models import get_model
    from .ps.worker import PSWorker, WorkerConfig
    from .utils.metrics import emit_metrics_json

    _refuse_later_flags(args)
    if args.model != "resnet18":
        raise SystemExit(f"worker: the port's remote worker trains "
                         f"resnet18; --model {args.model} is not served")
    cfg = WorkerConfig(batch_size=args.batch_size, num_epochs=args.epochs,
                       sync_steps=args.sync_steps,
                       k_step_mode=args.k_step_mode,
                       augment=not args.no_augment, seed=args.seed,
                       delta_fetch=not args.no_delta_fetch,
                       error_feedback=not args.no_error_feedback,
                       topk_frac=args.topk_frac, device=args.device)
    dataset = _load_dataset(args)
    model = get_model(args.model, num_classes=dataset.num_classes,
                      dtype=args.dtype, image_size=dataset.x_train.shape[1],
                      device=args.device, seed=args.seed)
    store = RemoteStore(args.server)
    worker = PSWorker(store, model, dataset, cfg,
                      worker_name=args.worker_name)
    worker.start()
    worker.join()
    store.close()
    if worker.result.error is not None:
        raise worker.result.error
    if args.emit_metrics:
        emit_metrics_json(worker.result.metrics(
            total_workers=0, learning_rate=args.lr, config=cfg))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "serve": cmd_serve,
            "worker": cmd_worker}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
