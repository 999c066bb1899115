"""Command-line interface of the port.

The in-process ``train`` verb in its baseline, sync, async, pp, sp and
moe modes, with the JAX verb's flags that they honour, plus
``--device``::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode baseline --epochs 1 --synthetic --num-train 2048 \\
        --num-test 500 --emit-metrics

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sync --workers 4 --compression int8 --epochs 1 \\
        --synthetic --num-train 2048 --num-test 500 --emit-metrics

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode baseline --model resnet50 --dataset imagenet-synth \\
        --num-train 1024 --num-test 256 --epochs 1

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sync --model vit_b16 --dataset imagenet-synth \\
        --workers 4 --batch-size 32 --compression int8 --num-train 1024 \\
        --num-test 256 --epochs 1

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sp --model vit_b16 --dataset imagenet-synth \\
        --image-size 1024 --workers 2 --batch-size 8 --num-train 8 \\
        --num-test 8 --epochs 1 --emit-metrics

It runs on the card unless ``--device cpu`` is given. Every mode but
``sp`` trains any registry model (``--model resnet18|resnet50|vit_b16|
vit_tiny``; the ResNets take the ImageNet stem from 96 px up, so
``--dataset imagenet-synth`` gives ResNet-50 at 224 px); ``sp`` trains a
ViT. ``--mode baseline``
is the reference's single-device recipe (SGD with momentum and weight
decay under MultiStepLR, ``train/baseline.py``); ``--plot`` saves its
results plot. In every mode ``--checkpoint-dir`` saves a checkpoint each
epoch (in async mode, snapshots of the store) and ``--resume`` continues
from the newest one there. ``--mode sync`` trains the worker slots of
one card with the all-reduce chosen by ``--compression`` (int8 = the
quantized reduce-scatter ring, kernels K2-K4). ``--mode async`` runs the
host parameter store with worker threads, pushing with the store's
default codec (fp16, the reference's cast), or with ``--store-backend
device`` the device-resident store, whose pushes and fetches move no
bytes over the host link; ``--strict-rounds`` reaches the store's config
as in the JAX CLI. ``--mode sp`` trains ``--model vit_tiny|vit_b16``
sequence-parallel over ``--workers`` sequence slots of one card (ring
attention, the flash kernels K5-K7 per hop from 2,048 tokens per slot);
``--dataset imagenet-synth --image-size N`` gives it ImageNet-shaped
synthetic images. ``--mode moe`` trains the ViT with a Switch-MoE MLP of
``--workers`` experts in every block, one a slot of one card
(``--moe-capacity-factor``, ``--moe-aux-weight``); ``--mode pp`` trains
the CLS ViT as ``--workers`` pipeline stages of one card over
``--pp-microbatches`` microbatches (GPipe)::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        train --mode moe --model vit_b16 --dataset imagenet-synth \
        --workers 4 --batch-size 32 --num-train 256 --num-test 64 --epochs 1

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        train --mode pp --model vit_b16 --dataset imagenet-synth \
        --workers 4 --pp-microbatches 8 --batch-size 32 --num-train 256 \
        --num-test 64 --epochs 1

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        train --mode tp --model vit_b16 --dataset imagenet-synth \
        --workers 2 --tp-degree 2 --batch-size 32 --num-train 256 \
        --num-test 64 --epochs 1

``--mode tp`` runs a ``(data, model)`` mesh of ``--workers`` x
``--tp-degree`` slots on one card; ``--dp-degree`` composes a ``data``
axis with ``--mode pp`` (each microbatch split over it) and ``--mode
moe`` (dp x ep), and ``--pp-tp-degree`` splits the pipeline's stages over
a ``model`` axis (dp x tp x pp). ``--mode sync --multihost`` runs one process per card
(``parallel/multihost.py``): each process is started with
``--coordinator host:port --num-processes R --process-id r`` (or the
``DPS_*`` env), ``--workers`` counts the slots of all R processes, and
``--dist-backend gloo`` puts two processes on one card::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sync --multihost --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 0 --workers 8 --compression int8 \\
        --synthetic --epochs 1

The CLI's default mode stays ``async`` (the JAX CLI's is ``sync``) until
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

Each package's workers train against the other package's server. Both
verbs take any registry model; the server's ``--model``,
``--num-classes`` and ``--image-size`` must match the workers' (the
store is keyed by parameter names, and the image size picks a ResNet's
stem and a ViT's position embedding). The server draws the initial
weights with the port's ``get_model`` (a torch generator seeded with
``--seed``), so they differ from the JAX server's flax initialization
for the same seed.

``serve`` takes the store's options: ``--fetch-codec bf16|fp16``,
``--elastic``, ``--worker-timeout``, for sync rounds ``--sync-quorum``
and ``--round-deadline``, ``--store-backend device`` (the store on
``--device``, the card by default), and durable server state:
``--checkpoint-dir D`` snapshots the store and its push-token journal
every ``--checkpoint-interval`` seconds and at exit (SIGTERM included),
and ``--restore`` resumes from the newest snapshot in D, so a worker's
retry of a push the old server applied is answered as a duplicate.
``worker`` (and ``train --mode async``) take ``--k-step-mode local_sgd``
with ``--local-lr``, ``--overlap`` (the comms pipeline), ``--heartbeat``
and ``--reconnect-timeout`` (session resume)::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        serve --mode async --workers 2 --push-codec int8 --fetch-codec bf16 \
        --worker-timeout 30 --port 8000
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        worker --server 127.0.0.1:8000 --synthetic --k-step-mode local_sgd \
        --sync-steps 4 --overlap --heartbeat 1 --reconnect-timeout 60

``serve`` runs the cluster health monitor by default, as the JAX verb
does (``--no-health-monitor`` opts out; ``--health-interval``,
``--dead-after``, ``--straggler-lag``), with the SLO evaluator attached
unless ``--no-slo`` (the ``--slo-*`` flags). Workers then piggyback a
health report on every fetch, push and heartbeat. ``--remediate`` turns
the monitor's alerts into actions (``telemetry/remediation.py``): a
worker whose report flags a non-finite loss or gradient has that push
refused before the apply, is quarantined for ``--quarantine-secs`` and
told to skip pushes, reset its error feedback and refetch;
``--remediate-dry-run`` records every decision and executes none::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        serve --mode async --workers 2 --push-codec fp16 --remediate \
        --port 8000

Every verb takes the JAX CLI's telemetry flags (``--telemetry``,
``--telemetry-interval``, ``--metrics-port``, ``--trace``,
``--trace-buffer``, ``--trace-dump-dir``, ``--journal-dir``) and
``--profile-dir``, a ``torch.profiler`` capture of its loop on
``--device``. ``serve`` runs memory telemetry with its monitor (unless
``--no-memory-telemetry``), freezes incident bundles on critical alerts
(``--incidents-dir``) and captures profile windows on SLO-burn and
goodput-drop edges (``--profile-triggers``). ``perf profile`` attributes
a capture per op class and ``perf diff`` compares two artifacts::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        train --mode baseline --epochs 1 --synthetic --num-train 1024 \
        --num-test 128 --profile-dir prof
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        perf profile --profile-dir prof --out a.json

The fleet observatory and the forensics verbs read what those surfaces
serve and write, as the JAX verbs do: ``observe`` scrapes the metrics
ports it is given (and the replicas their ``/cluster`` views announce)
and serves ``GET /fleet``; ``status`` renders one ``/cluster`` or, with
``--via-fleet``, a ``/fleet``; ``top`` renders ``/fleet`` live or, with
``--replay``, from observe's journal; ``incident list|show|report``
reads ``--incidents-dir`` bundles; ``query`` and ``goodput`` answer from
a journal and from a live ``/metrics.json``. ``experiments`` runs the
sync/async matrix on ``--device`` (or ingests a pod's logs with
``--ingest-pod``)::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        observe --targets 127.0.0.1:9400,127.0.0.1:9401 --port 9500 \
        --journal-dir fleet-journal
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        top --url 127.0.0.1:9500
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        incident report --dir incidents
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        experiments --modes sync,async --worker-counts 2 --epochs 1 \
        --synthetic --num-train 512 --no-plots --out-dir results

The serve tier: ``replica`` mirrors a primary (or, with ``--parent``,
another replica: a fan-out tree) and serves its payload bytes verbatim,
``--canary`` splitting ``infer`` fetches between a stable and a candidate
step; ``loadgen`` drives fetches at a tier and prints ``LOADGEN_JSON``;
``infer`` sends inference fetches with quality feedback; ``serve
--autoscale`` grows and shrinks a pool of ``cli replica`` children from
the measured fetch QPS; ``--faults`` (serve, worker, replica) injects a
seeded fault schedule (``comms/faults.py``)::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        replica --primary 127.0.0.1:8000 --port 8100 --canary
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        replica --primary 127.0.0.1:8000 --parent 127.0.0.1:8100
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        loadgen --targets 127.0.0.1:8100 --fetch-mode delta --duration 5
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        infer --target 127.0.0.1:8100 --count 40 --quality 0.9

Live resharding and the worker supervisor: ``reshard`` moves a slot
range between two adjacent shard primaries (export with a lease, import
with the push-token journal, the bumped map published donor first, the
donor's copy committed away); ``--resume`` finishes or undoes a move
whose coordinator died, from the primaries' ledger records, and
``--abort`` undoes one that has not begun to publish. ``supervise`` runs
``--workers`` ``cli worker`` children on the card (``--device cpu``
passes to them) and respawns the ones that die, with doubling backoff
and a crash-loop latch; ``--autoscale-job`` grows and shrinks their
count from the server's ``/cluster`` view. Neither process loads torch::

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        reshard --primaries 127.0.0.1:8000,127.0.0.1:8001 --donor 0 \
        --recipient 1 --slots 16:32
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        reshard --primaries 127.0.0.1:8000,127.0.0.1:8001 --donor 0 \
        --recipient 1 --slots 16:32 --resume
    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \
        supervise --workers 2 --respawn-backoff 0.5 -- \
        --server 127.0.0.1:8000 --synthetic --epochs 1

The flags and verbs of the JAX CLI that name features of later slices
are accepted and refused with the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import os
import sys
from contextlib import contextmanager


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


def _add_worker_modes(q) -> None:
    """The PS worker's mode flags, shared by ``worker`` and ``train``."""
    q.add_argument("--k-step-mode",
                   choices=["faithful", "accumulate", "local_sgd"],
                   default="faithful",
                   help="faithful = push the boundary batch's gradients "
                        "(quirk 7); accumulate = push the window's mean; "
                        "local_sgd = step locally with the fused step and "
                        "push the window's mean")
    q.add_argument("--local-lr", type=float, default=None,
                   help="local_sgd's step size (default: the server's "
                        "learning rate)")
    q.add_argument("--overlap", action="store_true",
                   help="overlapped comms pipeline: push + prefetch on a "
                        "background thread while the training thread "
                        "computes; pays off with --sync-steps > 1")
    q.add_argument("--heartbeat", type=float, default=0.0,
                   help="liveness ping every N seconds (pair with the "
                        "server's --worker-timeout); 0 disables")
    q.add_argument("--reconnect-timeout", type=float, default=0.0,
                   help="session resume: re-register and re-fetch within "
                        "this many seconds when the server is lost; 0 "
                        "fails the worker instead")


def _add_telemetry(q) -> None:
    """The JAX CLI's shared telemetry flags, with its ``DPS_*`` defaults."""
    q.add_argument("--telemetry", action="store_true",
                   default=bool(_env("DPS_TELEMETRY", 0, int)),
                   help="emit periodic METRICS_JSON 'kind=snapshot' lines "
                        "(live counters/gauges/histograms; same regex "
                        "convention as the exit line)")
    q.add_argument("--telemetry-interval", type=float,
                   default=_env("DPS_TELEMETRY_INTERVAL", 5.0, float),
                   help="seconds between snapshot lines")
    q.add_argument("--metrics-port", type=int,
                   default=_env("DPS_METRICS_PORT", None, int),
                   help="serve Prometheus /metrics + /healthz + /cluster + "
                        "/debug/trace on this port (0 = pick a free port; "
                        "omit = disabled)")
    q.add_argument("--trace", action="store_true",
                   default=bool(_env("DPS_TRACE", 0, int)),
                   help="record per-step trace spans into the in-process "
                        "flight recorder (propagated worker->server over "
                        "the wire; dumped on SIGTERM/crash/exit and via "
                        "/debug/trace)")
    q.add_argument("--trace-buffer", type=int,
                   default=_env("DPS_TRACE_BUFFER", 4096, int),
                   help="flight-recorder ring size (spans kept per "
                        "process; oldest evicted)")
    q.add_argument("--trace-dump-dir",
                   default=_env("DPS_TRACE_DUMP_DIR", None),
                   help="write the recorder tail as JSON here on "
                        "SIGTERM/unhandled-fault/atexit "
                        "(trace-<role>-<pid>-<reason>.json)")
    q.add_argument("--journal-dir",
                   default=_env("DPS_JOURNAL_DIR", None),
                   help="durable telemetry journal directory (segmented "
                        "JSONL; snapshots + alert/remediation/directive/"
                        "checkpoint/incident/profile events; omit = "
                        "disabled)")


def _add_profile_dir(q, what: str) -> None:
    q.add_argument("--profile-dir", default=None,
                   help=f"capture a torch.profiler trace of {what} into "
                        "this directory (the card's kernels and copies "
                        "beside the host's ops; opens in Perfetto; parse "
                        "with `cli perf profile`)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_parameter_server_for_ml_training_tpu_torch",
        description="PyTorch/CUDA parameter-server training")
    sub = p.add_subparsers(dest="command", required=True)
    t = sub.add_parser("train", help="in-process training run")
    t.add_argument("--mode",
                   choices=["baseline", "sync", "async", "tp", "pp", "sp",
                            "moe"],
                   default="async",
                   help="baseline = the reference's single-device recipe; "
                        "sync = sync data parallelism over the worker "
                        "slots of one card; async = host parameter store + "
                        "worker threads (the reference's modes); pp = "
                        "GPipe pipeline over ViT block groups (--workers "
                        "stages of one card); sp = sequence-parallel ViT "
                        "(ring attention over --workers sequence slots of "
                        "one card); moe = Switch-MoE ViT expert "
                        "parallelism (--workers experts of one card); tp "
                        "= Megatron tensor-parallel ViT (a --workers x "
                        "--tp-degree data x model mesh of one card). The "
                        "port's default is async (the JAX CLI's is sync)")
    t.add_argument("--workers", type=int,
                   default=_env("TOTAL_WORKERS_EXPECTED", 4, int))
    t.add_argument("--tp-degree", type=int, default=2,
                   help="model-axis size for --mode tp")
    t.add_argument("--pp-microbatches", type=int, default=8,
                   help="GPipe microbatch count for --mode pp")
    t.add_argument("--dp-degree", type=int, default=1,
                   help="--mode pp: shard each microbatch over a 'data' "
                        "mesh axis (dp x pp composition); --mode moe: "
                        "data groups each routing over the experts "
                        "(dp x ep)")
    t.add_argument("--pp-tp-degree", type=int, default=1,
                   help="--mode pp: Megatron-split stage params over a "
                        "'model' mesh axis (dp x tp x pp composition)")
    t.add_argument("--moe-capacity-factor", type=float, default=2.0,
                   help="--mode moe: per-expert buffer = factor x the "
                        "even-routing load (Switch capacity factor)")
    t.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="--mode moe: Switch load-balance aux-loss weight "
                        "(0 disables balancing)")
    t.add_argument("--staleness-bound", type=int,
                   default=_env("STALENESS_BOUND", 5, int))
    t.add_argument("--sync-steps", type=int,
                   default=_env("SYNC_STEPS", 1, int),
                   help="K-step local SGD interval (worker.py:468)")
    t.add_argument("--no-delta-fetch", action="store_true",
                   help="full params on every fetch (reference parity)")
    t.add_argument("--elastic", action="store_true",
                   help="elastic membership: id-slot reuse on join, sync "
                        "rounds sized to the live workers")
    t.add_argument("--worker-timeout", type=float, default=None,
                   help="expire workers unseen for this many seconds")
    t.add_argument("--strict-rounds", action="store_true",
                   help="corrected sync-round semantics (vs quirk 3)")
    t.add_argument("--store-backend",
                   choices=["python", "native", "device"],
                   default="python",
                   help="async parameter-store backend: host numpy, the "
                        "C++ arena (built from native/ps_core.cpp into "
                        "build/torch_native/ at first use), or "
                        "device-resident (zero host-link bytes a step)")
    _add_worker_modes(t)
    t.add_argument("--compression", choices=["none", "bf16", "fp16", "int8"],
                   default="bf16",
                   help="sync all-reduce precision (int8 = quantized "
                        "reduce-scatter ring, ~half bf16's bytes)")
    t.add_argument("--model", choices=["resnet18", "resnet50", "vit_b16",
                                       "vit_tiny"],
                   default="resnet18",
                   help="baseline, sync and async train any; pp, sp "
                        "and moe a ViT")
    t.add_argument("--plot", default=None,
                   help="save a results plot (png; baseline)")
    t.add_argument("--checkpoint-dir", default=None,
                   help="save checkpoints each epoch (async: periodic "
                        "snapshots of the store)")
    t.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    _add_profile_dir(t, "the training loop")
    t.add_argument("--multihost", action="store_true",
                   help="join a multi-process job before training (sync "
                        "mode): one global mesh across processes, one "
                        "process per card")
    t.add_argument("--coordinator",
                   default=_env("DPS_COORDINATOR", None),
                   help="process-0 address host:port (env "
                        "DPS_COORDINATOR)")
    t.add_argument("--num-processes", type=int,
                   default=_env("DPS_NUM_PROCESSES", None, int))
    t.add_argument("--process-id", type=int,
                   default=_env("DPS_PROCESS_ID", None, int))
    t.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="--multihost collectives: nccl on a card and gloo "
                        "on the CPU by default; gloo on a card (two "
                        "processes on one card, which NCCL refuses) "
                        "copies each collective through the host")
    _add_telemetry(t)
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
                        "keyed by parameter names)")
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
                   default="none",
                   help="fetch-side codec: bf16/fp16 halve the fetch's "
                        "bytes (the reference fetched fp32)")
    s.add_argument("--store-backend", choices=["python", "native", "device"],
                   default="python",
                   help="store behind the service: host numpy, the C++ "
                        "arena (built from native/ps_core.cpp into "
                        "build/torch_native/ at first use), or "
                        "device-resident (--device)")
    s.add_argument("--elastic", action="store_true",
                   help="elastic membership (id-slot reuse + live round "
                        "sizing)")
    s.add_argument("--worker-timeout", type=float, default=None,
                   help="expire workers unseen for this many seconds")
    s.add_argument("--sync-quorum", type=float, default=None,
                   help="--mode sync: a round completes at this many "
                        "distinct workers (>= 1) or this fraction of them "
                        "(< 1); late pushes apply as stale")
    s.add_argument("--round-deadline", type=float, default=None,
                   help="--mode sync: a round completes this many seconds "
                        "after its first gradient")
    s.add_argument("--device", default="cuda",
                   help="where --store-backend device keeps the params "
                        "(cuda, or cpu)")
    s.add_argument("--checkpoint-dir",
                   default=_env("DPS_CHECKPOINT_DIR", None),
                   help="durable server state: periodic atomic snapshots "
                        "of params + step + aggregation config + the "
                        "push-token journal, plus a final snapshot at exit")
    s.add_argument("--checkpoint-interval", type=float,
                   default=_env("DPS_CHECKPOINT_INTERVAL", 30.0, float),
                   help="seconds between periodic store snapshots")
    s.add_argument("--restore", action="store_true",
                   help="resume from the newest snapshot in "
                        "--checkpoint-dir: params + global step restored, "
                        "push-token journal re-seeded so pre-crash push "
                        "retries still dedupe")
    s.add_argument("--remediate", action="store_true",
                   default=bool(_env("DPS_REMEDIATE", 0, int)),
                   help="turn cluster alerts into actions: nonfinite "
                        "loss/grad -> quarantine + refetch directive, "
                        "straggler_lag -> quorum-exclude + rebalance "
                        "directive, dead_worker -> respawn request")
    s.add_argument("--remediate-dry-run", action="store_true",
                   help="run the remediation engine but execute nothing: "
                        "every decision is recorded with outcome dry_run")
    s.add_argument("--remediation-cooldown", type=float,
                   default=_env("DPS_REMEDIATION_COOLDOWN", 30.0, float),
                   help="minimum seconds between repeated remediation "
                        "actions for the same (action, worker)")
    s.add_argument("--quarantine-secs", type=float,
                   default=_env("DPS_QUARANTINE_SECS", 30.0, float),
                   help="server-side push-refusal window of the "
                        "quarantine action")
    s.add_argument("--no-health-monitor", action="store_true",
                   help="disable the cluster health monitor (worker health "
                        "reports, rule engine); on by default")
    s.add_argument("--health-interval", type=float,
                   default=_env("DPS_HEALTH_INTERVAL", 5.0, float),
                   help="seconds between cluster health evaluations")
    s.add_argument("--dead-after", type=float,
                   default=_env("DPS_DEAD_AFTER", 30.0, float),
                   help="seconds of silence before the monitor declares a "
                        "worker dead (independent of --worker-timeout)")
    s.add_argument("--straggler-lag", type=int,
                   default=_env("DPS_STRAGGLER_LAG", 100, int),
                   help="steps behind the fastest reporting worker before "
                        "the straggler_lag rule fires")
    s.add_argument("--no-slo", action="store_true",
                   help="disable the SLO evaluator (on by default with the "
                        "health monitor): error-budget burn over the "
                        "server-side RPC latency/error metrics -> "
                        "slo_burn_fast/slo_burn_slow alerts")
    s.add_argument("--slo-fetch-p99-ms", type=float,
                   default=_env("DPS_SLO_FETCH_P99_MS", 100.0, float),
                   help="fetch latency objective: 99%% of FetchParameters "
                        "under this many milliseconds")
    s.add_argument("--slo-availability", type=float,
                   default=_env("DPS_SLO_AVAILABILITY", 0.99, float),
                   help="availability objective for fetch and push")
    s.add_argument("--slo-fast-window", type=float,
                   default=_env("DPS_SLO_FAST_WINDOW", 60.0, float),
                   help="fast burn window seconds (slo_burn_fast)")
    s.add_argument("--slo-slow-window", type=float,
                   default=_env("DPS_SLO_SLOW_WINDOW", 300.0, float),
                   help="slow burn window seconds (slo_burn_slow)")
    s.add_argument("--slo-fast-burn", type=float,
                   default=_env("DPS_SLO_FAST_BURN", 14.4, float),
                   help="burn-rate threshold over the fast window")
    s.add_argument("--slo-slow-burn", type=float,
                   default=_env("DPS_SLO_SLOW_BURN", 6.0, float),
                   help="burn-rate threshold over the slow window")
    s.add_argument("--incidents-dir",
                   default=_env("DPS_INCIDENTS_DIR", None),
                   help="auto-freeze a forensic bundle here when a "
                        "critical alert fires (journal window, /cluster "
                        "snapshot, flight-recorder tail; per-rule cooldown "
                        "dedupe; needs the health monitor)")
    s.add_argument("--incident-window", type=float,
                   default=_env("DPS_INCIDENT_WINDOW", 120.0, float),
                   help="seconds of journal history frozen per bundle")
    s.add_argument("--incident-cooldown", type=float,
                   default=_env("DPS_INCIDENT_COOLDOWN", 120.0, float),
                   help="per-rule dedupe window: an alert storm yields one "
                        "bundle per rule per cooldown")
    s.add_argument("--no-memory-telemetry", action="store_true",
                   help="disable the periodic memory sampler (on by "
                        "default with the health monitor): host RSS + the "
                        "card's allocator gauges, the windowed leak-slope "
                        "verdict in GET /cluster 'memory', and the "
                        "memory_growth health rule")
    s.add_argument("--profile-triggers", action="store_true",
                   help="trigger-driven profiling: an slo_burn edge or a "
                        "goodput-fraction drop captures a bounded "
                        "torch.profiler window, attributes it per op class "
                        "and appends a PROFILE_*.json record to "
                        "--profiles-dir (per-rule cooldown dedupe; needs "
                        "the health monitor)")
    s.add_argument("--profiles-dir",
                   default=_env("DPS_PROFILES_DIR", "profiles"),
                   help="profile ledger directory for --profile-triggers")
    s.add_argument("--profile-window", type=float,
                   default=_env("DPS_PROFILE_WINDOW", 1.5, float),
                   help="seconds of device activity each triggered "
                        "capture brackets")
    s.add_argument("--profile-cooldown", type=float,
                   default=_env("DPS_PROFILE_COOLDOWN", 600.0, float),
                   help="per-rule dedupe window: a degradation storm "
                        "yields one capture per rule per cooldown")
    s.add_argument("--goodput-drop-threshold", type=float,
                   default=_env("DPS_GOODPUT_DROP", 0.5, float),
                   help="goodput fraction whose falling edge triggers a "
                        "capture (previous tick at or above, this tick "
                        "below)")
    s.add_argument("--shard-index", type=int,
                   default=_env("DPS_SHARD_INDEX", 0, int),
                   help="this server's slot in a sharded deployment: it "
                        "owns the consistent-hash key range "
                        "slot_range(index, count) and holds only those "
                        "parameters")
    s.add_argument("--shard-count", type=int,
                   default=_env("DPS_SHARD_COUNT", 1, int),
                   help="total shard primaries in the deployment; 1 = "
                        "unsharded (default, reference parity)")
    s.add_argument("--shard-peers",
                   default=_env("DPS_SHARD_PEERS", None),
                   help="comma list of ALL shard primary addresses in "
                        "shard order (host:port, length --shard-count); "
                        "published to workers as the shard map at "
                        "registration. Required when --shard-count > 1")
    s.add_argument("--autoscale", action="store_true",
                   help="grow/shrink a local replica fleet from measured "
                        "fetch QPS (telemetry/autoscale.py): spawns "
                        "`cli replica` children against this primary, "
                        "ticked by the health monitor")
    s.add_argument("--autoscale-min", type=int, default=0,
                   help="replica floor the autoscaler keeps alive")
    s.add_argument("--autoscale-max", type=int, default=4,
                   help="replica ceiling")
    s.add_argument("--autoscale-qps-high", type=float, default=50.0,
                   help="windowed fetch QPS above which the fleet grows")
    s.add_argument("--autoscale-qps-low", type=float, default=5.0,
                   help="windowed fetch QPS below which it shrinks "
                        "(hysteresis band with --autoscale-qps-high)")
    s.add_argument("--autoscale-cooldown", type=float, default=10.0,
                   help="minimum seconds between scaling actions")
    s.add_argument("--autoscale-max-tier", type=int, default=1,
                   help="deepest tier a grown replica may land at "
                        "(docs/SHARDING.md \"Fan-out trees\"): 1 = flat "
                        "star (every replica under the primary); >1 "
                        "spawns under the hottest eligible interior "
                        "node")
    s.add_argument("--autoscale-fanout", type=int, default=2,
                   help="per-node child budget when growing a tree — a "
                        "node already feeding this many children stops "
                        "being an eligible parent")
    s.add_argument("--autoscale-dry-run", action="store_true",
                   help="decide and record scaling actions without "
                        "spawning or retiring anything")
    _add_profile_dir(s, "the server's apply/aggregation hot path")
    _add_telemetry(s)
    s.add_argument("--faults", default=_env("DPS_FAULTS_SERVER", None),
                   help="deterministic server-side fault injection spec "
                        "(comms/faults.py), e.g. "
                        "'seed=7;push.drop_reply@n=3;any.kill@n=40'")
    s.add_argument("--jobs", default=None)

    w = sub.add_parser("worker", help="gRPC remote worker")
    w.add_argument("--server",
                   default=_env("PARAMETER_SERVER_ADDRESS",
                                "localhost:8000"),
                   help="PS address (worker.py:457-459)")
    w.add_argument("--shards", default=_env("DPS_SHARDS", None),
                   help="sharded deployment: comma list of shard primary "
                        "addresses (or just the shard-0 seed: the rest "
                        "are adopted from its shard map). Pushes and "
                        "fetches fan out per shard and reassemble; "
                        "overrides --server")
    w.add_argument("--worker-name", default=_env("WORKER_NAME", ""))
    w.add_argument("--sync-steps", type=int,
                   default=_env("SYNC_STEPS", 1, int))
    _add_worker_modes(w)
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
    _add_profile_dir(w, "the worker loop")
    _add_telemetry(w)
    _add_common(w)
    w.add_argument("--job", default=None)
    w.add_argument("--faults", default=_env("DPS_FAULTS_CLIENT", None),
                   help="deterministic client-side fault injection spec "
                        "(comms/faults.py), e.g. "
                        "'seed=7;push.unavailable@p=0.1'")

    r = sub.add_parser(
        "replica",
        help="read-only fetch replica behind one shard primary "
             "(docs/SHARDING.md): subscribes over delta-fetch, serves "
             "cached parameter bytes, refuses when stale, redirects "
             "writes to the primary")
    r.add_argument("--primary", required=True,
                   help="address (host:port) of the shard primary this "
                        "replica mirrors (writes always redirect here)")
    r.add_argument("--parent", default=None,
                   help="subscribe source when different from the "
                        "primary — point it at ANOTHER replica to form "
                        "a fan-out tree (docs/SHARDING.md \"Fan-out "
                        "trees\"); the tier is learned from the "
                        "parent's replies")
    r.add_argument("--port", type=int, default=_env("DPS_PORT", 0, int),
                   help="replica serve port (0 = pick a free port)")
    r.add_argument("--shard-id", type=int, default=0,
                   help="shard slot of the primary (stamped on replies "
                        "and the announce)")
    r.add_argument("--advertise", default=None,
                   help="address to announce to the primary (defaults to "
                        "localhost:<bound port>)")
    r.add_argument("--metrics-advertise", default=None,
                   help="metrics endpoint address to announce alongside "
                        "it (defaults to localhost:<bound --metrics-port> "
                        "when one is serving) — published in the "
                        "primary's /cluster view so `cli observe` "
                        "discovers this replica as a scrape target")
    r.add_argument("--poll-interval", type=float,
                   default=_env("DPS_REPLICA_POLL", 0.05, float),
                   help="seconds between delta-fetch refreshes against "
                        "the primary (NOT_MODIFIED when idle)")
    r.add_argument("--staleness-bound", type=float,
                   default=_env("DPS_REPLICA_STALENESS", None, float),
                   help="max seconds since the last successful refresh "
                        "before fetches are refused with a redirect to "
                        "the primary (default: derived from the tier — "
                        "5s x tier, so edge tiers tolerate "
                        "proportionally more lag)")
    r.add_argument("--reparent-after", type=int, default=3,
                   help="consecutive refresh failures before this "
                        "replica re-parents via the cached topology "
                        "(prefer the dead parent's tier, fall back to "
                        "the primary)")
    r.add_argument("--reparent-cooldown", type=float, default=5.0,
                   help="hysteresis: minimum seconds between re-parent "
                        "moves, so a flapping parent cannot make "
                        "children ricochet around the tree")
    r.add_argument("--canary", action="store_true",
                   help="serve the canary-gated inference workload "
                        "(docs/SHARDING.md \"Serve tier\"): keep a step "
                        "history, split `infer` fetches stable/canary, "
                        "promote or roll back on client quality feedback")
    r.add_argument("--canary-fraction", type=float, default=0.05,
                   help="share of infer requests routed to the canary "
                        "step (default 5%%)")
    r.add_argument("--canary-min-samples", type=int, default=20,
                   help="quality samples each arm needs before a "
                        "promote/rollback decision")
    r.add_argument("--canary-tolerance", type=float, default=0.0,
                   help="promote while canary mean quality >= stable "
                        "mean - tolerance; below that, roll back")
    r.add_argument("--faults", default=None,
                   help="seeded fault spec for the replica tier (env "
                        "DPS_FAULTS_REPLICA; comms/faults.py grammar): "
                        "`refresh.*` rules hit the subscription poll, "
                        "`subscribe.*` rules this replica's own serving "
                        "handler")
    _add_telemetry(r)

    lg = sub.add_parser(
        "loadgen",
        help="fetch-path load generator: hammer FetchParameters on one "
             "or more targets and print aggregate QPS as LOADGEN_JSON "
             "(docs/SHARDING.md)")
    lg.add_argument("--targets", required=True,
                    help="comma list of fetch targets (primaries and/or "
                         "replicas), host:port each; threads round-robin "
                         "over the list")
    lg.add_argument("--duration", type=float, default=5.0,
                    help="seconds to run")
    lg.add_argument("--concurrency", type=int, default=4,
                    help="total client threads (each with its own "
                         "channel)")
    lg.add_argument("--job", default=None,
                    help="refused: the job stamp comes with tenancy "
                         "(ROADMAP §1 item 9)")
    lg.add_argument("--fetch-mode", choices=["full", "delta", "infer"],
                    default="full",
                    help="full = whole model every fetch; delta = poll "
                         "at the current step (header-only NOT_MODIFIED "
                         "steady state); infer = the inference-serving "
                         "workload against a canary replica, with "
                         "per-arm counts/latency/quality in the result")
    lg.add_argument("--scale-out", type=int, default=0,
                    help="distributed generation: launch N coordinated "
                         "generator PROCESSES (each running this exact "
                         "workload) and print ONE merged LOADGEN_JSON — "
                         "percentiles come from the bucket-exact "
                         "histogram union, never averaged (0 = run "
                         "in-process, the default)")

    inf = sub.add_parser(
        "infer",
        help="one-shot inference client against the serve tier "
             "(docs/SHARDING.md \"Serve tier\"): send `infer` fetches, "
             "print which arm and step served each, optionally report a "
             "quality score back")
    inf.add_argument("--target", required=True,
                     help="replica (or primary) address, host:port")
    inf.add_argument("--count", type=int, default=1,
                     help="number of inference requests to send")
    inf.add_argument("--quality", type=float, default=None,
                     help="quality score to report for each served "
                          "response (feeds the canary decision); omit to "
                          "send no feedback")
    inf.add_argument("--json", action="store_true",
                     help="print only the INFER_JSON line")

    sv = sub.add_parser(
        "supervise",
        help="spawn and babysit N `cli worker` processes: respawn on "
             "death with exponential backoff + crash-loop latch "
             "(docs/ROBUSTNESS.md). Everything after `--` is passed to "
             "every child worker verbatim")
    sv.add_argument("--workers", type=int,
                    default=_env("DPS_SUPERVISE_WORKERS", 2, int),
                    help="worker process slots to run")
    sv.add_argument("--no-respawn", action="store_true",
                    help="just run the children once (no self-healing)")
    sv.add_argument("--respawn-backoff", type=float,
                    default=_env("DPS_RESPAWN_BACKOFF", 1.0, float),
                    help="first respawn delay; doubles per consecutive "
                         "crash up to --respawn-backoff-max")
    sv.add_argument("--respawn-backoff-max", type=float, default=30.0)
    sv.add_argument("--healthy-after", type=float, default=5.0,
                    help="a child alive this long resets its slot's "
                         "backoff and crash-loop count")
    sv.add_argument("--crash-loop-after", type=int, default=3,
                    help="consecutive fast crashes before a slot latches "
                         "(stops respawning, nonzero exit)")
    sv.add_argument("--slot-faults", action="append", default=[],
                    metavar="SLOT:SPEC",
                    help="fault spec for one slot's FIRST spawn only "
                         "(chaos drills: respawns run clean), e.g. "
                         "'0:seed=7;push.kill@n=2'; repeatable")
    sv.add_argument("--slot-env", action="append", default=[],
                    metavar="SLOT:KEY=VALUE",
                    help="env var for one slot's first spawn only, e.g. "
                         "'1:DPS_NAN_STEP=4'; repeatable")
    sv.add_argument("--autoscale-job", default=None,
                    help="worker autoscaling (docs/TENANCY.md): poll the "
                         "server's per-job /cluster view and grow/shrink "
                         "this supervisor's slot count with the named "
                         "job's admission-queue/straggler pressure "
                         "(worker_grow/worker_shrink actions). Pass the "
                         "job's --job flag in the child worker args too")
    sv.add_argument("--autoscale-url", default=None,
                    help="base URL of the serve process's metrics "
                         "endpoint (e.g. http://host:9400); required "
                         "with --autoscale-job")
    sv.add_argument("--autoscale-min", type=int, default=1,
                    help="worker-slot floor the autoscaler keeps alive")
    sv.add_argument("--autoscale-max", type=int, default=4,
                    help="worker-slot ceiling")
    sv.add_argument("--autoscale-depth-high", type=float, default=4.0,
                    help="admission queue depth above which the fleet "
                         "grows (after --autoscale-sustain ticks)")
    sv.add_argument("--autoscale-depth-low", type=float, default=1.0,
                    help="queue depth below which it shrinks "
                         "(hysteresis band with --autoscale-depth-high)")
    sv.add_argument("--autoscale-sustain", type=int, default=3,
                    help="consecutive polls a condition must hold "
                         "before acting")
    sv.add_argument("--autoscale-cooldown", type=float, default=15.0,
                    help="minimum seconds between scaling actions")
    sv.add_argument("--autoscale-poll", type=float, default=2.0,
                    help="seconds between /cluster pressure polls")
    sv.add_argument("--device", default="cuda",
                    help="the children's torch device: any other value "
                         "than the default (cpu, cuda:1) is passed to "
                         "every child as --device; the default leaves "
                         "them on `cli worker`'s own default, the card "
                         "(the supervisor itself touches no device)")
    _add_telemetry(sv)
    sv.add_argument("worker_args", nargs=argparse.REMAINDER,
                    help="-- followed by the `cli worker` args every "
                         "child runs with (--worker-name is added per "
                         "slot)")

    rs = sub.add_parser(
        "reshard",
        help="live shard migration coordinator (docs/SHARDING.md "
             "\"Migration protocol\"): move a slot range between two "
             "ADJACENT primaries — export+journal on the donor, import "
             "on the recipient, apply the bumped map everywhere, commit "
             "the drop — with zero downtime and exactly-once preserved")
    rs.add_argument("--primaries", required=True,
                    help="ordered comma list of ALL shard primaries "
                         "(index = shard id), the same list the serve "
                         "processes were given as --shard-peers")
    rs.add_argument("--donor", type=int, required=True,
                    help="shard id giving up the slot range")
    rs.add_argument("--recipient", type=int, required=True,
                    help="shard id receiving it (must be donor±1: ranges "
                         "stay contiguous per shard)")
    rs.add_argument("--slots", required=True, metavar="LO:HI",
                    help="slot range [LO,HI) to move; must sit at the "
                         "donor's boundary facing the recipient")
    rs.add_argument("--json", action="store_true",
                    help="print only the RESHARD_JSON line")
    rs.add_argument("--migration-id", default=None,
                    help="explicit migration id (defaults to a random "
                         "one); the durable ledger key --resume/--abort "
                         "match against (docs/ROBUSTNESS.md)")
    rs.add_argument("--lease-ttl", type=float, default=30.0,
                    help="donor freeze lease in seconds: if the "
                         "coordinator dies before publishing the map, "
                         "the donor auto-unfreezes and aborts after "
                         "this long (default 30)")
    rs.add_argument("--resume", action="store_true",
                    help="inspect the primaries' migration ledger and "
                         "deterministically roll the crashed migration "
                         "forward (map already publishing) or back "
                         "(pre-publish / lease expired)")
    rs.add_argument("--abort", action="store_true",
                    help="roll back an in-flight migration: recipient "
                         "drops its adopted copy, donor unfreezes, map "
                         "untouched (refused once the map started "
                         "publishing — use --resume)")
    rs.add_argument("--crash-after",
                    choices=["export", "import", "apply_first",
                             "apply_all"],
                    default=None,
                    help="chaos drill hook: hard-exit the coordinator "
                         "immediately after this phase boundary")

    e = sub.add_parser("experiments",
                       help="run the sync/async x workers matrix "
                            "(reference §6 tables) and plot")
    e.add_argument("--modes", default="sync,async")
    e.add_argument("--worker-counts", default="4,8")
    e.add_argument("--out-dir", default="experiments/results")
    e.add_argument("--backend", choices=["python", "native", "device"],
                   default="python",
                   help="'device' keeps store tensors on the card "
                        "(zero host<->device traffic per step)")
    e.add_argument("--no-plots", action="store_true")
    # Pod-log ingestion (analysis/pod_logs.py): one command turns a pod
    # run's teed logs into a reference-schema experiment JSON — the
    # reference's CloudWatch ETL loop (parse_cloudwatch_logs.py:34-87)
    # over ssh + terraform-output discovery.
    e.add_argument("--ingest-pod", action="store_true",
                   help="collect METRICS_JSON logs from a pod instead "
                        "of running the local matrix")
    e.add_argument("--pod-name", help="pod to ingest (else --tf-dir "
                                      "discovery)")
    e.add_argument("--pod-zone")
    e.add_argument("--tf-dir", default="deploy/terraform",
                   help="terraform dir for pod_name/pod_zone discovery")
    e.add_argument("--experiment-name", default="pod_run")
    e.add_argument("--pod-log-path", default="~/dps_train.log")
    e.add_argument("--model", choices=["resnet18", "resnet50", "vit_b16",
                                       "vit_tiny"], default="resnet18",
                   help="accepted as in the JAX CLI; every cell trains "
                        "ResNet-18, as the JAX runner's do")
    _add_common(e)
    _add_telemetry(e)

    st = sub.add_parser(
        "status",
        help="cluster health dashboard: render a serve process's "
             "GET /cluster as a terminal table (docs/OBSERVABILITY.md)")
    st.add_argument("--url", default=_env("DPS_STATUS_URL", None),
                    help="base URL of the server's metrics endpoint, e.g. "
                         "http://host:9400 (env DPS_STATUS_URL); overrides "
                         "--host/--metrics-port")
    st.add_argument("--host", default="127.0.0.1",
                    help="metrics endpoint host (with --metrics-port)")
    st.add_argument("--metrics-port", type=int,
                    default=_env("DPS_METRICS_PORT", None, int),
                    help="the serve process's --metrics-port")
    st.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="redraw every N seconds until interrupted "
                         "(0 = one shot)")
    st.add_argument("--json", action="store_true",
                    help="print the raw /cluster JSON instead of the table")
    st.add_argument("--via-fleet", default=None, metavar="URL",
                    help="render the dashboard from a fleet collector's "
                         "GET /fleet snapshot (cli observe) instead of "
                         "one primary's /cluster — the first primary's "
                         "cluster blocks plus fleet-scope SLO/alerts; "
                         "blocks the fleet view lacks degrade exactly "
                         "like a server without them")

    ob = sub.add_parser(
        "observe",
        help="fleet observatory collector (docs/OBSERVABILITY.md "
             "\"Fleet observatory\"): scrape every fleet process's "
             "/metrics + /cluster on an interval into a bounded ring "
             "TSDB, roll them up (bucket-exact histogram merges), and "
             "serve GET /fleet — a standalone process, off every hot "
             "path, that survives primary restarts")
    ob.add_argument("--targets", required=True,
                    help="comma list of metrics endpoints (host:port) to "
                         "seed the scrape set; replicas announcing a "
                         "metrics address via /cluster are discovered "
                         "automatically")
    ob.add_argument("--port", type=int, default=_env("DPS_FLEET_PORT", 0,
                                                     int),
                    help="port to serve GET /fleet on (0 = pick free)")
    ob.add_argument("--interval", type=float, default=2.0,
                    help="seconds between scrape ticks")
    ob.add_argument("--timeout", type=float, default=1.5,
                    help="per-target per-request scrape timeout; a dead "
                         "target marks its series stale, never blocks "
                         "the tick")
    ob.add_argument("--ring-depth", type=int, default=120,
                    help="samples kept per series ring (bounded memory)")
    ob.add_argument("--slo-fetch-p99-ms", type=float, default=100.0,
                    help="fleet fetch-latency objective threshold")
    ob.add_argument("--slo-availability", type=float, default=0.99,
                    help="fleet availability objective target")
    ob.add_argument("--slo-fast-window", type=float, default=60.0,
                    help="fast burn window (s) for the fleet-scope SLO "
                         "evaluation over MERGED series")
    ob.add_argument("--slo-slow-window", type=float, default=300.0,
                    help="slow burn window (s)")
    ob.add_argument("--journal-dir",
                    default=_env("DPS_JOURNAL_DIR", None),
                    help="journal every tick's merged /fleet view (minus "
                         "history rings) + slo_burn edges into this "
                         "durable journal directory — the `cli top "
                         "--replay` / `cli query` source")
    ob.add_argument("--incidents-dir",
                    default=_env("DPS_INCIDENTS_DIR", None),
                    help="auto-freeze a forensic bundle here on critical "
                         "fleet alerts / SLO-burn edges (journal window, "
                         "/fleet snapshot, target trace dumps; "
                         "docs/OBSERVABILITY.md 'Incident forensics')")
    ob.add_argument("--incident-window", type=float, default=120.0,
                    help="seconds of journal history frozen per bundle")
    ob.add_argument("--incident-cooldown", type=float, default=120.0,
                    help="per-rule dedupe window: an alert storm yields "
                         "one bundle per rule per cooldown")

    tp = sub.add_parser(
        "top",
        help="live fleet dashboard over a collector's GET /fleet "
             "(per-tier rows, fleet QPS, replica lag, merged-series SLO "
             "burn, alert feed, sparklines); exit codes match `cli "
             "status`: 0 healthy, 1 unreachable, 2 critical, 3 "
             "critical-but-healing")
    tp.add_argument("--url", default=_env("DPS_FLEET_URL", None),
                    help="base URL of the fleet collector, e.g. "
                         "http://host:9500 (env DPS_FLEET_URL)")
    tp.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="redraw every N seconds until interrupted "
                         "(0 = one shot)")
    tp.add_argument("--json", action="store_true",
                    help="print the raw /fleet JSON instead of the "
                         "dashboard")
    tp.add_argument("--replay", default=None, metavar="JOURNAL_DIR",
                    help="scrub a PAST run on the same dashboard: read "
                         "fleet_tick records from a journal directory "
                         "(cli observe --journal-dir) instead of polling "
                         "a live /fleet; --watch steps frames at that "
                         "interval, one-shot renders the final frame")

    inc = sub.add_parser(
        "incident",
        help="incident forensics over auto-captured bundles "
             "(docs/OBSERVABILITY.md 'Incident forensics'): list "
             "bundles, show a manifest, or reconstruct the causal "
             "fault->alert->remediation->resolution timeline from the "
             "on-disk journal — no live process needed")
    incsub = inc.add_subparsers(dest="incident_command", required=True)
    inc_common = {
        "--dir": dict(default=_env("DPS_INCIDENTS_DIR", "incidents"),
                      help="incidents directory (bundles live in "
                           "<dir>/<id>/; env DPS_INCIDENTS_DIR)"),
        "--json": dict(action="store_true",
                       help="machine-readable output"),
    }
    incl = incsub.add_parser("list", help="one row per bundle")
    incs = incsub.add_parser("show",
                             help="manifest + bundle contents for one id")
    incs.add_argument("id", help="bundle id (or unique prefix)")
    incr = incsub.add_parser(
        "report",
        help="merge the bundle's frozen journal window with the "
             "journal's post-edge segments and render the ordered "
             "cross-process postmortem timeline")
    incr.add_argument("id", nargs="?", default=None,
                      help="bundle id or unique prefix (default: the "
                           "newest bundle)")
    incr.add_argument("--journal-dir", default=None,
                      help="override the journal directory recorded in "
                           "the manifest (bundle moved hosts)")
    for q in (incl, incs, incr):
        for flag, kw in inc_common.items():
            q.add_argument(flag, **kw)

    qy = sub.add_parser(
        "query",
        help="retro-query a durable journal: list/aggregate series over "
             "a time range with union-exact percentiles (bucket-exact "
             "histogram merges across processes), or re-run the SLO "
             "burn evaluation over history (same windows as the live "
             "evaluator)")
    qy.add_argument("--journal", required=True,
                    help="journal directory (or one segment file)")
    qy.add_argument("--series", default=None,
                    help="substring filter on metric keys (e.g. "
                         "'rpc_server_latency')")
    qy.add_argument("--since", type=float, default=None,
                    help="window start (unix seconds; percentiles and "
                         "counter deltas are computed window-exact "
                         "against the last snapshot at or before it)")
    qy.add_argument("--until", type=float, default=None,
                    help="window end (unix seconds; default newest)")
    qy.add_argument("--last", type=float, default=None, metavar="SECONDS",
                    help="shorthand: window = newest snapshot minus N "
                         "seconds (overrides --since)")
    qy.add_argument("--percentiles", action="store_true",
                    help="p50/p95/p99 per selected histogram series, "
                         "merged union-exact across processes")
    qy.add_argument("--slo", action="store_true",
                    help="retroactive SLO burn evaluation over the "
                         "journal's snapshot history (fast + slow "
                         "windows, telemetry/slo.py semantics); exit "
                         "code 2 when any critical window breached")
    qy.add_argument("--slo-fetch-p99-ms", type=float, default=100.0,
                    help="fetch-latency objective threshold")
    qy.add_argument("--slo-availability", type=float, default=0.99,
                    help="availability objective target")
    qy.add_argument("--slo-fast-window", type=float, default=60.0,
                    help="fast burn window (s)")
    qy.add_argument("--slo-slow-window", type=float, default=300.0,
                    help="slow burn window (s)")
    qy.add_argument("--goodput", action="store_true",
                    help="retroactive goodput ledger over the window: "
                         "per-category wall seconds (counter deltas "
                         "merged across processes), goodput fraction, "
                         "residual — answers 'what fraction of the "
                         "window was productive' from the journal alone")
    qy.add_argument("--incidents", default=None, metavar="DIR",
                    help="with --goodput: join incident bundles from DIR "
                         "and attribute badput seconds to each bundle's "
                         "capture window (per-incident cost accounting)")
    qy.add_argument("--goodput-tolerance", type=float, default=0.02,
                    help="residual fraction above which the goodput "
                         "report flags the ledger unreconciled "
                         "(default: 0.02)")
    qy.add_argument("--json", action="store_true",
                    help="machine-readable output (QUERY_JSON line)")

    gp = sub.add_parser(
        "goodput",
        help="live goodput ledger from a running process's /metrics.json: "
             "per-category wall-clock accounting "
             "(docs/OBSERVABILITY.md 'Goodput observatory'), goodput "
             "fraction, residual; exit 1 when the endpoint is "
             "unreachable")
    gp.add_argument("--url", default=_env("DPS_METRICS_URL", None),
                    help="base URL of the metrics endpoint, e.g. "
                         "http://host:9100 (env DPS_METRICS_URL; "
                         "or use --host/--metrics-port)")
    gp.add_argument("--host", default="127.0.0.1",
                    help="metrics host when --url is not given")
    gp.add_argument("--metrics-port", type=int, default=9100,
                    help="metrics port when --url is not given")
    gp.add_argument("--tolerance", type=float, default=0.02,
                    help="residual fraction above which the ledger is "
                         "flagged unreconciled (default: 0.02)")
    gp.add_argument("--json", action="store_true",
                    help="machine-readable output (GOODPUT_JSON line)")


    pf = sub.add_parser(
        "perf",
        help="perf observatory: attribute a --profile-dir capture into "
             "per-op-class device time (`profile`), diff two artifacts "
             "(`diff`)")
    pfsub = pf.add_subparsers(dest="perf_command", required=True)
    pfp = pfsub.add_parser(
        "profile",
        help="parse a torch.profiler capture into device-time attribution "
             "tables, optionally joined with flight-recorder dumps into "
             "one end-to-end artifact")
    pfp.add_argument("--profile-dir", required=True,
                     help="the --profile-dir a train/serve/worker run "
                          "captured into")
    pfp.add_argument("--trace-dump-dir", default=None,
                     help="flight-recorder dump dir (--trace-dump-dir of "
                          "the same run): joins the host-phase "
                          "critical-path report and reconciles step wall "
                          "vs attributed device time")
    pfp.add_argument("--device-kind", default=None,
                     help="override the device kind recorded in the "
                          "artifact (default: torch.cuda.get_device_name(0) "
                          "when a card is present)")
    pfp.add_argument("--out", default=None,
                     help="write the merged JSON artifact here")
    pfp.add_argument("--json", action="store_true",
                     help="print the JSON artifact instead of the table")
    pfp.add_argument("--keep-traces", action="store_true",
                     help="keep the raw Chrome traces in --profile-dir "
                          "after a successful attribution (default: prune "
                          "them — the artifact is the durable record; "
                          "traces are kept when attribution fails)")
    pfd = pfsub.add_parser(
        "diff",
        help="diff two attribution artifacts (cli perf profile --out, or "
             "profile-ledger records) into a per-op-class delta table; "
             "refuses artifacts with mismatched attribution bases")
    pfd.add_argument("baseline", help="baseline artifact JSON path")
    pfd.add_argument("candidate", help="candidate artifact JSON path")
    pfd.add_argument("--tolerance", type=float, default=0.01,
                     help="fractional |delta|/baseline below which a class "
                          "is reported unchanged (default: 0.01)")
    pfd.add_argument("--json", action="store_true",
                     help="machine-readable diff instead of the table")
    pfsub.add_parser("check", help=f"refused: comes with "
                                   f"{LATER_VERBS['perf check']}")
    return p


#: Flags of the JAX verbs whose features come with later slices, by the
#: ROADMAP item that brings them; any value but the default is refused.
LATER_FLAGS = {
    "jobs": "ROADMAP §1 item 9 (tenancy)",
    "job": "ROADMAP §1 item 9 (tenancy)",
}
#: Verbs of the JAX CLI whose features come with later slices.
LATER_VERBS = {
    "perf check": "ROADMAP §1 item 11 (port tooling: tools/benchwatch)",
}


def _refuse_later_flags(args) -> None:
    """Raise for the first flag of a later slice given a value (anything
    but None or False; a port of 0 is a value)."""
    for name, item in LATER_FLAGS.items():
        value = getattr(args, name, None)
        if value is None or value is False:
            continue
        flag = "--" + name.replace("_", "-")
        raise NotImplementedError(
            f"{flag} {value!r} is not ported yet; it comes with {item}")


@contextmanager
def _telemetry_session(args, role: str):
    """Start/stop the opt-in telemetry surfaces around a command body, as
    the JAX CLI does: the periodic snapshot emitter (``--telemetry``), the
    Prometheus/debug endpoint (``--metrics-port``), the tracing flight
    recorder (``--trace``/``--trace-buffer``/``--trace-dump-dir``) and the
    journal (``--journal-dir``). The emitter's final flush runs even on
    failure, and the shutdown hooks extend that to SIGTERM: the recorder
    tail is dumped and the snapshot emitter flushes its final interval
    (and seals the journal) instead of silently dropping it."""
    emitter = http_server = journal = None
    if args.trace:
        from .telemetry import enable_tracing
        enable_tracing(buffer=args.trace_buffer, role=role)
    if args.journal_dir:
        # Installed process-globally BEFORE the command body so every
        # chokepoint (alert edges, directives, checkpoints, incidents,
        # profiles) journals from the first event on.
        from .telemetry import JournalWriter, set_journal
        journal = JournalWriter(args.journal_dir, role=role)
        set_journal(journal)
    if args.trace or args.trace_dump_dir or journal or args.telemetry:
        from .telemetry import install_shutdown_hooks
        install_shutdown_hooks(dump_dir=args.trace_dump_dir, role=role)
    if args.metrics_port is not None:
        from .telemetry import register_build_info, start_metrics_server
        register_build_info()
        http_server, bound = start_metrics_server(port=args.metrics_port)
        args._metrics_bound = bound
        print(f"telemetry: serving /metrics on :{bound}", file=sys.stderr,
              flush=True)
    if args.telemetry:
        from .telemetry import (SnapshotEmitter, add_shutdown_flush,
                                register_build_info)
        register_build_info()
        emitter = SnapshotEmitter(interval=args.telemetry_interval,
                                  role=role, journal=journal).start()
        # flush_now is a no-op once stop() below emitted the final line;
        # with a journal attached it also seals the active segment.
        add_shutdown_flush(emitter.flush_now)
    if journal is not None and emitter is None:
        from .telemetry import add_shutdown_flush
        add_shutdown_flush(journal.seal)
    try:
        yield
    finally:
        if emitter is not None:
            from .telemetry import remove_shutdown_flush
            emitter.stop(final=True)
            remove_shutdown_flush(emitter.flush_now)
        if journal is not None:
            from .telemetry import remove_shutdown_flush, set_journal
            set_journal(None)
            journal.seal()
            if emitter is None:
                remove_shutdown_flush(journal.seal)
        if http_server is not None:
            http_server.shutdown()
            http_server.server_close()


@contextmanager
def _profiler_session(profile_dir: str | None, device: str):
    """``--profile-dir``: bracket the hot loop with ``torch.profiler``
    (``telemetry/profiler.py:capture``) on the command's ``--device``, so
    the card's kernel timeline lands beside the framework-level span
    traces. No-op when unset."""
    if not profile_dir:
        yield
        return
    from .telemetry.profiler import capture
    print(f"profiler: tracing into {profile_dir}", file=sys.stderr,
          flush=True)
    with capture(profile_dir, device):
        yield


def _load_dataset(args):
    from .data import load_cifar100, synthetic_cifar100, synthetic_imagenet

    if args.dataset == "imagenet-synth":
        ds = synthetic_imagenet(n_train=args.num_train or 10_000,
                                n_test=args.num_test or 1_000,
                                image_size=args.image_size)
    elif args.synthetic:
        # Only the images the run keeps are drawn: the same bytes as the
        # whole set sliced below.
        ds = synthetic_cifar100(keep_train=args.num_train or None,
                                keep_test=args.num_test or None)
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
    _refuse_later_flags(args)
    with _telemetry_session(args, "trainer"):
        return _cmd_train(args)


def _cmd_train(args) -> int:
    if args.dist_backend and not args.multihost:
        raise SystemExit("--dist-backend applies to --multihost")
    if args.multihost:
        if args.mode != "sync":
            raise SystemExit("--multihost applies to --mode sync (async "
                             "multi-host uses serve/worker over gRPC)")
        import torch.distributed as dist

        from .parallel.multihost import initialize as initialize_multihost
        args.device = str(initialize_multihost(
            args.coordinator, args.num_processes, args.process_id,
            backend=args.dist_backend, device=args.device))
        try:
            return _cmd_train_body(args)
        finally:
            dist.destroy_process_group()
    return _cmd_train_body(args)


def _cmd_train_body(args) -> int:
    from .train.distributed import (AsyncTrainer, DistributedConfig,
                                    SyncTrainer)

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
        trainer = BaselineTrainer(dataset, cfg)
        with _profiler_session(args.profile_dir, args.device):
            trainer.train(plot_path=args.plot,
                          emit_metrics=args.emit_metrics,
                          checkpoint_dir=args.checkpoint_dir,
                          resume=args.resume)
        return 0
    if args.mode in ("tp", "pp", "sp", "moe"):
        from .train.model_parallel import (ModelParallelConfig, MoETrainer,
                                           PipelineTrainer, SPTrainer,
                                           TPTrainer)
        mp_cfg = ModelParallelConfig(
            model=args.model, num_workers=args.workers,
            tp_degree=args.tp_degree,
            pp_microbatches=args.pp_microbatches,
            dp_degree=args.dp_degree, pp_tp_degree=args.pp_tp_degree,
            moe_capacity_factor=args.moe_capacity_factor,
            moe_aux_weight=args.moe_aux_weight,
            learning_rate=args.lr, num_epochs=args.epochs,
            batch_size=args.batch_size, augment=not args.no_augment,
            num_classes=dataset.num_classes, dtype=args.dtype,
            seed=args.seed, device=args.device)
        trainer = {"tp": TPTrainer, "pp": PipelineTrainer,
                   "sp": SPTrainer, "moe": MoETrainer}[args.mode](
            dataset, mp_cfg)
        with _profiler_session(args.profile_dir, args.device):
            metrics = trainer.train(emit_metrics=args.emit_metrics,
                                    checkpoint_dir=args.checkpoint_dir,
                                    resume=args.resume)
        print(f"done: {metrics}", file=sys.stderr)
        return 0
    if args.mode == "sync" and (args.elastic or args.worker_timeout):
        print("note: --elastic/--worker-timeout apply to the store-based "
              "modes (async, serve/worker); the sync trainer's slots have "
              "no membership", file=sys.stderr)
    cfg = DistributedConfig(
        mode=args.mode, num_workers=args.workers, learning_rate=args.lr,
        num_epochs=args.epochs, batch_size=args.batch_size,
        sync_steps=args.sync_steps, k_step_mode=args.k_step_mode,
        staleness_bound=args.staleness_bound,
        compression=args.compression, strict_rounds=args.strict_rounds,
        elastic=args.elastic,
        worker_timeout=args.worker_timeout, overlap=args.overlap,
        delta_fetch=not args.no_delta_fetch, local_lr=args.local_lr,
        heartbeat_interval=args.heartbeat,
        reconnect_timeout=args.reconnect_timeout,
        store_backend=args.store_backend,
        augment=not args.no_augment, dtype=args.dtype,
        num_classes=dataset.num_classes, model=args.model, seed=args.seed,
        device=args.device)
    trainer = (SyncTrainer if args.mode == "sync" else AsyncTrainer)(
        dataset, cfg)
    with _profiler_session(args.profile_dir, args.device):
        metrics = trainer.train(emit_metrics=args.emit_metrics,
                                checkpoint_dir=args.checkpoint_dir,
                                resume=args.resume)
    print(f"done: {metrics}", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """The gRPC parameter server over the host NumPy store (or, with
    ``--store-backend device``, the device-resident store); exits when
    every registered worker has sent JobFinished. With
    ``--checkpoint-dir`` the store and its push-token journal are
    snapshotted periodically and at exit; ``--restore`` resumes from the
    newest snapshot, adopting its aggregation settings (JAX
    ``cli.py:1552-1645``, without tenancy's per-job lineages). The
    cluster health monitor, its SLO evaluator and, with ``--remediate``,
    the remediation engine are wired as JAX's ``cmd_serve`` does
    (``cli.py:1413-1490``), and so are incident capture, memory
    telemetry and trigger-driven profiling (``cli.py:1494-1548``). With
    ``--shard-count`` > 1 (or ``--shard-peers``) the server is one shard
    primary: it holds only its ``partition_keys`` share of the model's
    tensors and publishes the shard map (JAX ``cli.py:1341-1391``)."""
    _refuse_later_flags(args)
    with _telemetry_session(args, "server"):
        return _cmd_serve(args)


def _cmd_serve(args) -> int:
    import functools
    import time

    from .comms.service import ParameterService, serve
    from .models import get_model
    from .ps import make_store
    from .ps.store import StoreConfig
    from .utils.metrics import emit_metrics_json
    from .utils.pytree import params_to_jax

    if args.push_codec in ("int4", "topk", "adaptive") \
            and args.store_backend != "python":
        raise SystemExit(
            f"--push-codec {args.push_codec} needs --store-backend python "
            f"(the {args.store_backend} backend speaks none|fp16|int8)")
    quorum_flags = (args.sync_quorum is not None
                    or args.round_deadline is not None)
    if quorum_flags and args.mode != "sync":
        raise SystemExit("--sync-quorum/--round-deadline apply to "
                         "--mode sync (async has no rounds)")
    if quorum_flags and args.store_backend == "native":
        raise SystemExit("--sync-quorum/--round-deadline need "
                         "--store-backend python|device (the C++ arena "
                         "runs its own round loop)")
    if args.restore and not args.checkpoint_dir:
        raise SystemExit("--restore needs --checkpoint-dir")
    shard_index, shard_count = args.shard_index, args.shard_count
    sharding = None
    # A 1-shard server with --shard-peers is a degenerate but real
    # topology: no partitioning, but the shard map, the replica
    # membership and the lag gauges go live.
    if shard_count > 1 or args.shard_peers:
        from .ps.sharding import ShardInfo, partition_keys
        if not 0 <= shard_index < shard_count:
            raise SystemExit(f"--shard-index {shard_index} out of range "
                             f"for --shard-count {shard_count}")
        primaries = [a for a in (args.shard_peers or "").split(",") if a]
        if len(primaries) != shard_count:
            raise SystemExit(f"--shard-peers must list exactly "
                             f"--shard-count={shard_count} addresses "
                             f"(got {len(primaries)})")
        sharding = ShardInfo(shard_index, shard_count, primaries)
    # The model is built on the CPU only to draw its initial weights
    # (get_model draws them from a CPU generator on every device, so a
    # worker's AsyncTrainer on the card starts from the same weights for
    # the same seed).
    model = get_model(args.model, num_classes=args.num_classes,
                      image_size=args.image_size, device="cpu",
                      seed=args.seed)
    flat, _ = params_to_jax(model)
    if sharding is not None:
        # This primary holds ONLY its consistent-hash key range; workers
        # fan pushes and fetches out per shard and reassemble the model.
        total = len(flat)
        mine = set(partition_keys(flat, shard_count)[shard_index])
        flat = {k: v for k, v in flat.items() if k in mine}
        print(f"shard {shard_index}/{shard_count}: owning "
              f"{len(flat)}/{total} of the model's tensors",
              file=sys.stderr)
    store_kw = {"device": args.device} \
        if args.store_backend == "device" else {}
    store = make_store(
        args.store_backend, flat,
        StoreConfig(mode=args.mode, total_workers=args.workers,
                    learning_rate=args.lr,
                    staleness_bound=args.staleness_bound,
                    push_codec=(None if args.push_codec == "default"
                                else args.push_codec),
                    fetch_codec=args.fetch_codec,
                    compressed_domain=not args.no_compressed_domain,
                    elastic=args.elastic,
                    worker_timeout=args.worker_timeout,
                    sync_quorum=args.sync_quorum,
                    round_deadline=args.round_deadline,
                    shard_index=shard_index, shard_count=shard_count),
        **store_kw)
    monitor = None
    if not args.no_health_monitor:
        # On by default: the observe-only layer. --no-health-monitor also
        # stops the capability being advertised to workers at all.
        from .telemetry import (ClusterMonitor, HealthThresholds,
                                set_cluster_monitor)
        monitor = ClusterMonitor(
            store,
            HealthThresholds(dead_after_s=args.dead_after,
                             straggler_lag_steps=args.straggler_lag),
            interval=args.health_interval, emit_stream=args.telemetry)
        set_cluster_monitor(monitor)
        monitor.start()
        if sharding is not None:
            # Shard identity and replica lag ride the /cluster payload.
            monitor.sharding = sharding
        if not args.no_slo:
            from .telemetry import SloEvaluator, default_objectives
            monitor.slo = SloEvaluator(
                default_objectives(fetch_p99_ms=args.slo_fetch_p99_ms,
                                   availability=args.slo_availability),
                fast_window_s=args.slo_fast_window,
                slow_window_s=args.slo_slow_window,
                fast_burn_threshold=args.slo_fast_burn,
                slow_burn_threshold=args.slo_slow_burn)
            print(f"slo: evaluator on (fetch p99 "
                  f"{monitor.slo.objectives[0].threshold_s*1e3:.0f}ms, "
                  f"availability "
                  f"{monitor.slo.objectives[1].target:.3g})",
                  file=sys.stderr, flush=True)
    svc = ParameterService(store, faults=args.faults, monitor=monitor,
                           sharding=sharding)
    if args.remediate or args.remediate_dry_run:
        if monitor is None:
            raise SystemExit("--remediate needs the health monitor "
                             "(drop --no-health-monitor)")
        from .telemetry import RemediationEngine, RemediationPolicy
        engine = RemediationEngine(
            store, service=svc,
            policy=RemediationPolicy(
                dry_run=args.remediate_dry_run,
                cooldown_s=args.remediation_cooldown,
                quarantine_s=args.quarantine_secs))
        monitor.remediation = engine
        monitor.add_listener(engine.handle_events)
        # The synchronous half of the quarantine action: a push whose own
        # report flags non-finite values is refused before the apply (the
        # monitor's quarantine would come one apply too late). A dry run
        # rehearses without it.
        svc.reject_nonfinite = not engine.policy.dry_run
        print(f"remediation: engine on "
              f"(dry_run={engine.policy.dry_run})", file=sys.stderr,
              flush=True)
    if args.faults:
        # The seeded fault plan is the postmortem's root-cause record:
        # journaled at arm time so `cli incident report` opens the
        # narrative with the fault that caused everything after it.
        from .telemetry import journal_event
        journal_event("fault", spec=args.faults, side="server")
    if args.incidents_dir:
        # A critical alert edge freezes journal window + /cluster view +
        # flight-recorder tail into incidents/<id>/, deduped per rule.
        if monitor is None:
            raise SystemExit("--incidents-dir needs the health monitor "
                             "(drop --no-health-monitor)")
        from .telemetry import IncidentCapture, get_journal, get_recorder
        capture = IncidentCapture(
            args.incidents_dir, journal=get_journal(),
            # evaluate=False: the capture runs INSIDE monitor.evaluate()
            # (listener callback, _eval_lock held) — re-evaluating here
            # self-deadlocks and hangs every later /cluster request. The
            # cached state is the as-of-the-edge view anyway.
            views_fn=lambda: {
                "cluster": monitor.cluster_view(evaluate=False)},
            traces_fn=lambda trigger: [
                (f"flight-server-{os.getpid()}.json",
                 get_recorder().dump_payload("incident"))],
            window_s=args.incident_window,
            cooldown_s=args.incident_cooldown, role="server")
        monitor.add_listener(capture.on_alert_events)
        print(f"incidents: capture armed -> {args.incidents_dir}",
              file=sys.stderr, flush=True)
    if monitor is not None and not args.no_memory_telemetry:
        # Host RSS + the card's allocator on the monitor's tick, a
        # windowed leak-slope verdict in /cluster "memory", and the
        # memory_growth rule through the same alert pipeline. It reads
        # this command's --device (None on the CPU).
        from .telemetry import MemoryMonitor, read_device_memory
        monitor.memory = MemoryMonitor(device_fn=functools.partial(
            read_device_memory, args.device))
    if args.profile_triggers:
        # slo_burn edges (listener) and goodput-fraction drops (fed each
        # evaluation pass) capture a bounded torch.profiler window on
        # --device into the PROFILE ledger, deduped per rule.
        if monitor is None:
            raise SystemExit("--profile-triggers needs the health "
                             "monitor (drop --no-health-monitor)")
        from .telemetry import ProfileTrigger
        from .telemetry.proftrigger import default_capture
        ptrig = ProfileTrigger(
            args.profiles_dir,
            capture_fn=functools.partial(default_capture,
                                         device=args.device),
            window_s=args.profile_window,
            cooldown_s=args.profile_cooldown,
            goodput_drop_threshold=args.goodput_drop_threshold,
            role="server")
        monitor.add_listener(ptrig.on_alert_events)
        monitor.profile_trigger = ptrig
        print(f"profiles: trigger engine armed -> {ptrig.profiles_dir} "
              f"(window {ptrig.window_s:.1f}s, cooldown "
              f"{ptrig.cooldown_s:.0f}s)", file=sys.stderr, flush=True)
    if args.autoscale and monitor is None:
        raise SystemExit("--autoscale needs the health monitor "
                         "(drop --no-health-monitor)")
    restored = None
    if args.restore:
        from .checkpoint import load_store_record, restore_server_state
        try:
            # Loaded once and passed to the restore below, so the adopted
            # config and the restored params/journal come from the same
            # record even if a newer snapshot lands in between.
            record = load_store_record(args.checkpoint_dir)
        except FileNotFoundError:
            # A restart policy passes --restore unconditionally; the first
            # boot has nothing to restore and starts fresh.
            print(f"restore: no snapshot in {args.checkpoint_dir}; "
                  f"starting fresh", file=sys.stderr)
            record = None
        if record is not None:
            # A restarted server resumes the RUN it crashed out of, not a
            # different one because a flag defaulted differently.
            agg = record[1].get("aggregation", {})
            for field in ("mode", "learning_rate", "staleness_bound"):
                if field in agg \
                        and getattr(store.config, field) != agg[field]:
                    print(f"restore: adopting snapshot {field}="
                          f"{agg[field]!r} (flags said "
                          f"{getattr(store.config, field)!r})",
                          file=sys.stderr)
                    setattr(store.config, field, agg[field])
            restored, journal_n = restore_server_state(
                store, svc, args.checkpoint_dir, record=record)
            print(f"restored store at step {restored} (+{journal_n} "
                  f"journaled push tokens) from {args.checkpoint_dir}",
                  file=sys.stderr)
    ckpt = None
    if args.checkpoint_dir:
        from .checkpoint import PeriodicStoreCheckpointer
        from .telemetry import add_shutdown_flush, install_shutdown_hooks
        ckpt = PeriodicStoreCheckpointer(
            store, args.checkpoint_dir, interval=args.checkpoint_interval,
            journal_fn=svc.journal_snapshot,
            migration_fn=svc.migration_snapshot)
        ckpt.start()
        # SIGTERM drains the store's end state through the same shutdown
        # path that dumps the flight recorder: a terminated server
        # resumes exactly where it was killed.
        install_shutdown_hooks(role="server")
        add_shutdown_flush(ckpt.flush_now)
    server, port = serve(store, port=args.port, service=svc)
    pool = None
    if args.autoscale:
        # The policy head rides the monitor's background tick; the pool
        # spawns `cli replica` children against THIS primary's bound port
        # (JAX cli.py:1647-1675).
        from .ps.supervisor import ReplicaPool, build_replica_argv
        from .telemetry import AutoscalePolicy, ReplicaAutoscaler
        primary_addr = f"localhost:{port}"
        replica_args = ["--shard-id", str(shard_index)]
        pool = ReplicaPool(
            lambda idx, parent=None: build_replica_argv(
                primary_addr, replica_args, idx, parent=parent))
        monitor.autoscaler = ReplicaAutoscaler(
            pool,
            AutoscalePolicy(
                qps_high=args.autoscale_qps_high,
                qps_low=args.autoscale_qps_low,
                min_replicas=args.autoscale_min,
                max_replicas=args.autoscale_max,
                cooldown_s=args.autoscale_cooldown,
                max_tier=args.autoscale_max_tier,
                fanout=args.autoscale_fanout,
                dry_run=args.autoscale_dry_run),
            sharding=sharding)
        print(f"autoscale: on (replicas "
              f"{monitor.autoscaler.policy.min_replicas}.."
              f"{monitor.autoscaler.policy.max_replicas}, "
              f"max_tier={monitor.autoscaler.policy.max_tier}, "
              f"dry_run={monitor.autoscaler.policy.dry_run})",
              file=sys.stderr, flush=True)
    print(f"parameter server up on :{port} (mode={store.config.mode}, "
          f"workers={args.workers}, backend={args.store_backend}"
          + (f", restored_step={restored}" if restored is not None else "")
          + (f", shard={shard_index}/{shard_count}"
             if sharding is not None else "")
          + (", faults=on" if svc.faults is not None else "")
          + ")", file=sys.stderr, flush=True)

    try:
        # Exits once every registered worker sent JobFinished; with
        # --worker-timeout each tick also expires silent workers.
        # --profile-dir brackets the whole serving window.
        with _profiler_session(args.profile_dir, args.device):
            while not store.wait_all_finished(timeout=1.0):
                expired = store.expire_stale_workers()
                if expired:
                    print(f"expired silent workers: {expired}",
                          file=sys.stderr)
                    if monitor is not None:
                        monitor.note_expired(expired)
        time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(grace=2.0)
        if pool is not None:
            pool.stop()
        if monitor is not None:
            from .telemetry import set_cluster_monitor
            monitor.stop(final=True)
            set_cluster_monitor(None)
        if ckpt is not None:
            from .telemetry import remove_shutdown_flush
            remove_shutdown_flush(ckpt.flush_now)
            err = ckpt.stop(final_snapshot=True)
            if err is not None:
                print(f"last periodic snapshot had failed: {err!r}",
                      file=sys.stderr)
    if args.emit_metrics:
        emit_metrics_json(store.metrics())
    return 0


def cmd_worker(args) -> int:
    """One remote worker: trains on ``--device`` (the card unless asked
    for the CPU) against the server at ``--server``, or against the shard
    primaries ``--shards`` lists through a ``ShardedRemoteStore``."""
    if args.shards and args.job:
        raise SystemExit("--job does not compose with --shards "
                         "(tenancy and sharding run on separate "
                         "servers, docs/TENANCY.md)")
    _refuse_later_flags(args)
    with _telemetry_session(args, "worker"):
        return _cmd_worker(args)


def _cmd_worker(args) -> int:
    from .comms.client import RemoteStore
    from .models import get_model
    from .ps.worker import PSWorker, WorkerConfig
    from .utils.metrics import emit_metrics_json

    cfg = WorkerConfig(batch_size=args.batch_size, num_epochs=args.epochs,
                       sync_steps=args.sync_steps,
                       k_step_mode=args.k_step_mode,
                       augment=not args.no_augment, seed=args.seed,
                       heartbeat_interval=args.heartbeat,
                       overlap=args.overlap,
                       delta_fetch=not args.no_delta_fetch,
                       reconnect_timeout=args.reconnect_timeout,
                       error_feedback=not args.no_error_feedback,
                       topk_frac=args.topk_frac, local_lr=args.local_lr,
                       device=args.device)
    dataset = _load_dataset(args)
    model = get_model(args.model, num_classes=dataset.num_classes,
                      dtype=args.dtype, image_size=dataset.x_train.shape[1],
                      device=args.device, seed=args.seed)
    if args.shards:
        from .comms.sharded import ShardedRemoteStore
        store = ShardedRemoteStore(args.shards, faults=args.faults)
    else:
        store = RemoteStore(args.server, faults=args.faults)
    worker = PSWorker(store, model, dataset, cfg,
                      worker_name=args.worker_name)
    with _profiler_session(args.profile_dir, args.device):
        worker.start()
        worker.join()
    store.close()
    if worker.result.error is not None:
        raise worker.result.error
    if args.emit_metrics:
        emit_metrics_json(worker.result.metrics(
            total_workers=0, learning_rate=args.lr, config=cfg))
    return 0


def cmd_replica(args) -> int:
    """A read replica of one shard primary (``comms/replica.py``): host
    code that serves the primary's payload bytes verbatim, until Ctrl-C
    (or SIGTERM through the telemetry hooks)."""
    with _telemetry_session(args, "replica"):
        return _cmd_replica(args)


def _cmd_replica(args) -> int:
    import time

    from .comms.replica import ReplicaServer

    metrics_adv = args.metrics_advertise
    if metrics_adv is None and getattr(args, "_metrics_bound", None):
        metrics_adv = f"localhost:{args._metrics_bound}"
    rep = ReplicaServer(args.primary, port=args.port,
                        shard_id=args.shard_id,
                        advertise=args.advertise,
                        metrics_advertise=metrics_adv,
                        poll_interval=args.poll_interval,
                        staleness_bound_s=args.staleness_bound,
                        canary=args.canary,
                        canary_fraction=args.canary_fraction,
                        canary_min_samples=args.canary_min_samples,
                        canary_tolerance=args.canary_tolerance,
                        faults=args.faults, parent=args.parent,
                        reparent_after=args.reparent_after,
                        reparent_cooldown_s=args.reparent_cooldown)
    port = rep.start()
    print(f"replica up on :{port} (primary={args.primary}, "
          f"parent={rep.parent}, tier={rep.tier}, "
          f"shard={args.shard_id}, "
          f"staleness_bound={rep.staleness_bound_s:g}s"
          + ("" if args.staleness_bound is not None else " (tier-derived)")
          + (f", canary=1/{rep.canary.period}" if rep.canary is not None
             else "")
          + ")", file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        rep.stop()
    return 0


def cmd_loadgen(args) -> int:
    """The fetch-path load generator (``comms/loadgen.py``): prints one
    ``LOADGEN_JSON`` line, merged over ``--scale-out`` generator
    processes when given."""
    import json as _json

    from .comms.loadgen import run_loadgen, run_loadgen_scaled

    _refuse_later_flags(args)
    if args.scale_out > 0:
        result = run_loadgen_scaled(args.targets, duration_s=args.duration,
                                    concurrency=args.concurrency,
                                    mode=args.fetch_mode,
                                    scale_out=args.scale_out)
    else:
        result = run_loadgen(args.targets, duration_s=args.duration,
                             concurrency=args.concurrency,
                             mode=args.fetch_mode)
    print("LOADGEN_JSON " + _json.dumps(result), flush=True)
    lat = result["latency_ms"]
    print(f"{result['qps']:.1f} fetch/s aggregate over "
          f"{len(result['targets'])} target(s) "
          f"({result['fetches_err']} errors, "
          f"{result['mb_per_s']:.2f} MB/s in, latency p50/p95/p99 "
          f"{lat['p50']:g}/{lat['p95']:g}/{lat['p99']:g} ms)"
          + (f" [merged from {result.get('reports')} generator "
             f"processes]" if args.scale_out > 0 else ""),
          file=sys.stderr)
    for arm, row in (result.get("arms") or {}).items():
        print(f"  arm={arm}: {row['ok']} served, "
              f"quality={row['quality_mean']}, steps="
              f"{row['serving_steps']}", file=sys.stderr)
    return 0 if result["fetches_ok"] > 0 else 1


def cmd_infer(args) -> int:
    """One-shot inference client: a raw stub like loadgen's (no
    RemoteStore: the reply's tensor payload is never decoded)."""
    import json as _json
    import time

    import grpc as _grpc

    from .comms.service import (GRPC_OPTIONS, SERVICE_NAME, pack_msg,
                                unpack_msg)

    ident = lambda b: b  # noqa: E731
    channel = _grpc.insecure_channel(args.target, options=GRPC_OPTIONS)
    stub = channel.unary_unary(f"/{SERVICE_NAME}/FetchParameters",
                               request_serializer=ident,
                               response_deserializer=ident)
    served = []
    meta: dict = {"infer": True}
    try:
        for _ in range(max(1, int(args.count))):
            t0 = time.perf_counter()
            reply = stub(pack_msg(meta), timeout=10.0)
            dt = time.perf_counter() - t0
            rmeta, payload = unpack_msg(reply)
            arm = rmeta.get("arm") or "stable"
            step = rmeta.get("serving_step",
                             rmeta.get("global_step"))
            served.append({"arm": arm, "serving_step": step,
                           "bytes": len(payload),
                           "latency_ms": round(dt * 1e3, 3)})
            meta = {"infer": True}
            if args.quality is not None and step is not None:
                meta["quality"] = {"arm": arm, "step": int(step),
                                   "value": float(args.quality)}
    finally:
        channel.close()
    print("INFER_JSON " + _json.dumps({"target": args.target,
                                       "served": served}), flush=True)
    if not args.json:
        for row in served:
            print(f"arm={row['arm']} step={row['serving_step']} "
                  f"{row['bytes']}B {row['latency_ms']}ms",
                  file=sys.stderr)
    return 0 if served else 1


def cmd_supervise(args) -> int:
    with _telemetry_session(args, "supervisor"):
        return _cmd_supervise(args)


def _parse_slot_map(pairs: list[str], what: str) -> dict:
    out: dict = {}
    for raw in pairs:
        slot, sep, rest = raw.partition(":")
        if not sep or not slot.isdigit():
            raise SystemExit(f"bad {what} {raw!r} (want SLOT:{what})")
        out[int(slot)] = rest
    return out


def _cmd_supervise(args) -> int:
    """The JAX verb's supervisor over ``cli worker`` children of the
    port. The process itself is host code: it loads no torch and holds no
    CUDA context; only its children touch the card."""
    from .ps.supervisor import (SupervisorConfig, WorkerSupervisor,
                                build_worker_argv, install_signal_stop)

    worker_args = list(args.worker_args)
    if worker_args and worker_args[0] == "--":
        worker_args = worker_args[1:]
    if not worker_args:
        raise SystemExit("supervise: pass the child worker args after "
                         "`--` (at least --server HOST:PORT)")
    slot_faults = _parse_slot_map(args.slot_faults, "SPEC")
    slot_env = {}
    for slot, kv in _parse_slot_map(args.slot_env, "KEY=VALUE").items():
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"bad --slot-env value {kv!r}")
        slot_env.setdefault(slot, {})[key] = val
    # Children inherit the device the supervisor was given; with none
    # they run on the card, `cli worker`'s default.
    if args.device != "cuda" and "--device" not in worker_args:
        worker_args += ["--device", args.device]

    def argv_for(slot: int, attempt: int):
        return build_worker_argv(worker_args, slot,
                                 first_spawn_faults=slot_faults,
                                 first_spawn_env=slot_env,
                                 attempt=attempt)

    sup = WorkerSupervisor(argv_for, args.workers, SupervisorConfig(
        respawn=not args.no_respawn,
        backoff_initial=args.respawn_backoff,
        backoff_max=args.respawn_backoff_max,
        healthy_after=args.healthy_after,
        crash_loop_after=args.crash_loop_after))
    install_signal_stop(sup)
    print(f"supervisor: {args.workers} worker slot(s), "
          f"respawn={'on' if not args.no_respawn else 'off'}",
          file=sys.stderr, flush=True)
    scaler_thread = None
    scaler_stop = None
    if args.autoscale_job:
        # Worker autoscaling (docs/TENANCY.md): the policy head polls the
        # serve process's per-job /cluster view for admission-queue and
        # straggler pressure; this supervisor's slot count is the
        # actuator (worker_grow/worker_shrink). A primary without jobs
        # publishes no job row: the pressure reads empty.
        if not args.autoscale_url:
            raise SystemExit("--autoscale-job needs --autoscale-url "
                             "(the serve process's metrics endpoint)")
        import json as _json
        import threading as _threading
        from urllib.request import urlopen

        from .telemetry.remediation import (WorkerAutoscalePolicy,
                                            WorkerAutoscaler)
        cluster_url = args.autoscale_url.rstrip("/") + "/cluster"
        scale_job = args.autoscale_job

        def pressure() -> dict:
            view = _json.loads(urlopen(cluster_url, timeout=5).read())
            row = (view.get("jobs") or {}).get(scale_job) or {}
            members = set(row.get("workers") or [])
            stragglers = sum(
                1 for a in view.get("alerts") or []
                if a.get("rule") == "straggler_lag"
                and a.get("worker") in members)
            return {"queue_depth": row.get("waiting") or 0,
                    "stragglers": stragglers,
                    "workers": len(members)}

        scaler = WorkerAutoscaler(
            scale_job, pressure, supervisor=sup,
            policy=WorkerAutoscalePolicy(
                depth_high=args.autoscale_depth_high,
                depth_low=args.autoscale_depth_low,
                sustain_ticks=args.autoscale_sustain,
                min_workers=args.autoscale_min,
                max_workers=args.autoscale_max,
                cooldown_s=args.autoscale_cooldown))
        scaler_stop = _threading.Event()

        def _scale_loop() -> None:
            while not scaler_stop.wait(args.autoscale_poll):
                scaler.tick()  # never raises

        scaler_thread = _threading.Thread(target=_scale_loop,
                                          daemon=True,
                                          name="worker-autoscaler")
        print(f"worker-autoscale: job={scale_job} slots "
              f"{args.autoscale_min}..{args.autoscale_max} "
              f"depth {args.autoscale_depth_low:g}/"
              f"{args.autoscale_depth_high:g} "
              f"sustain={args.autoscale_sustain}",
              file=sys.stderr, flush=True)
    sup.start()
    if scaler_thread is not None:
        scaler_thread.start()
    try:
        return sup.run()
    finally:
        if scaler_stop is not None:
            scaler_stop.set()
            scaler_thread.join(timeout=5.0)


def _reshard_crash_if(args, point: str) -> None:
    """Deterministic coordinator kill at a phase boundary (the chaos
    drill's four crash points). Hard exit — no cleanup, exactly what a
    crashed coordinator leaves behind."""
    if args.crash_after == point:
        print(f"RESHARD_CRASH_POINT {point}", flush=True)
        os._exit(21)


def _reshard_plan(smeta: dict, donor: int, recipient: int,
                  lo: int, hi: int, n: int, mig_id: str,
                  lease_ttl: float) -> dict:
    """Compute the FULL migration plan — post-move partition and target
    map version — from the donor's live map (a ``status`` reply), before
    anything is frozen. The plan rides every subsequent op as the
    ``migration`` meta field, so each primary's ledger record carries
    everything a resumed coordinator needs."""
    live = smeta.get("shard_map") or {}
    ranges = [tuple(sh["slot_range"]) for sh in live.get("shards", [])]
    if len(ranges) != n:
        raise SystemExit(f"donor's shard map lists {len(ranges)} "
                         f"shards, expected {n}")
    dlo, dhi = ranges[donor]
    rlo, rhi = ranges[recipient]
    if not dlo <= lo < hi <= dhi:
        raise SystemExit(f"slots [{lo},{hi}) not owned by donor "
                         f"{donor} (owns [{dlo},{dhi}))")
    # The moved range must sit at the donor boundary FACING the
    # recipient, so both stay contiguous after the handoff.
    if recipient == donor + 1:
        if hi != dhi:
            raise SystemExit(f"moving to shard {recipient} needs "
                             f"HI == donor's upper bound {dhi}")
        ranges[donor] = (dlo, lo)
        ranges[recipient] = (lo, rhi)
    else:
        if lo != dlo:
            raise SystemExit(f"moving to shard {recipient} needs "
                             f"LO == donor's lower bound {dlo}")
        ranges[donor] = (hi, dhi)
        ranges[recipient] = (rlo, hi)
    return {"id": mig_id, "slot_lo": lo, "slot_hi": hi,
            "ranges": [list(r) for r in ranges],
            "map_version": int(live.get("version", 0)) + 1,
            "lease_ttl": float(lease_ttl)}


def _reshard_apply_order(stores, donor: int, recipient: int) -> list:
    """Publish order: donor FIRST (its apply is the commit point — the
    lease stops applying and the migration becomes roll-forward-only),
    recipient second, bystanders after."""
    order = [donor, recipient] + [i for i in range(len(stores))
                                  if i not in (donor, recipient)]
    return [(i, stores[i]) for i in order]


def _reshard_publish(stores, donor: int, recipient: int, plan: dict,
                     args) -> dict:
    """apply_ranges everywhere (idempotent server side, so a resumed
    coordinator re-applies safely), then commit on the donor. Returns
    the commit reply meta."""
    first = True
    for _i, s in _reshard_apply_order(stores, donor, recipient):
        s.reshard_op("apply_ranges", ranges=plan["ranges"],
                     map_version=plan["map_version"], migration=plan)
        if first:
            first = False
            _reshard_crash_if(args, "apply_first")
    _reshard_crash_if(args, "apply_all")
    cmeta, _ = stores[donor].reshard_op(
        "commit", slot_lo=plan["slot_lo"], slot_hi=plan["slot_hi"],
        migration=plan)
    return cmeta


def _reshard_run(stores, donor: int, recipient: int, plan: dict,
                 args) -> int:
    """The full protocol under a ledger plan: export -> import ->
    lease re-check -> publish (apply donor-first) -> commit."""
    import json as _json

    lo, hi = plan["slot_lo"], plan["slot_hi"]
    # 1. Export: the donor freezes [lo,hi), journals the migration record
    #    with its lease deadline, and hands back a consistent params
    #    subset + its push journal.
    emeta, payload = stores[donor].reshard_op(
        "export", slot_lo=lo, slot_hi=hi, migration=plan)
    _reshard_crash_if(args, "export")
    # 2. Import: the recipient adopts the params AND the donor's journal,
    #    so a worker replaying a pre-handoff push token against the new
    #    owner still answers `duplicate`.
    imeta, _ = stores[recipient].reshard_op(
        "import", payload=payload, journal=emeta.get("journal"),
        migration=plan)
    _reshard_crash_if(args, "import")
    # Lease re-check at the point of no return: if the donor's freeze
    # expired while export/import ran, the donor already unfroze and took
    # pushes for [lo,hi) — publishing the map now would hand those writes
    # to the recipient's STALE copy. Abort the recipient instead.
    smeta, _ = stores[donor].reshard_op("status")
    mig = smeta.get("migration")
    if not (isinstance(mig, dict) and mig.get("id") == plan["id"]):
        stores[recipient].reshard_op("abort", migration=plan)
        print(f"RESHARD_LEASE_LOST migration={plan['id']} donor lease "
              f"expired before publish; recipient rolled back, map "
              f"untouched", file=sys.stderr, flush=True)
        return 3
    cmeta = _reshard_publish(stores, donor, recipient, plan, args)
    result = {"migration": plan["id"], "donor": donor,
              "recipient": recipient, "slots": [lo, hi],
              "map_version": plan["map_version"],
              "export_step": emeta.get("export_step"),
              "exported": emeta.get("exported"),
              "adopted": imeta.get("adopted"),
              "journal_loaded": imeta.get("journal_loaded"),
              "dropped": cmeta.get("dropped"),
              "ranges": [list(r) for r in plan["ranges"]]}
    print("RESHARD_JSON " + _json.dumps(result), flush=True)
    if not args.json:
        print(f"moved slots [{lo},{hi}) shard {donor} -> {recipient} "
              f"at step {result['export_step']} "
              f"({result['adopted']} tensors, "
              f"{result['journal_loaded']} journal entries; "
              f"map v{plan['map_version']})", file=sys.stderr)
    return 0


def _reshard_resume(stores, donor: int, recipient: int, args) -> int:
    """Crash-point oracle (docs/ROBUSTNESS.md "Migration failure
    matrix"): read both primaries' ledger records and deterministically
    finish or undo the migration.

    - donor record in ``export`` phase (map never published, lease
      live): ROLL FORWARD from the top — re-export is idempotent (the
      frozen range took no applies) and refreshes the lease.
    - donor record in ``apply_ranges`` phase (map publishing): ROLL
      FORWARD the tail only — re-running export/import here would graft
      the donor's stale copy over writes the recipient already owns.
    - donor record GONE but recipient record present: the lease expired
      (the donor auto-unfroze and kept serving) — ROLL BACK the
      recipient.
    - no records anywhere: nothing in flight (committed or fully
      aborted); report and exit clean."""
    import json as _json

    dmeta, _ = stores[donor].reshard_op("status")
    rmeta, _ = stores[recipient].reshard_op("status")
    drec = dmeta.get("migration")
    rrec = rmeta.get("migration")
    drec = drec if isinstance(drec, dict) else None
    rrec = rrec if isinstance(rrec, dict) else None
    rec = drec or rrec
    if rec is None:
        result = {"outcome": "none", "donor": donor,
                  "recipient": recipient}
        print("RESHARD_RESUME_JSON " + _json.dumps(result), flush=True)
        if not args.json:
            print("no migration in flight on either primary (already "
                  "committed, or rolled back by lease expiry)",
                  file=sys.stderr)
        return 0
    # Rebuild the coordinator's plan from the ledger record: the
    # primaries journaled everything at export/import time.
    plan = {"id": str(rec["id"]), "slot_lo": int(rec["slot_lo"]),
            "slot_hi": int(rec["slot_hi"]),
            "ranges": [list(r) for r in (rec.get("ranges") or [])],
            "map_version": int(rec.get("map_version") or 0),
            "lease_ttl": float(args.lease_ttl)}
    if drec is None:
        # Lease expired: the donor unfroze, kept ownership, and may have
        # applied pushes to [lo,hi) since — the recipient's copy is stale
        # by construction. Roll back.
        ameta, _ = stores[recipient].reshard_op("abort", migration=plan)
        result = {"outcome": "rolled_back", "migration": plan["id"],
                  "dropped": ameta.get("dropped")}
        print("RESHARD_RESUME_JSON " + _json.dumps(result), flush=True)
        if not args.json:
            print(f"migration {plan['id']}: donor lease expired — "
                  f"recipient rolled back ({ameta.get('dropped')} "
                  f"params dropped), map untouched", file=sys.stderr)
        return 0
    if drec.get("phase") == "export":
        rc = _reshard_run(stores, donor, recipient, plan, args)
        outcome = "rolled_forward" if rc == 0 else "rolled_back"
        print("RESHARD_RESUME_JSON " + _json.dumps(
            {"outcome": outcome, "migration": plan["id"],
             "from_phase": "export"}), flush=True)
        return rc
    # Map already publishing: finish apply everywhere + commit.
    cmeta = _reshard_publish(stores, donor, recipient, plan, args)
    result = {"outcome": "rolled_forward", "migration": plan["id"],
              "from_phase": "apply_ranges",
              "map_version": plan["map_version"],
              "dropped": cmeta.get("dropped")}
    print("RESHARD_RESUME_JSON " + _json.dumps(result), flush=True)
    if not args.json:
        print(f"migration {plan['id']}: map v{plan['map_version']} "
              f"re-published everywhere, donor committed "
              f"({cmeta.get('dropped')} params dropped)",
              file=sys.stderr)
    return 0


def _reshard_abort_cmd(stores, donor: int, recipient: int, args) -> int:
    """Operator-driven roll-back. Refused once the donor's map publish
    began (phase ``apply_ranges``): from there the recipient owns
    writes, and undoing the publish would lose them — --resume rolls
    forward instead."""
    import json as _json

    dmeta, _ = stores[donor].reshard_op("status")
    drec = dmeta.get("migration")
    if isinstance(drec, dict) and drec.get("phase") == "apply_ranges":
        print(f"migration {drec.get('id')} already publishing its map — "
              f"abort refused, run --resume to roll forward",
              file=sys.stderr)
        return 4
    # Recipient first (drop the copy while the donor still owns and
    # serves the range), donor second (unfreeze).
    ameta, _ = stores[recipient].reshard_op("abort")
    bmeta, _ = stores[donor].reshard_op("abort")
    result = {"outcome": "aborted",
              "recipient_dropped": ameta.get("dropped"),
              "donor_aborted": bmeta.get("aborted")}
    print("RESHARD_ABORT_JSON " + _json.dumps(result), flush=True)
    if not args.json:
        print(f"migration aborted: recipient dropped "
              f"{ameta.get('dropped')} params, donor unfroze, map "
              f"untouched", file=sys.stderr)
    return 0


def cmd_reshard(args) -> int:
    """Live migration coordinator (docs/SHARDING.md "Migration
    protocol", docs/ROBUSTNESS.md "Migration failure matrix"): status ->
    plan -> export -> import -> lease re-check -> apply_ranges (donor
    first) -> commit. Every op carries the full plan under a migration
    id, each primary journals its phase through the checkpoint
    machinery, and the donor's freeze holds a TTL lease, so a
    coordinator killed at ANY boundary is recoverable with ``--resume``
    and a never-resumed crash self-heals by lease expiry. Host code: it
    loads no torch."""
    import uuid

    from .comms.client import RemoteStore

    try:
        lo, hi = (int(x) for x in args.slots.split(":"))
    except ValueError:
        raise SystemExit(f"--slots must be LO:HI, got {args.slots!r}")
    primaries = [a for a in args.primaries.split(",") if a]
    donor, recipient = int(args.donor), int(args.recipient)
    n = len(primaries)
    if not (0 <= donor < n and 0 <= recipient < n):
        raise SystemExit(f"--donor/--recipient out of range for "
                         f"{n} primaries")
    if abs(donor - recipient) != 1:
        raise SystemExit("recipient must be adjacent to donor "
                         "(donor±1): per-shard slot ranges stay "
                         "contiguous (docs/SHARDING.md)")
    if args.resume and args.abort:
        raise SystemExit("--resume and --abort are mutually exclusive")
    stores = [RemoteStore(a) for a in primaries]
    try:
        if args.abort:
            return _reshard_abort_cmd(stores, donor, recipient, args)
        if args.resume:
            return _reshard_resume(stores, donor, recipient, args)
        mig_id = args.migration_id or f"mig-{uuid.uuid4().hex[:10]}"
        smeta, _ = stores[donor].reshard_op("status")
        plan = _reshard_plan(smeta, donor, recipient, lo, hi, n,
                             mig_id, args.lease_ttl)
        return _reshard_run(stores, donor, recipient, plan, args)
    finally:
        for s in stores:
            s.close()


def cmd_perf(args) -> int:
    if args.perf_command == "check":
        raise NotImplementedError(
            "cli perf check is not ported yet; it comes with "
            + LATER_VERBS["perf check"])
    if args.perf_command == "diff":
        return _cmd_perf_diff(args)
    return _cmd_perf_profile(args)


def _cmd_perf_profile(args) -> int:
    """Parse a ``--profile-dir`` capture into the merged perf-observatory
    artifact (``analysis/device_profile.py``): per-op-class device time,
    optionally joined with the flight-recorder critical-path report so
    step wall reconciles against attributed device time (JAX
    ``cli.py:3188-3246``)."""
    import json

    from .analysis.device_profile import (attribute_profile,
                                          render_profile_table)
    critical = None
    if args.trace_dump_dir:
        from .analysis.traces import (critical_path_report,
                                      find_trace_dumps, load_trace_dumps)
        dumps = find_trace_dumps(args.trace_dump_dir)
        if dumps:
            critical = critical_path_report(load_trace_dumps(dumps))
        else:
            print(f"perf profile: no trace-*.json dumps in "
                  f"{args.trace_dump_dir} — skipping the critical-path "
                  f"join", file=sys.stderr)
    device_kind = args.device_kind
    if device_kind is None:
        import torch
        if torch.cuda.is_available():
            device_kind = torch.cuda.get_device_name(0)
    report = attribute_profile(args.profile_dir, critical=critical,
                               device_kind=device_kind)
    if not report["trace_files"]:
        print(f"perf profile: no profiler dumps under {args.profile_dir} "
              f"(expected plugins/profile/<run>/*.trace.json.gz)",
              file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"perf profile: artifact -> {args.out}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_profile_table(report))
    # Raw Chrome traces are scratch once the artifact exists: prune on
    # success, keep on failure so a basis=none / parse-error capture
    # stays debuggable.
    if (not args.keep_traces
            and report["profile"].get("basis") not in (None, "none")
            and not report.get("parse_errors")):
        from .telemetry.profiler import prune_capture
        pruned = prune_capture(args.profile_dir)
        if pruned:
            print(f"perf profile: pruned {len(pruned)} raw trace "
                  f"file(s) from {args.profile_dir} (--keep-traces to "
                  f"keep)", file=sys.stderr)
    return 0


def _cmd_perf_diff(args) -> int:
    """``cli perf diff BASELINE CANDIDATE`` — per-op-class regression
    attribution between two recorded artifacts. Refuses to compare
    artifacts whose attribution bases differ."""
    import json

    from .analysis.device_profile import diff_profiles, render_profile_diff

    arts = []
    for path in (args.baseline, args.candidate):
        try:
            with open(path) as f:
                arts.append(json.load(f))
        except (OSError, ValueError) as e:
            print(f"perf diff: cannot read artifact {path}: {e}",
                  file=sys.stderr)
            return 1
    try:
        diff = diff_profiles(arts[0], arts[1],
                             unchanged_tolerance=args.tolerance)
    except ValueError as e:
        print(f"perf diff: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(diff, indent=2))
    else:
        print(render_profile_diff(diff))
    return 0


def _replica_tree_lines(sh: dict, indent: str = "  ") -> list[str]:
    """Render a sharding block's replica rows as the fan-out tree
    (docs/SHARDING.md "Fan-out trees"): children indent under their
    parent with tier + lag, depth-first in address order. Rows whose
    parent is neither a live replica nor a primary render under an
    explicit ``orphaned`` header naming the gone parent — a killed or
    stale interior node shows its stranded children instead of
    flattening them away. Pre-tree rows (no ``parent``/``tier``) all
    root at the primary, reproducing the old flat listing."""
    rows = sh.get("replicas", []) or []
    primaries = set(sh.get("primaries", []) or [])
    by_addr = {r.get("address"): r for r in rows if r.get("address")}
    children: dict[str, list] = {}
    roots, orphans = [], {}
    for r in rows:
        parent = r.get("parent")
        if parent is None or parent in primaries:
            roots.append(r)
        elif parent in by_addr:
            children.setdefault(parent, []).append(r)
        else:
            orphans.setdefault(parent, []).append(r)

    def row_line(r: dict, depth: int) -> str:
        qps = r.get("fetch_qps")
        return (f"{indent}{'  ' * depth}replica {r.get('address')}"
                + (f" [tier {r['tier']}]" if "tier" in r else "")
                + f": step={r.get('step')} "
                f"lag={r.get('lag_steps')} step(s), "
                f"announced {r.get('announce_age_s', 0):.1f}s ago"
                + (f", {qps:g} fetch/s" if qps else "")
                + (f" (via {r['via']})" if "via" in r else ""))

    lines: list[str] = []

    def walk(r: dict, depth: int, seen: set) -> None:
        addr = r.get("address")
        if addr in seen:  # defensive: a cyclic view must not hang
            return
        seen.add(addr)
        lines.append(row_line(r, depth))
        for c in sorted(children.get(addr, []),
                        key=lambda x: str(x.get("address"))):
            walk(c, depth + 1, seen)

    seen: set = set()
    for r in sorted(roots, key=lambda x: str(x.get("address"))):
        walk(r, 0, seen)
    # Subtrees hanging off a live interior node already walked above;
    # whatever never got visited hangs off a DEAD parent — show it.
    for parent in sorted(orphans):
        stranded = [r for r in orphans[parent]
                    if r.get("address") not in seen]
        if not stranded:
            continue
        lines.append(f"{indent}orphaned (parent {parent} gone):")
        for r in sorted(stranded, key=lambda x: str(x.get("address"))):
            walk(r, 1, seen)
    tiers = sh.get("tiers") or {}
    if any("tier" in r for r in rows) and tiers:
        roll = "; ".join(
            f"tier {t}: {v.get('replicas', 0)} replica(s), "
            f"max_lag={v.get('max_lag_steps', 0)}, "
            f"{v.get('fetch_qps', 0):g} fetch/s"
            for t, v in sorted(tiers.items(), key=lambda kv: kv[0]))
        lines.append(f"{indent}tiers: {roll}")
    return lines


def _render_status(view: dict) -> str:
    """The ``cli status`` terminal dashboard: cluster header, per-worker
    table, active alerts. Pure text in, text out (tested directly)."""
    sev_mark = {"critical": "CRIT", "warning": "WARN", "info": "INFO"}
    totals = view.get("alerts_total", {})
    gpf = view.get("goodput_fraction")
    header = (f"cluster: mode={view.get('mode', '?')} "
              f"global_step={view.get('global_step', 0)} "
              f"workers={len(view.get('workers', []))} "
              + (f"goodput={gpf * 100:.1f}% "
                 if isinstance(gpf, (int, float))
                 and not isinstance(gpf, bool) else "")
              + f"alerts: critical={totals.get('critical', 0)} "
              f"warning={totals.get('warning', 0)} "
              f"info={totals.get('info', 0)}")
    # The job column renders only when the server is tenancy-enabled
    # (worker rows carry "job") — a pre-tenancy /cluster payload draws
    # the exact pre-tenancy table. The goodput column follows the same
    # degradation discipline: absent from pre-goodput workers' reports,
    # absent from the table.
    has_jobs = any("job" in r for r in view.get("workers", []))
    has_goodput = any("goodput_fraction" in r
                      for r in view.get("workers", []))
    cols = [("worker", 7)] \
        + ([("job", 10)] if has_jobs else []) \
        + [("alive", 6), ("step", 8), ("epoch", 6),
           ("loss", 10), ("grad_norm", 11), ("ex/s", 9)] \
        + ([("goodput", 8)] if has_goodput else []) \
        + [("pipe", 5),
           ("codec", 19), ("reconn", 7), ("hb_err", 7), ("age_s", 7)]
    lines = [header, "-" * len(header)]
    rnd = view.get("round")
    if rnd:
        # Quorum-round state (docs/ROBUSTNESS.md): target vs received,
        # who is excluded, what closed the last round.
        extras = []
        if rnd.get("excluded"):
            extras.append(f"excluded={rnd['excluded']}")
        if rnd.get("deadline_s"):
            extras.append(f"deadline={rnd['deadline_s']:g}s"
                          + ("*" if rnd.get("deadline_armed") else ""))
        if rnd.get("last_trigger"):
            extras.append(f"last={rnd['last_trigger']}")
        lines.append(f"round: received {rnd.get('received', 0)}"
                     f"/{rnd.get('quorum', '?')} "
                     f"(target {rnd.get('target', '?')}"
                     + (", " + ", ".join(extras) if extras else "") + ")")
    lines.append("".join(f"{name:>{w}}" for name, w in cols))

    def cell(v, width, fmt=None):
        if v is None:
            return f"{'-':>{width}}"
        try:
            return f"{(fmt(v) if fmt else v)!s:>{width}}"
        except (TypeError, ValueError):
            return f"{'-':>{width}}"

    for row in view.get("workers", []):
        age = row.get("report_age_s", row.get("last_seen_age_s"))
        loss = row.get("loss")
        if loss is None and not row.get("loss_finite", True):
            loss = "NaN"
        gn = row.get("grad_norm")
        if gn is None and not row.get("grad_finite", True):
            gn = "NaN"
        lines.append("".join([
            cell(row.get("worker"), 7),
            *([cell(row.get("job"), 10)] if has_jobs else []),
            cell("yes" if row.get("alive") else "NO", 6),
            cell(row.get("step"), 8),
            cell(row.get("epoch"), 6),
            cell(loss, 10, lambda v: v if isinstance(v, str)
                 else f"{v:.4f}"),
            cell(gn, 11, lambda v: v if isinstance(v, str)
                 else f"{v:.4g}"),
            cell(row.get("examples_per_s"), 9,
                 lambda v: f"{v:.1f}"),
            *([cell(row.get("goodput_fraction"), 8,
                    lambda v: f"{v * 100:.1f}%")] if has_goodput else []),
            cell(row.get("pipeline_depth"), 5),
            cell(row.get("push_codec"), 19),
            cell(row.get("reconnects"), 7),
            cell(row.get("heartbeat_errors"), 7),
            cell(age, 7, lambda v: f"{v:.1f}"),
        ]))
    alerts = view.get("alerts", [])
    if alerts:
        lines.append("")
        lines.append("active alerts:")
        for a in alerts:
            who = "cluster" if a.get("worker") is None \
                else f"worker {a['worker']}"
            lines.append(f"  [{sev_mark.get(a.get('severity'), '????')}] "
                         f"{a.get('rule')} ({who}): {a.get('message')}")
    else:
        lines.append("")
        lines.append("no active alerts")
    rem = view.get("remediation")
    if rem:
        active = rem.get("active", [])
        tag = " (dry-run)" if rem.get("dry_run") else ""
        lines.append("")
        if active:
            lines.append(f"active remediations{tag}:")
            for r in active:
                who = "cluster" if r.get("worker") is None \
                    else f"worker {r['worker']}"
                lines.append(f"  [{r.get('outcome', '?').upper()}] "
                             f"{r.get('action')} ({who}) <- "
                             f"{r.get('rule')}")
        else:
            lines.append(f"remediation engine on{tag}: no active actions")
        q = rem.get("quarantined")
        if q:
            lines.append("  quarantined pushes: " + ", ".join(
                f"worker {w} ({s:.0f}s left)" for w, s in q.items()))
    sh = view.get("sharding")
    if sh:
        # Shard identity + replica lag (docs/SHARDING.md): which slot of
        # the partition this server is, and how far each announced read
        # replica trails it.
        lines.append("")
        lines.append(f"shard: {sh.get('shard_id', '?')}"
                     f"/{sh.get('shard_count', '?')} "
                     f"map_version={sh.get('map_version', '?')} "
                     f"replicas={len(sh.get('replicas', []))}")
        lines.extend(_replica_tree_lines(sh))
        mig = sh.get("migration")
        if mig:
            # In-flight migration ledger (docs/ROBUSTNESS.md "Migration
            # failure matrix"). Absent block (idle, or a server predating
            # the ledger) renders nothing — degradation-pinned like the
            # slo block.
            lease = mig.get("lease_remaining_s")
            lease_s = "" if lease is None else f" lease={lease:g}s"
            lines.append(
                f"  migration {mig.get('id')}: {mig.get('role')} "
                f"phase={mig.get('phase')} "
                f"slots=[{mig.get('slot_lo')},{mig.get('slot_hi')}) "
                f"frozen={mig.get('frozen_slots', 0)}{lease_s}")
    slo = view.get("slo")
    if slo:
        # Serve-tier SLOs (docs/OBSERVABILITY.md): per-objective
        # quantiles + window burn rates. Absent block (older server, or
        # --no-slo) renders nothing — forward/backward compatible by
        # construction, pinned by the degradation test.
        lines.append("")
        lines.append("slo objectives:")
        for obj in slo.get("objectives", []):
            wins = obj.get("windows", {})
            burns = []
            for rule in sorted(wins):
                w = wins[rule]
                mark = " BREACH" if w.get("breaching") else ""
                burns.append(f"{w.get('window_s', 0):g}s burn "
                             f"{w.get('burn', 0):g}x{mark}")
            thr = (f" p99<={obj['threshold_ms']:g}ms"
                   if obj.get("threshold_ms") is not None else "")
            p99 = obj.get("p99_ms")
            p99_s = "-" if p99 is None else f"{p99:g}ms"
            lines.append(f"  {obj.get('name')}: "
                         f"target={obj.get('target')}{thr} "
                         f"p99={p99_s} n={obj.get('total', 0)} "
                         f"({'; '.join(burns) if burns else 'no windows'})")
        breaches = slo.get("breaches", [])
        if breaches:
            for b in breaches:
                lines.append(
                    f"  [{sev_mark.get(b.get('severity'), '????')}] "
                    f"{b.get('rule')}: {b.get('objective')} burning "
                    f"{b.get('burn')}x budget over "
                    f"{b.get('window_s', 0):g}s "
                    f"({b.get('bad')}/{b.get('total')} bad)")
    jb = view.get("jobs")
    if jb:
        # Tenancy view (docs/TENANCY.md): one line per job — aggregation
        # config, live workers, and the weighted-fair QoS counters when
        # the admission scheduler is on. Absent block (pre-tenancy
        # server) renders nothing.
        lines.append("")
        lines.append("jobs:")
        for name in sorted(jb, key=lambda n: jb[n].get("index", 0)):
            row = jb[name]
            qos = ""
            if "inflight" in row:
                qos = (f" inflight={row.get('inflight')} "
                       f"waiting={row.get('waiting')} "
                       f"fair_share={row.get('fair_share')}")
            spec = ""
            if "weight" in row:
                spec = (f" weight={row.get('weight'):g} "
                        f"max_inflight={row.get('max_inflight')}")
            lines.append(
                f"  {name}: mode={row.get('mode')} "
                f"step={row.get('global_step')} "
                f"workers={len(row.get('workers') or [])} "
                f"slots={len(row.get('slots') or [])}{spec}{qos}")
    wa = view.get("worker_autoscale")
    if wa:
        acts = wa.get("actions") or {}
        lines.append("")
        lines.append(
            f"worker autoscale: job={wa.get('job')} "
            f"bounds {wa.get('min')}..{wa.get('max')} "
            f"depth {wa.get('depth_low'):g}/{wa.get('depth_high'):g} "
            f"grew={acts.get('worker_grow', 0)} "
            f"shrank={acts.get('worker_shrink', 0)}")
    return "\n".join(lines)


def _cluster_view_from_fleet(fleet: dict) -> dict:
    """Synthesize a ``/cluster``-shaped view from a ``/fleet`` snapshot
    so ``cli status --via-fleet`` renders the EXISTING dashboard from
    merged fleet data: worker rows and jobs come from the inventory
    tiers, the alert feed is the fleet-wide one (each alert tagged with
    its source target), the slo block is the fleet-scope evaluation
    over MERGED series, and mode/global_step come from the first
    primary. Blocks the fleet view lacks (round, sharding, remediation)
    are simply absent — ``_render_status`` degrades over them exactly
    as it does for an older server, which is the pinned behavior."""
    tiers = fleet.get("tiers") or {}
    primaries = tiers.get("primaries") or []
    first = primaries[0] if primaries else {}
    alerts = fleet.get("alerts") or []
    totals = {"critical": 0, "warning": 0, "info": 0}
    for a in alerts:
        sev = a.get("severity")
        if sev in totals:
            totals[sev] += 1
    view = {
        "ts": fleet.get("ts"),
        "role": "fleet",
        "mode": first.get("mode"),
        "global_step": first.get("global_step"),
        "workers": tiers.get("workers") or [],
        "alerts": alerts,
        "alerts_total": totals,
    }
    if fleet.get("slo"):
        view["slo"] = fleet["slo"]
    if tiers.get("jobs"):
        view["jobs"] = tiers["jobs"]
    return view


def cmd_status(args) -> int:
    """One-shot (or ``--watch``) render of a serve process's ``/cluster``
    view. Exit codes: 0 healthy, 2 when a CRITICAL alert is active (so a
    cron/script can gate on it), 3 when critical alerts are active BUT
    the remediation engine holds active actions against them — degraded
    but healing (docs/ROBUSTNESS.md): a restart policy should hold off
    and let the self-healing run —, 1 when the endpoint is unreachable or
    has no monitor. SLO breaches ride the same semantics: slo_burn_fast
    is a critical alert (exit 2/3), slo_burn_slow a warning (exit 0) —
    paging on fast burn only is the multi-window point. A server without
    an "slo" block (older build, --no-slo) renders everything else
    unchanged. ``--via-fleet URL`` renders the same dashboard from a
    fleet collector's merged ``/fleet`` snapshot instead — same exit
    codes, evaluated over the whole fleet."""
    import json as _json
    import time as _time
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    via_fleet = getattr(args, "via_fleet", None)
    if via_fleet:
        base = via_fleet
        if not base.startswith(("http://", "https://")):
            base = "http://" + base
        url = base.rstrip("/") + "/fleet"
    else:
        base = args.url
        if not base:
            if args.metrics_port is None:
                print("status: need --url or --metrics-port",
                      file=sys.stderr)
                return 1
            base = f"http://{args.host}:{args.metrics_port}"
        url = base.rstrip("/") + "/cluster"

    def poll() -> tuple[int, dict | None]:
        try:
            raw = _json.loads(urlopen(url, timeout=5).read())
        except HTTPError as e:
            print(f"status: {url} -> HTTP {e.code} "
                  f"({e.read().decode(errors='replace')[:200]})",
                  file=sys.stderr)
            return 1, None
        except (URLError, OSError, ValueError) as e:
            print(f"status: cannot reach {url}: {e}", file=sys.stderr)
            return 1, None
        view = _cluster_view_from_fleet(raw) if via_fleet else raw
        if args.json:
            print(_json.dumps(raw, indent=2))
        else:
            print(_render_status(view))
        critical = view.get("alerts_total", {}).get("critical", 0)
        if via_fleet and not critical:
            # On a primary, slo_burn_fast raises a critical alert via
            # the monitor, so alerts_total already covers it; fleet-
            # scope breaches live only in the slo block.
            critical = any(b.get("severity") == "critical"
                           for b in (raw.get("slo") or {})
                           .get("breaches", []))
        if not critical:
            return 0, view
        # Degraded-but-healing: critical alerts with a live remediation
        # working on them exit 3, not 2 — distinguishable for restart
        # policies that should let the self-healing run its course. A
        # dry-run engine records decisions but executes NOTHING, so it
        # must not claim healing (a policy holding off would wait
        # forever).
        if via_fleet:
            healing = bool(raw.get("remediation_active"))
        else:
            rem = view.get("remediation", {})
            healing = bool(rem.get("active")) and not rem.get("dry_run")
        return (3 if healing else 2), view

    if args.watch <= 0:
        rc, _ = poll()
        return rc
    rc = 0
    try:
        while True:
            print("\x1b[2J\x1b[H", end="")  # clear screen, home cursor
            rc, _ = poll()
            print(f"\n(watching {url} every {args.watch:g}s — Ctrl-C to "
                  f"stop)")
            _time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    return rc


def cmd_observe(args) -> int:
    """The fleet observatory collector process (standalone: off every
    serve hot path, survives primary restarts). Scrapes, rolls up, and
    serves ``GET /fleet`` until interrupted."""
    import threading as _threading

    from .telemetry.fleet import FleetCollector, start_fleet_server
    from .telemetry.registry import MetricsRegistry
    from .telemetry.slo import default_objectives

    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    if not targets:
        print("observe: --targets needs at least one endpoint",
              file=sys.stderr)
        return 1
    registry = MetricsRegistry()
    journal = None
    if getattr(args, "journal_dir", None):
        # Durable fleet journal: one fleet_tick record per
        # scrape (the merged view minus history rings) + slo_burn
        # edges — the `cli top --replay` / `cli query` source.
        from .telemetry.journal import JournalWriter
        journal = JournalWriter(args.journal_dir, role="observer",
                                registry=registry)
    incidents = None
    if getattr(args, "incidents_dir", None):
        from .telemetry.incidents import IncidentCapture
        incidents = IncidentCapture(
            args.incidents_dir, journal=journal,
            window_s=getattr(args, "incident_window", 120.0),
            cooldown_s=getattr(args, "incident_cooldown", 120.0),
            role="observer", registry=registry)
    collector = FleetCollector(
        targets, interval_s=args.interval, timeout_s=args.timeout,
        ring_depth=args.ring_depth,
        registry=registry,
        objectives=default_objectives(
            fetch_p99_ms=args.slo_fetch_p99_ms,
            availability=args.slo_availability),
        fast_window_s=args.slo_fast_window,
        slow_window_s=args.slo_slow_window,
        journal=journal, incidents=incidents)
    if incidents is not None:
        # Bundle context comes from the collector itself: the merged
        # /fleet view, and flight-recorder dumps pulled over HTTP from
        # the (still-reachable) implicated targets.
        incidents.views_fn = lambda: {"fleet": collector.view()}
        incidents.traces_fn = \
            lambda trigger: _fleet_trace_dumps(collector)
        print(f"observe: incident capture armed -> {args.incidents_dir}",
              file=sys.stderr, flush=True)
    server, port = start_fleet_server(collector, port=args.port)
    print(f"observe up on :{port} ({len(targets)} seed target(s), "
          f"interval={args.interval:g}s, timeout={args.timeout:g}s)",
          file=sys.stderr, flush=True)
    stop = _threading.Event()
    try:
        collector.run_forever(stop)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        server.shutdown()
        if journal is not None:
            journal.seal()
    return 0


def _fleet_trace_dumps(collector, limit: int = 4) -> list:
    """Best-effort ``/debug/trace`` pulls from the fleet's reachable
    targets for an incident bundle's ``traces/`` directory."""
    import json as _json
    import urllib.request as _request
    out = []
    try:
        view = collector.view()
    except Exception:  # noqa: BLE001 — capture context is best-effort
        return out
    for row in view.get("targets", []):
        if len(out) >= limit:
            break
        base = row.get("target")
        if not base or not row.get("ok"):
            continue
        try:
            with _request.urlopen(base + "/debug/trace",
                                  timeout=collector.timeout_s) as r:
                payload = _json.loads(r.read().decode())
        except Exception:  # noqa: BLE001 — dead target = no dump
            continue
        name = base.split("//", 1)[-1].replace(":", "-").replace("/", "_")
        out.append((f"trace-{name}.json", payload))
    return out


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _sparkline(values, width: int = 40) -> str:
    """Ring history -> a fixed-width unicode sparkline (None samples —
    e.g. p99 before any fetch — are skipped)."""
    vals = [float(v) for v in values if v is not None][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_CHARS[0] * len(vals)
    return "".join(_SPARK_CHARS[min(7, int((v - lo) / span * 8))]
                   for v in vals)


def _top_exit_code(view: dict) -> int:
    """``cli status``-consistent: 0 healthy, 2 critical (a critical
    alert anywhere in the fleet, or a fleet-scope fast-burn breach),
    3 critical-but-healing (some primary's remediation engine is live
    and not dry-run)."""
    critical = any(a.get("severity") == "critical"
                   for a in view.get("alerts", []))
    critical = critical or any(
        b.get("severity") == "critical"
        for b in (view.get("slo") or {}).get("breaches", []))
    if not critical:
        return 0
    return 3 if view.get("remediation_active") else 2


def _render_top(view: dict) -> str:
    """The ``cli top`` fleet dashboard: header + sparklines + per-tier
    rows + fleet SLO burn + alert feed. Pure text in, text out (tested
    directly, like ``_render_status``)."""
    sev_mark = {"critical": "CRIT", "warning": "WARN", "info": "INFO"}
    targets = view.get("targets", [])
    n_ok = sum(1 for t in targets if t.get("ok"))
    scrape = view.get("scrape", {})
    hist = view.get("history", {})
    p99s = [v for v in hist.get("p99_ms", []) if v is not None]
    p99 = p99s[-1] if p99s else None
    header = (f"fleet: targets {n_ok}/{len(targets)} up "
              f"qps={view.get('fleet_qps', 0):g} "
              f"p99={'-' if p99 is None else f'{p99:g}ms'} "
              f"series={view.get('series_count', 0)} "
              f"tick#{view.get('ticks', 0)} "
              f"(scrape {scrape.get('last_ms', 0):g}ms)")
    lines = [header, "-" * len(header)]
    for name, label in (("fleet_qps", "qps"), ("p99_ms", "p99ms"),
                        ("scrape_ms", "scrape")):
        ring = hist.get(name, [])
        cur = [v for v in ring if v is not None]
        lines.append(f"  {label:>7} {_sparkline(ring):<40} "
                     f"{cur[-1] if cur else '-'}")
    prim = (view.get("tiers") or {}).get("primaries") or []
    if prim:
        lines.append("")
        lines.append("primaries:")
        for row in prim:
            shard = ("" if row.get("shard_id") is None
                     else f" shard={row['shard_id']}"
                          f" map_v{row.get('map_version', '?')}")
            lines.append(
                f"  {row.get('target')}: "
                f"{'up' if row.get('ok') else 'STALE'} "
                f"mode={row.get('mode')} step={row.get('global_step')}"
                f"{shard} alerts={row.get('alerts', 0)}")
    tier_view = view.get("tiers") or {}
    reps = tier_view.get("replicas") or []
    if reps:
        lines.append("")
        lines.append("replicas:")
        # Reuse the fan-out-tree renderer on the fleet rows: primaries
        # here must be gRPC addresses (the rows' ``parent`` namespace),
        # not the scrape targets the fleet polls.
        lines.extend(_replica_tree_lines({
            "replicas": reps,
            "primaries": tier_view.get("primary_addresses") or [],
            "tiers": tier_view.get("replica_tiers") or {},
        }))
    workers = (view.get("tiers") or {}).get("workers") or []
    if workers:
        lines.append("")
        lines.append(f"workers ({len(workers)}):")
        for w in workers:
            job = f" job={w['job']}" if w.get("job") else ""
            rep = w.get("report") or {}
            step = rep.get("step", w.get("step"))
            # Goodput column (degradation-pinned: absent from a
            # pre-goodput worker's report, absent from the row).
            gpf = rep.get("goodput_fraction", w.get("goodput_fraction"))
            gp = (f" goodput={gpf * 100:.1f}%"
                  if isinstance(gpf, (int, float))
                  and not isinstance(gpf, bool) else "")
            lines.append(
                f"  worker {w.get('worker')}: "
                f"{'alive' if w.get('alive') else 'DOWN'}"
                f"{job} step={step}{gp} (via {w.get('via')})")
    jobs = (view.get("tiers") or {}).get("jobs") or {}
    if jobs:
        lines.append("")
        lines.append("jobs:")
        for name in sorted(jobs):
            row = jobs[name]
            lines.append(
                f"  {name}: mode={row.get('mode')} "
                f"step={row.get('global_step')} "
                f"workers={len(row.get('workers') or [])} "
                f"(via {row.get('via')})")
    stale = [t for t in targets if not t.get("ok")]
    if stale:
        lines.append("")
        lines.append("stale targets:")
        for t in stale:
            lines.append(f"  {t.get('target')}: "
                         f"{t.get('consecutive_failures')} consecutive "
                         f"failure(s) — {t.get('last_error')}")
    slo = view.get("slo") or {}
    if slo.get("objectives"):
        lines.append("")
        lines.append("fleet slo (merged series):")
        for obj in slo["objectives"]:
            wins = obj.get("windows", {})
            burns = []
            for rule in sorted(wins):
                w = wins[rule]
                mark = " BREACH" if w.get("breaching") else ""
                burns.append(f"{w.get('window_s', 0):g}s burn "
                             f"{w.get('burn', 0):g}x{mark}")
            p99o = obj.get("p99_ms")
            lines.append(
                f"  {obj.get('name')}: target={obj.get('target')} "
                f"p99={'-' if p99o is None else f'{p99o:g}ms'} "
                f"n={obj.get('total', 0)} "
                f"({'; '.join(burns) if burns else 'no windows'})")
    alerts = view.get("alerts", [])
    if alerts:
        lines.append("")
        lines.append("active alerts:")
        for a in alerts:
            who = "cluster" if a.get("worker") is None \
                else f"worker {a['worker']}"
            lines.append(
                f"  [{sev_mark.get(a.get('severity'), '????')}] "
                f"{a.get('rule')} ({who} @ {a.get('target')}): "
                f"{a.get('message')}")
    else:
        lines.append("")
        lines.append("no active alerts")
    return "\n".join(lines)


def _merge_top_history(local: dict | None, view: dict,
                       last_ticks: int | None,
                       depth: int = 600) -> dict:
    """Client half of the ``?since=<tick>`` protocol: merge
    one ``/fleet`` payload into the locally-kept history rings.

    A capable server echoes ``history_since`` and ships only the
    entries after that tick — append them. An older server ignores the
    query and ships its full rings — detected by the missing marker (or
    a tick counter that went BACKWARDS: collector restart) and degraded
    to full replacement, as before the protocol. Returns the rings and
    mutates ``view["history"]`` to the merged view for rendering."""
    from collections import deque
    incremental = (local is not None
                   and view.get("history_since") == last_ticks
                   and last_ticks is not None
                   and view.get("ticks", 0) >= last_ticks)
    if not incremental:
        local = {k: deque(rows, maxlen=depth)
                 for k, rows in (view.get("history") or {}).items()}
    else:
        for k, rows in (view.get("history") or {}).items():
            ring = local.setdefault(k, deque(maxlen=depth))
            ring.extend(rows)
    view["history"] = {k: list(v) for k, v in local.items()}
    return local


def _top_replay(args) -> int:
    """``cli top --replay <journal>``: scrub a past run on the same
    dashboard from the observer's ``fleet_tick`` journal records. The
    journaled views carry no history rings (that is what keeps
    journal_bytes_per_tick flat); the rings are rebuilt here by
    accumulating the per-tick scalars, so sparklines match what a live
    watcher saw."""
    import json as _json
    import time as _time

    from .telemetry.journal import JournalReader

    reader = JournalReader(args.replay)
    frames = reader.records(types=("fleet_tick",))
    if not frames:
        print(f"top: no fleet_tick records in {args.replay}",
              file=sys.stderr)
        return 1
    hist = {"fleet_qps": [], "p99_ms": [], "scrape_ms": []}
    views = []
    for rec in frames:
        v = dict(rec.get("view") or {})
        hist["fleet_qps"].append(v.get("fleet_qps"))
        p99 = None
        for obj in (v.get("slo") or {}).get("objectives", []):
            if "p99_ms" in obj:
                p99 = obj["p99_ms"]
                break
        hist["p99_ms"].append(p99)
        hist["scrape_ms"].append((v.get("scrape") or {}).get("last_ms"))
        v["history"] = {k: list(rows) for k, rows in hist.items()}
        views.append(v)
    span = frames[-1].get("ts", 0.0) - frames[0].get("ts", 0.0)
    if args.json:
        print(_json.dumps(views[-1], indent=2))
        return _top_exit_code(views[-1])
    if args.watch <= 0:
        print(_render_top(views[-1]))
        print(f"\n(replayed {len(views)} tick(s) spanning {span:.1f}s "
              f"from {args.replay})")
        return _top_exit_code(views[-1])
    rc = 0
    try:
        for i, v in enumerate(views):
            print("\x1b[2J\x1b[H", end="")  # clear screen, home cursor
            print(_render_top(v))
            print(f"\n(replay frame {i + 1}/{len(views)} from "
                  f"{args.replay} — Ctrl-C to stop)")
            rc = _top_exit_code(v)
            if i < len(views) - 1:
                _time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    return rc


def cmd_top(args) -> int:
    """Live fleet dashboard over a collector's ``GET /fleet`` (or a
    journal replay with ``--replay``). Exit codes match ``cli status``
    (see ``_top_exit_code``); 1 when the collector is unreachable."""
    import json as _json
    import time as _time
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    if getattr(args, "replay", None):
        return _top_replay(args)
    base = args.url
    if not base:
        print("top: need --url (or DPS_FLEET_URL)", file=sys.stderr)
        return 1
    if not base.startswith(("http://", "https://")):
        base = "http://" + base
    url = base.rstrip("/") + "/fleet"
    state = {"hist": None, "ticks": None}

    def poll() -> int:
        # After the first full fetch, ask only for the history delta
        # (?since=<tick>); degradation-pinned — _merge_top_history
        # falls back to full replacement against older servers.
        q = f"?since={state['ticks']}" if state["ticks"] is not None \
            else ""
        try:
            view = _json.loads(urlopen(url + q, timeout=5).read())
        except (HTTPError, URLError, OSError, ValueError) as e:
            print(f"top: cannot reach {url}: {e}", file=sys.stderr)
            return 1
        state["hist"] = _merge_top_history(state["hist"], view,
                                           state["ticks"])
        state["ticks"] = view.get("ticks")
        if args.json:
            print(_json.dumps(view, indent=2))
        else:
            print(_render_top(view))
        return _top_exit_code(view)

    if args.watch <= 0:
        return poll()
    rc = 0
    try:
        while True:
            print("\x1b[2J\x1b[H", end="")  # clear screen, home cursor
            rc = poll()
            print(f"\n(watching {url} every {args.watch:g}s — Ctrl-C "
                  f"to stop)")
            _time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    return rc


def cmd_experiments(args) -> int:
    """The sync/async x workers matrix (``analysis.run_matrix``) on
    ``--device``, one record per cell in ``--out-dir``; or, with
    ``--ingest-pod``, one record from a pod's teed logs."""
    with _telemetry_session(args, "experiments"):
        return _cmd_experiments(args)


def _cmd_experiments(args) -> int:
    if args.ingest_pod:
        from .analysis.pod_logs import ingest_pod

        out = os.path.join(args.out_dir, f"{args.experiment_name}.json")
        record = ingest_pod(
            args.experiment_name, name=args.pod_name, zone=args.pod_zone,
            tf_dir=args.tf_dir,
            log_path=args.pod_log_path, out_path=out)
        n_workers = record["worker_metrics_aggregated"].get("num_workers", 0)
        print(f"ingested {n_workers} worker record(s) + "
              f"{'server' if record['server_metrics'] else 'no server'} "
              f"metrics from pod -> {out}", file=sys.stderr)
        return 0

    from .analysis import run_matrix

    dataset = _load_dataset(args)
    run_matrix(dataset, args.out_dir,
               modes=tuple(args.modes.split(",")),
               worker_counts=tuple(int(x)
                                   for x in args.worker_counts.split(",")),
               epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
               backend=args.backend, plots=not args.no_plots,
               augment=not args.no_augment, seed=args.seed,
               device=args.device)
    return 0


def cmd_incident(args) -> int:
    """``cli incident list|show|report`` over auto-captured bundles —
    postmortems from disk alone (docs/OBSERVABILITY.md)."""
    import json as _json

    from .analysis.incidents import (build_timeline, list_incidents,
                                     load_incident, render_timeline)

    rows = list_incidents(args.dir)
    if args.incident_command == "list":
        if args.json:
            print(_json.dumps(rows, indent=2, default=str))
            return 0
        if not rows:
            print(f"no incident bundles under {args.dir}")
            return 0
        print(f"{'ID':<44} {'RULE':<16} {'SEV':<9} {'RECORDS':>7} "
              f"{'FILES':>5}")
        for m in rows:
            trig = m.get("trigger") or {}
            print(f"{m.get('id', '?'):<44} "
                  f"{str(trig.get('rule', '-')):<16} "
                  f"{str(trig.get('severity', '-')):<9} "
                  f"{m.get('records', 0):>7} "
                  f"{len(m.get('files') or []):>5}")
        return 0
    wanted = getattr(args, "id", None)
    if wanted is None:
        if not rows:
            print(f"incident: no bundles under {args.dir}",
                  file=sys.stderr)
            return 1
        manifest = rows[-1]
    else:
        matches = [m for m in rows
                   if str(m.get("id", "")).startswith(wanted)]
        exact = [m for m in matches if m.get("id") == wanted]
        if exact:
            matches = exact
        if len(matches) != 1:
            print(f"incident: id {wanted!r} matches "
                  f"{len(matches)} bundle(s) under {args.dir}",
                  file=sys.stderr)
            return 1
        manifest = matches[0]
    bundle = manifest["path"]
    if args.incident_command == "show":
        if args.json:
            print(_json.dumps(manifest, indent=2, default=str))
        else:
            trig = manifest.get("trigger") or {}
            print(f"incident {manifest.get('id')}")
            print(f"  created   {manifest.get('created_ts')} "
                  f"(role {manifest.get('role')})")
            print(f"  trigger   {trig.get('rule')} "
                  f"[{trig.get('severity')}] "
                  f"worker={trig.get('worker')} "
                  f"value={trig.get('value')}")
            print(f"  window    {manifest.get('window_s')}s, "
                  f"{manifest.get('records')} journal record(s)")
            print(f"  journal   {manifest.get('journal_dir')}")
            for f in manifest.get("files") or []:
                print(f"  file      {f}")
        return 0
    # report: frozen window + the journal's post-edge continuation.
    data = load_incident(bundle,
                         journal_dir=getattr(args, "journal_dir", None))
    timeline = build_timeline(data["records"])
    if args.json:
        print(_json.dumps({"manifest": data["manifest"],
                           "timeline": timeline, "stats": data["stats"]},
                          indent=2, default=str))
    else:
        print(render_timeline(timeline, data["manifest"]))
    return 0


def _query_streams(records: list) -> dict:
    """Snapshot records grouped per process: (role, pid) -> time-sorted
    list (the journal reader already sorted globally)."""
    streams: dict = {}
    for rec in records:
        streams.setdefault((rec.get("role"), rec.get("pid")),
                           []).append(rec)
    return streams


def _hist_at(stream: list, key: str, ts: float | None) -> dict | None:
    """Newest snapshot's histogram ``key`` at or before ``ts`` (None =
    newest overall) — cumulative, so this IS the prefix total."""
    best = None
    for rec in stream:
        if ts is not None and rec.get("ts", 0.0) > ts:
            break
        h = (rec.get("histograms") or {}).get(key)
        if h is not None:
            best = h
    return best


def _window_hist(stream: list, key: str, since: float | None,
                 until: float | None) -> dict | None:
    """Window-exact bucket counts for one process: cumulative newest
    minus the cumulative baseline at-or-before the window start. This
    is the union-exact property the journal's cumulative snapshots buy:
    no rate estimation, just integer bucket subtraction."""
    newest = _hist_at(stream, key, until)
    if newest is None:
        return None
    out = {"le": list(newest.get("le") or []),
           "counts": [int(c) for c in newest.get("counts") or []],
           "sum": float(newest.get("sum", 0.0)),
           "count": int(newest.get("count", 0))}
    if since is not None:
        base = _hist_at(stream, key, since)
        if base is not None and list(base.get("le") or []) == out["le"]:
            out["counts"] = [max(0, a - int(b)) for a, b in
                             zip(out["counts"], base.get("counts") or [])]
            out["sum"] = max(0.0, out["sum"]
                             - float(base.get("sum", 0.0)))
            out["count"] = max(0, out["count"]
                               - int(base.get("count", 0)))
    return out


def _retro_slo(records: list, args) -> dict:
    """Retroactive SLO burn evaluation over journal history, reusing
    the live evaluator's window semantics (telemetry/slo.py): rebuild
    the fleet-summed (total, bad) sample sequence the collector keeps
    in memory, then slide the same fast/slow windows over it."""
    from .telemetry.registry import MetricsRegistry
    from .telemetry.slo import SloEvaluator, default_objectives

    objectives = default_objectives(
        fetch_p99_ms=args.slo_fetch_p99_ms,
        availability=args.slo_availability)
    windows = SloEvaluator(objectives, registry=MetricsRegistry(),
                           fast_window_s=args.slo_fast_window,
                           slow_window_s=args.slo_slow_window).windows
    streams = list(_query_streams(records).values())
    ticks = sorted({rec.get("ts", 0.0) for rec in records})
    samples = []
    for t in ticks:
        sample: dict = {}
        for obj in objectives:
            hkey = (f"dps_rpc_server_latency_seconds"
                    f"{{method={obj.method}}}")
            ekey = (f"dps_rpc_server_errors_total"
                    f"{{method={obj.method}}}")
            total = bad = 0
            found = False
            for stream in streams:
                h = _hist_at(stream, hkey, t)
                if h is None:
                    continue
                found = True
                n = int(h.get("count", 0))
                total += n
                err = 0
                for rec in stream:
                    if rec.get("ts", 0.0) > t:
                        break
                    err = int((rec.get("counters") or {})
                              .get(ekey, err))
                if obj.threshold_s is None:
                    bad += min(n, err)
                else:
                    good, _ = SloEvaluator._good_upto(h, obj.threshold_s)
                    bad += min(n, (n - good) + err)
            if found:
                sample[obj.name] = (total, bad)
        samples.append((t, sample))
    out: dict = {"samples": len(samples), "windows": {}}
    any_critical = False
    for win in windows:
        wrow: dict = {}
        for obj in objectives:
            max_burn = 0.0
            breach_ts: list = []
            for t, _ in samples:
                d = SloEvaluator._window_delta(samples, obj.name, t,
                                               win.window_s)
                if d is None or d["total"] < win.min_events:
                    continue
                burn = SloEvaluator._burn(obj, d["bad"], d["total"])
                max_burn = max(max_burn, burn)
                if burn >= win.burn_threshold:
                    breach_ts.append(t)
            breached = bool(breach_ts)
            if breached and win.severity == "critical":
                any_critical = True
            wrow[obj.name] = {
                "max_burn": round(max_burn, 2),
                "burn_threshold": win.burn_threshold,
                "breached": breached,
                "severity": win.severity,
                "first_breach_ts": breach_ts[0] if breach_ts else None,
                "last_breach_ts": breach_ts[-1] if breach_ts else None,
                "breach_samples": len(breach_ts),
            }
        out["windows"][win.rule] = {"window_s": win.window_s,
                                    "objectives": wrow}
    out["any_critical_breach"] = any_critical
    return out


def _goodput_counters_at(stream: list, ts: float | None) -> dict:
    """Per-process goodput counter prefix totals at-or-before ``ts``:
    the newest value of every ``dps_goodput_*`` counter key (cumulative,
    so the latest observation IS the prefix total — same property
    ``_hist_at`` leans on)."""
    from .telemetry.goodput import GOODPUT_METRIC, GOODPUT_WALL_METRIC

    out: dict = {}
    for rec in stream:
        if ts is not None and rec.get("ts", 0.0) > ts:
            break
        for key, val in (rec.get("counters") or {}).items():
            if key.startswith((GOODPUT_METRIC, GOODPUT_WALL_METRIC)):
                out[key] = val
    return out


def _retro_goodput(records: list, since: float | None,
                   until: float | None, tolerance: float = 0.02) -> dict:
    """Retroactive goodput ledger over a journal window: per-process
    counter deltas (newest-at-``until`` minus baseline-at-``since``,
    clamped like every other window-exact query) summed across
    processes, then folded through the same ``goodput_report`` math the
    live ``cli goodput`` uses — one code path, two time machines."""
    from .telemetry.goodput import delta_counters, report_from_counters

    merged: dict = {}
    processes = 0
    for stream in _query_streams(records).values():
        newest = _goodput_counters_at(stream, until)
        if not newest:
            continue
        base = _goodput_counters_at(stream, since) if since is not None \
            else {}
        delta = delta_counters(newest, base)
        if not any(v > 0 for v in delta.values()):
            continue
        processes += 1
        for key, val in delta.items():
            merged[key] = merged.get(key, 0.0) + val
    report = report_from_counters(merged, tolerance=tolerance)
    report["processes"] = processes
    return report


def _incident_badput(records: list, incidents_dir: str,
                     tolerance: float = 0.02) -> list:
    """Join incident bundles against the goodput ledger: for each
    bundle, the badput seconds inside its frozen capture window
    ``[created_ts - window_s, created_ts]`` — what the incident *cost*
    in non-productive wall, per category."""
    from .analysis.incidents import list_incidents

    rows = []
    for m in list_incidents(incidents_dir):
        created = m.get("created_ts")
        window_s = m.get("window_s")
        if not isinstance(created, (int, float)) \
                or not isinstance(window_s, (int, float)):
            continue
        rep = _retro_goodput(records, created - window_s, created,
                             tolerance=tolerance)
        trig = m.get("trigger") or {}
        rows.append({"id": m.get("id"),
                     "rule": trig.get("rule"),
                     "severity": trig.get("severity"),
                     "window": {"since": created - window_s,
                                "until": created},
                     "wall_s": rep["wall_s"],
                     "badput_s": rep["badput_s"],
                     "goodput_fraction": rep["goodput_fraction"],
                     "categories": rep["categories"]})
    return rows


def _render_goodput_report(report: dict, title: str = "goodput") -> str:
    """Shared renderer for the live (``cli goodput``) and retro
    (``cli query --goodput``) ledgers — same table, two time machines."""
    gpf = report.get("goodput_fraction")
    head = "-" if gpf is None else f"{gpf * 100:.1f}%"
    lines = [f"{title}: wall={report['wall_s']:.1f}s "
             f"goodput={head} badput={report['badput_s']:.1f}s"]
    lines.append(f"  {'CATEGORY':<20} {'SECONDS':>10} {'FRACTION':>9}")
    for cat, row in report.get("categories", {}).items():
        if row["seconds"] <= 0:
            continue
        lines.append(f"  {cat:<20} {row['seconds']:>10.2f} "
                     f"{row['fraction'] * 100:>8.1f}%")
    lines.append(f"  residual={report['residual_s']:.2f}s "
                 f"({report['residual_fraction'] * 100:.1f}% of wall, "
                 f"folded into 'other') "
                 f"overshoot={report['overshoot_s']:.2f}s "
                 f"reconciled={report['reconciled']}")
    return "\n".join(lines)


def cmd_goodput(args) -> int:
    """``cli goodput``: the live goodput ledger from one process's
    ``/metrics.json`` — what fraction of wall since start was
    productive, where the rest went (docs/OBSERVABILITY.md 'Goodput
    observatory'). Exit 1 when the endpoint is unreachable."""
    import json as _json
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    from .telemetry.goodput import report_from_counters

    base = args.url or f"http://{args.host}:{args.metrics_port}"
    if not base.startswith(("http://", "https://")):
        base = "http://" + base
    url = base.rstrip("/") + "/metrics.json"
    try:
        snap = _json.loads(urlopen(url, timeout=5).read())
    except (HTTPError, URLError, OSError, ValueError) as e:
        print(f"goodput: cannot reach {url}: {e}", file=sys.stderr)
        return 1
    report = report_from_counters(snap.get("counters") or {},
                                  tolerance=args.tolerance)
    if args.json:
        print("GOODPUT_JSON: " + _json.dumps(report))
        return 0
    if report["wall_s"] <= 0:
        print(f"goodput: no goodput counters at {url} — the process "
              f"has no GoodputAccount wall yet (worker/trainer roles "
              f"publish one)", file=sys.stderr)
        return 0
    print(_render_goodput_report(report, title=f"goodput @ {base}"))
    return 0


def cmd_query(args) -> int:
    """``cli query``: retro-query a durable journal — series listing,
    union-exact windowed percentiles, retroactive SLO burn."""
    import json as _json

    from .telemetry.journal import JournalReader
    from .telemetry.stats import histogram_quantile, merge_histograms

    reader = JournalReader(args.journal)
    snaps = reader.records(types=("snapshot", "fleet_tick"))
    snaps = [r for r in snaps if r.get("type") == "snapshot"
             or "histograms" in r]
    if not snaps:
        print(f"query: no snapshot records in {args.journal}",
              file=sys.stderr)
        return 1
    newest_ts = max(r.get("ts", 0.0) for r in snaps)
    until = args.until if args.until is not None else newest_ts
    since = args.since
    if args.last is not None:
        since = until - args.last
    in_range = [r for r in snaps if r.get("ts", 0.0) <= until]
    result: dict = {"journal": args.journal,
                    "window": {"since": since, "until": until},
                    "reader_stats": reader.stats}
    if args.slo:
        result["slo"] = _retro_slo(in_range, args)
    if args.goodput:
        result["goodput"] = _retro_goodput(
            in_range, since, until, tolerance=args.goodput_tolerance)
        if args.incidents:
            result["incident_badput"] = _incident_badput(
                in_range, args.incidents,
                tolerance=args.goodput_tolerance)
    streams = _query_streams(in_range)
    selected: dict = {}
    for stream in streams.values():
        for rec in stream:
            for kind in ("counters", "gauges", "histograms"):
                for key in (rec.get(kind) or {}):
                    if args.series and args.series not in key:
                        continue
                    selected.setdefault(kind, set()).add(key)
    if args.percentiles:
        pct_rows: dict = {}
        for key in sorted(selected.get("histograms", ())):
            parts = []
            for stream in streams.values():
                h = _window_hist(stream, key, since, until)
                if h is not None and h["count"] > 0:
                    parts.append(h)
            if not parts:
                continue
            try:
                merged = merge_histograms(parts)
            except ValueError:
                continue
            row = {"count": int(merged["count"]),
                   "processes": len(parts)}
            for pct, name in ((50, "p50"), (95, "p95"), (99, "p99")):
                q = histogram_quantile(merged["le"], merged["counts"],
                                       pct)
                row[name] = None if q is None else round(q, 6)
            pct_rows[key] = row
        result["percentiles"] = pct_rows
    else:
        series: dict = {}
        for kind in ("counters", "gauges", "histograms"):
            for key in sorted(selected.get(kind, ())):
                n = sum(1 for stream in streams.values()
                        if any(key in (rec.get(kind) or {})
                               for rec in stream))
                series[key] = {"kind": kind[:-1], "processes": n}
        result["series"] = series
    rc = 2 if args.slo and result["slo"]["any_critical_breach"] else 0
    if args.json:
        print("QUERY_JSON: " + _json.dumps(result, default=str))
        return rc
    print(f"journal {args.journal}: {reader.stats['records']} record(s) "
          f"in {reader.stats['segments']} segment(s) "
          f"({reader.stats['torn_tails']} torn tail(s), "
          f"{reader.stats['corrupt_lines']} corrupt line(s) skipped)")
    if "series" in result:
        print(f"{'SERIES':<64} {'KIND':<10} {'PROCS':>5}")
        for key, row in result["series"].items():
            print(f"{key:<64} {row['kind']:<10} {row['processes']:>5}")
    if "percentiles" in result:
        print(f"{'SERIES':<64} {'COUNT':>8} {'P50':>10} {'P95':>10} "
              f"{'P99':>10}")
        for key, row in result["percentiles"].items():
            def _fmt(v):
                return "-" if v is None else f"{v * 1e3:.2f}ms"
            print(f"{key:<64} {row['count']:>8} {_fmt(row['p50']):>10} "
                  f"{_fmt(row['p95']):>10} {_fmt(row['p99']):>10}")
    if "goodput" in result:
        print(_render_goodput_report(
            result["goodput"],
            title=f"retro goodput over "
                  f"{result['goodput']['processes']} process(es)"))
        for row in result.get("incident_badput", ()):
            gpf = row["goodput_fraction"]
            gpf = "-" if gpf is None else f"{gpf * 100:.1f}%"
            print(f"  incident {row['id']}: rule={row['rule']} "
                  f"badput={row['badput_s']:.1f}s of "
                  f"{row['wall_s']:.1f}s wall (goodput {gpf})")
    if "slo" in result:
        slo = result["slo"]
        print(f"retro SLO over {slo['samples']} sample(s):")
        for rule, wrow in slo["windows"].items():
            for obj, orow in wrow["objectives"].items():
                state = "BREACHED" if orow["breached"] else "ok"
                print(f"  {rule:<14} {obj:<20} max_burn="
                      f"{orow['max_burn']:<8} (threshold "
                      f"{orow['burn_threshold']}) {state}")
        print(f"  any critical breach: "
              f"{slo['any_critical_breach']}")
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "serve": cmd_serve, "worker": cmd_worker,
            "experiments": cmd_experiments, "status": cmd_status,
            "observe": cmd_observe, "top": cmd_top,
            "incident": cmd_incident, "query": cmd_query,
            "goodput": cmd_goodput, "perf": cmd_perf,
            "replica": cmd_replica, "loadgen": cmd_loadgen,
            "infer": cmd_infer, "supervise": cmd_supervise,
            "reshard": cmd_reshard}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
