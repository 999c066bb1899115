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
synthetic images. ``--mode sync --multihost`` runs one process per card
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
                   help="async parameter-store backend: host numpy, or "
                        "device-resident (zero host-link bytes a step); "
                        "native comes with ROADMAP §1 item 9")
    _add_worker_modes(t)
    t.add_argument("--compression", choices=["none", "bf16", "fp16", "int8"],
                   default="bf16",
                   help="sync all-reduce precision (int8 = quantized "
                        "reduce-scatter ring, ~half bf16's bytes)")
    t.add_argument("--model", choices=["resnet18", "resnet50", "vit_b16",
                                       "vit_tiny"],
                   default="resnet18",
                   help="baseline, sync and async train any; sp a ViT")
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
                   default="python")
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
    _add_profile_dir(s, "the server's apply/aggregation hot path")
    _add_telemetry(s)
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
    w.add_argument("--shards", default=None)
    w.add_argument("--job", default=None)
    w.add_argument("--faults", default=None)

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
    "faults": "ROADMAP §1 item 9 (comms/faults.py)",
    "jobs": "ROADMAP §1 item 9 (tenancy)",
    "job": "ROADMAP §1 item 9 (tenancy)",
    "shards": "ROADMAP §1 item 9 (the sharded tier)",
    "store_backend": "ROADMAP §1 item 9 (the C++ arena)",
}
#: Verbs of the JAX CLI whose features come with later slices.
LATER_VERBS = {
    "perf check": "ROADMAP §1 item 11 (port tooling: tools/benchwatch)",
}
#: Values of a listed flag that this slice serves.
_FLAG_SERVED = {"store_backend": ("python", "device")}


def _refuse_later_flags(args) -> None:
    """Raise for the first flag of a later slice given a value this slice
    does not serve (anything but None, False or a listed value; a port
    of 0 is a value)."""
    for name, item in LATER_FLAGS.items():
        value = getattr(args, name, None)
        if value is None or value is False \
                or value in _FLAG_SERVED.get(name, ()):
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
    if args.mode == "sp":
        from .train.model_parallel import ModelParallelConfig, SPTrainer
        mp_cfg = ModelParallelConfig(
            model=args.model, num_workers=args.workers,
            learning_rate=args.lr, num_epochs=args.epochs,
            batch_size=args.batch_size, augment=not args.no_augment,
            num_classes=dataset.num_classes, dtype=args.dtype,
            seed=args.seed, device=args.device)
        trainer = SPTrainer(dataset, mp_cfg)
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
    telemetry and trigger-driven profiling (``cli.py:1494-1548``)."""
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

    if (args.sync_quorum is not None or args.round_deadline is not None) \
            and args.mode != "sync":
        raise SystemExit("--sync-quorum/--round-deadline apply to "
                         "--mode sync (async has no rounds)")
    if args.restore and not args.checkpoint_dir:
        raise SystemExit("--restore needs --checkpoint-dir")
    # The model is built on the CPU only to draw its initial weights
    # (get_model draws them from a CPU generator on every device, so a
    # worker's AsyncTrainer on the card starts from the same weights for
    # the same seed).
    model = get_model(args.model, num_classes=args.num_classes,
                      image_size=args.image_size, device="cpu",
                      seed=args.seed)
    flat, _ = params_to_jax(model)
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
                    round_deadline=args.round_deadline), **store_kw)
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
    svc = ParameterService(store, monitor=monitor)
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
            journal_fn=svc.journal_snapshot)
        ckpt.start()
        # SIGTERM drains the store's end state through the same shutdown
        # path that dumps the flight recorder: a terminated server
        # resumes exactly where it was killed.
        install_shutdown_hooks(role="server")
        add_shutdown_flush(ckpt.flush_now)
    server, port = serve(store, port=args.port, service=svc)
    print(f"parameter server up on :{port} (mode={store.config.mode}, "
          f"workers={args.workers}, backend={args.store_backend}"
          + (f", restored_step={restored}" if restored is not None else "")
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
    for the CPU) against the server at ``--server``."""
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
    store = RemoteStore(args.server)
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "serve": cmd_serve, "worker": cmd_worker,
            "perf": cmd_perf}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
