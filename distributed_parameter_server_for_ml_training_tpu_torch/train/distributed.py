"""Distributed trainer drivers of the port (counterpart of the JAX
package's ``train/distributed.py``).

:class:`SyncTrainer` is sync data parallelism: N logical workers are the N
slots of a mesh on one card, or, in a multi-process job (one process per
card, ``parallel/multihost.py``), of a mesh over every process's card;
one step per global batch (``parallel/sync_dp.py``), no server.
:class:`AsyncTrainer` wires a parameter store (``store_backend``: the
host-NumPy ParameterStore, the C++ arena's NativeParameterStore, or the
device-resident DeviceParameterStore)
to N worker threads on the card (ps/worker.py), reproducing the
reference's async_Nworkers experiment configs
(EXPERIMENT_GUIDE.md:95-111). Both emit the METRICS_JSON lines the
reference's ETL expects. The sync trainer checkpoints its train state
each epoch (``CheckpointManager``); the async trainer snapshots its store
periodically (``PeriodicStoreCheckpointer``).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..data.cifar import Dataset, make_batches
from ..parallel.mesh import DATA_AXIS, make_mesh
from ..parallel.multihost import (RankGroup, make_global_mesh,
                                  ranks_identical, replicate_to_mesh,
                                  shard_batch_global, world_group)
from ..parallel.sync_dp import COMPRESSIONS, make_sync_dp_step, shard_batch
from ..ps import make_store
from ..ps.store import StoreConfig
from ..ps.worker import WorkerConfig, run_workers
from ..utils.device import resolve_device
from ..utils.metrics import emit_metrics_json
from ..utils.pytree import params_to_jax
from .optimizers import server_sgd
from .steps import make_eval_step
from .train_state import create_train_state


@dataclass
class DistributedConfig:
    mode: str = "sync"             # SERVER_MODE (server.py:407-417)
    num_workers: int = 4           # TOTAL_WORKERS_EXPECTED
    learning_rate: float = 0.1     # server lr (server.py:413)
    num_epochs: int = 3            # worker.py:466 default
    batch_size: int = 128          # per worker (worker.py:462)
    sync_steps: int = 1            # K (worker.py:468)
    k_step_mode: str = "faithful"
    staleness_bound: int = 5       # server.py:418
    compression: str = "bf16"      # sync all-reduce dtype
    strict_rounds: bool = False    # corrected sync rounds (vs quirk 3)
    elastic: bool = False          # elastic membership (StoreConfig.elastic)
    worker_timeout: float | None = None  # liveness expiry (seconds)
    # The PS worker's options (ps/worker.py WorkerConfig fields of the same
    # names); the sync trainer has no RPCs to overlap.
    overlap: bool = False
    delta_fetch: bool = True
    local_lr: float | None = None
    heartbeat_interval: float = 0.0
    reconnect_timeout: float = 0.0
    # Async store backend: 'python' (host NumPy), 'native' (the C++ arena
    # on the host, built from native/ps_core.cpp at first use) or
    # 'device' (params on the card: zero host-link bytes a worker step).
    store_backend: str = "python"
    augment: bool = True
    num_classes: int = 100
    dtype: str = "bfloat16"
    model: str = "resnet18"        # models/registry.py name
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be sync or async, got "
                             f"{self.mode!r}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"compression must be one of {COMPRESSIONS}, "
                             f"got {self.compression!r}")
        resolve_device(self.device)


class SyncTrainer:
    """Sync data-parallel training over the N worker slots of one card (no
    server process).

    Multi-process: when the process has joined a job
    (``parallel.initialize_multihost``), or ``group`` names the ranks, the
    mesh spans every rank's card: ``num_workers`` is the global slot
    count, split evenly over the ranks, each rank takes its contiguous
    slice of the global batch, and the state starts from rank 0's values.
    Only rank 0 evaluates (the others record NaN), prints and saves
    checkpoints; every rank restores on ``resume``. The per-slot train
    losses stay on their rank: the per-worker rows carry the shared
    fields only, as the JAX package's multi-host rows do."""

    def __init__(self, dataset: Dataset,
                 config: DistributedConfig | None = None,
                 group: RankGroup | None = None):
        from ..models import get_model

        self.config = cfg = config or DistributedConfig(mode="sync")
        if group is None and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            group = world_group()
        self.dataset = dataset
        self.multihost = group is not None
        if self.multihost:
            if cfg.num_workers % group.size:
                raise ValueError(
                    f"--workers {cfg.num_workers} (the global slot count) "
                    f"must divide evenly over {group.size} processes")
            self.mesh = make_global_mesh(cfg.num_workers, cfg.device,
                                         group=group)
            staged = " (collectives staged through the host)" \
                if group.staged(self.mesh.device) else ""
            print(f"multihost: rank {group.rank} of {group.size}, slots "
                  f"{self.mesh.slot_offset}-"
                  f"{self.mesh.slot_offset + self.mesh.local_slots - 1} of "
                  f"{cfg.num_workers} on {self.mesh.device}, "
                  f"{group.backend}{staged}", file=sys.stderr, flush=True)
        else:
            self.mesh = make_mesh(cfg.num_workers, cfg.device)
        self.is_chief = self.mesh.rank == 0
        self.model = get_model(cfg.model, num_classes=cfg.num_classes,
                               dtype=cfg.dtype,
                               image_size=dataset.x_train.shape[1],
                               device=self.mesh.device, seed=cfg.seed,
                               axis_name=DATA_AXIS)
        self.state = replicate_to_mesh(self.mesh, create_train_state(
            self.model, server_sgd(cfg.learning_rate)))
        self._step = make_sync_dp_step(self.mesh, self.model,
                                       compression=cfg.compression,
                                       augment=cfg.augment)
        self._eval_step = make_eval_step(self.model)
        self.epoch_times: list[float] = []
        # Per epoch: seconds to the end of its last step (eval excluded;
        # the device has finished once the epoch's loss is read), and the
        # mean train loss over the slots.
        self.train_seconds: list[float] = []
        self.train_loss_per_epoch: list[float] = []
        self.test_accuracies: list[float] = []
        self.global_steps = 0
        # int8 only: whether every step's ring left bit-identical rows.
        # The bytes each slot handed across hops per step (int8), or over
        # several processes the rank's all-reduce bytes (bf16/fp16/none).
        self.ring_replicas_identical: bool | None = None
        self.wire_bytes_per_slot_step: int | None = None
        # Multi-process only: whether every rank ended with rank 0's
        # params, bit for bit.
        self.ranks_params_identical: bool | None = None

    def train(self, emit_metrics: bool = False,
              checkpoint_dir: str | None = None,
              resume: bool = False) -> dict:
        cfg = self.config
        global_batch = cfg.batch_size * cfg.num_workers
        seed = cfg.seed + 1

        # A checkpoint a epoch; a resume copies the newest into the state
        # and skips the epochs it covers (the step seeds the augment draws
        # and the ring's, so the resumed run is the uninterrupted one).
        mgr = None
        start_epoch = 0
        if checkpoint_dir:
            from ..checkpoint import CheckpointManager
            mgr = CheckpointManager(checkpoint_dir)
            if resume and mgr.latest_step() is not None:
                self.state = mgr.restore(self.state)
                steps_per_epoch = max(
                    1, len(self.dataset.x_train) // global_batch)
                self.global_steps = int(self.state.step)
                start_epoch = self.global_steps // steps_per_epoch
                if self.is_chief:
                    print(f"resumed from step {self.global_steps} "
                          f"(epoch {start_epoch + 1})")

        from ..telemetry import (GoodputAccount, get_registry,
                                 now as _tnow, trace_span)
        reg = get_registry()
        tm_step_s = reg.histogram("dps_trainer_step_seconds", mode="sync")
        tm_steps = reg.counter("dps_trainer_steps_total", mode="sync")
        tm_images = reg.counter("dps_trainer_images_total", mode="sync")
        tm_epoch = reg.gauge("dps_trainer_epoch", mode="sync")
        tm_acc = reg.gauge("dps_trainer_test_accuracy", mode="sync")
        tm_gstep = reg.gauge("dps_store_global_step", backend="spmd")
        # Goodput: the step is issued eagerly, so "compute" is host time to
        # issue it; the device finishes by the epoch's loss read, which is
        # charged to "compute" too.
        gp = GoodputAccount(reg)
        gp.start_wall()

        t_start = time.time()
        per_worker_epochs = []   # per epoch: {"loss": [N], "accuracy": [N]}
        replicas = []
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            losses, wl, wa = [], [], []
            for xb, yb in make_batches(self.dataset.x_train,
                                       self.dataset.y_train, global_batch,
                                       seed=cfg.seed * 997 + epoch):
                bi, bl = (shard_batch_global if self.multihost
                          else shard_batch)(self.mesh, (xb, yb))
                t_step = _tnow()
                with trace_span("trainer.step", root=True, mode="sync",
                                step=self.global_steps, epoch=epoch), \
                        gp.span("compute"):
                    self.state, m = self._step(self.state, bi, bl, seed)
                losses.append(m["loss"])
                # Dispatch-to-return, as the reference's histogram.
                tm_step_s.observe(_tnow() - t_step)
                tm_steps.inc()
                tm_images.inc(len(xb))
                if not self.multihost:
                    wl.append(m["worker_loss"])
                    wa.append(m["worker_accuracy"])
                if "ring_replicas_identical" in m:
                    replicas.append(m["ring_replicas_identical"])
                if "wire_bytes_per_slot" in m:
                    self.wire_bytes_per_slot_step = m["wire_bytes_per_slot"]
                self.global_steps += 1
                tm_gstep.set(self.global_steps)
                gp.tick_wall()
            with gp.span("compute"):
                mean_loss = float(torch.stack(losses).mean()) if losses \
                    else float("nan")
                self.train_seconds.append(time.time() - t0)
                self.train_loss_per_epoch.append(mean_loss)
                if wl:
                    per_worker_epochs.append({
                        "loss": torch.stack(wl).mean(0).cpu().numpy(),
                        "accuracy": torch.stack(wa).mean(0).cpu().numpy(),
                    })
                # The state is replicated: the other ranks' evals would
                # repeat rank 0's.
                acc = self.evaluate() if self.is_chief else float("nan")
            self.epoch_times.append(time.time() - t0)
            self.test_accuracies.append(acc)
            tm_epoch.set(epoch + 1)
            if self.is_chief:
                tm_acc.set(acc)
                print(f"[sync x{cfg.num_workers}] epoch {epoch + 1}: "
                      f"loss {mean_loss:.4f} test {acc:.2%} "
                      f"({self.epoch_times[-1]:.1f}s)")
            if mgr is not None and self.is_chief:
                with gp.span("checkpoint"):
                    mgr.save(self.state)
            gp.tick_wall()
        total = time.time() - t_start
        if mgr is not None:
            mgr.close()
        if replicas:
            self.ring_replicas_identical = bool(torch.stack(replicas).all())
        if self.multihost:
            self.ranks_params_identical = ranks_identical(
                list(self.state.params.values()), self.mesh.group)

        server_metrics = {
            "mode": "sync",
            "total_workers": cfg.num_workers,
            "total_training_time_seconds": round(total, 2),
            "global_steps_completed": self.global_steps,
            "total_parameter_updates": self.global_steps,
            "gradients_processed": self.global_steps * cfg.num_workers,
            "average_update_time_seconds": round(
                total / max(self.global_steps, 1), 6),
            "updates_per_second": round(self.global_steps / total, 3),
            "learning_rate": cfg.learning_rate,
        }
        if self.multihost:
            # Rank 0 reports for every rank: the replica checks and the
            # wire bytes a slot a step.
            server_metrics.update({
                "processes": self.mesh.num_ranks,
                "ranks_params_identical": self.ranks_params_identical,
                "ring_replicas_identical": self.ring_replicas_identical,
                "wire_bytes_per_slot_step": self.wire_bytes_per_slot_step})
        if emit_metrics and self.is_chief:
            emit_metrics_json(server_metrics)
            for wid in range(cfg.num_workers):
                # Train loss/accuracy are measured per slot (each worker's
                # own shard); time and test fields belong to the one
                # program and replicated model, identical for every worker
                # by construction, and marked so.
                row = {
                    "worker_id": wid,
                    "total_workers": cfg.num_workers,
                    "total_training_time_seconds": round(total, 2),
                    "average_epoch_time_seconds": round(
                        float(np.mean(self.epoch_times)), 2),
                    "epoch_times_seconds": [round(t, 2)
                                            for t in self.epoch_times],
                    "final_test_accuracy": self.test_accuracies[-1],
                    "all_test_accuracies": self.test_accuracies,
                    "shared_model_metrics": True,
                    "local_steps_completed": self.global_steps,
                    "batch_size": cfg.batch_size,
                    "learning_rate": cfg.learning_rate,
                    "num_epochs": cfg.num_epochs,
                }
                if per_worker_epochs:
                    row.update({
                        "train_loss_per_epoch": [
                            round(float(pe["loss"][wid]), 4)
                            for pe in per_worker_epochs],
                        "train_accuracy_per_epoch": [
                            round(float(pe["accuracy"][wid]), 4)
                            for pe in per_worker_epochs],
                        "measured_per_worker_fields": [
                            "train_loss_per_epoch",
                            "train_accuracy_per_epoch"],
                    })
                emit_metrics_json(row)
        return server_metrics

    def evaluate(self) -> float:
        """Top-1 over the test set with the running BatchNorm statistics,
        in batches of 1000 (worker.py:313-331)."""
        correct, total = None, 0
        for xb, yb in make_batches(self.dataset.x_test, self.dataset.y_test,
                                   1000, shuffle=False,
                                   drop_remainder=False):
            c, t = self._eval_step(self.state.params,
                                   self.state.batch_stats, xb, yb)
            correct = c if correct is None else correct + c
            total += t
        return (int(correct) if correct is not None else 0) / max(total, 1)


class AsyncTrainer:
    """Async bounded-staleness training: a parameter store (by
    ``store_backend``) + N worker threads."""

    def __init__(self, dataset: Dataset,
                 config: DistributedConfig | None = None):
        from ..models import get_model

        self.config = cfg = config or DistributedConfig()
        self.dataset = dataset
        self.model = get_model(cfg.model, num_classes=cfg.num_classes,
                               dtype=cfg.dtype,
                               image_size=dataset.x_train.shape[1],
                               device=cfg.device, seed=cfg.seed)
        params, _ = params_to_jax(self.model)
        self.store = make_store(
            cfg.store_backend, params,
            StoreConfig(mode=cfg.mode, total_workers=cfg.num_workers,
                        learning_rate=cfg.learning_rate,
                        staleness_bound=cfg.staleness_bound,
                        strict_rounds=cfg.strict_rounds,
                        elastic=cfg.elastic,
                        worker_timeout=cfg.worker_timeout),
            device=cfg.device)

    def _worker_config(self) -> WorkerConfig:
        cfg = self.config
        # With expiry on, workers prove liveness even while a step runs
        # long (the first one builds cuDNN's plans): a heartbeat at a
        # third of the timeout unless one is asked for.
        heartbeat = cfg.heartbeat_interval or (
            cfg.worker_timeout / 3 if cfg.worker_timeout else 0.0)
        return WorkerConfig(batch_size=cfg.batch_size,
                            num_epochs=cfg.num_epochs,
                            sync_steps=cfg.sync_steps,
                            k_step_mode=cfg.k_step_mode,
                            overlap=cfg.overlap,
                            delta_fetch=cfg.delta_fetch,
                            local_lr=cfg.local_lr,
                            heartbeat_interval=heartbeat,
                            reconnect_timeout=cfg.reconnect_timeout,
                            augment=cfg.augment, seed=cfg.seed,
                            device=cfg.device)

    def train(self, emit_metrics: bool = False,
              checkpoint_dir: str | None = None,
              resume: bool = False,
              checkpoint_interval: float = 30.0) -> dict:
        """Run the workers to the end. With ``checkpoint_dir``, the store
        is snapshotted every ``checkpoint_interval`` seconds and once at
        the end; ``resume`` first restores the newest snapshot there."""
        cfg = self.config
        wc = self._worker_config()
        ckpt = None
        if checkpoint_dir:
            from ..checkpoint import (PeriodicStoreCheckpointer,
                                      restore_store)
            if resume and os.path.isdir(checkpoint_dir) and any(
                    f.endswith(".npz") for f in os.listdir(checkpoint_dir)):
                step = restore_store(self.store, checkpoint_dir)
                print(f"resumed store from global step {step}")
            ckpt = PeriodicStoreCheckpointer(self.store, checkpoint_dir,
                                             interval=checkpoint_interval)
            ckpt.start()
        try:
            self.results = run_workers(self.store, self.model,
                                       self.dataset, cfg.num_workers, wc)
        finally:
            if ckpt is not None:
                ckpt.stop(final_snapshot=True)
        server_metrics = self.store.metrics()
        if emit_metrics:
            emit_metrics_json(server_metrics)
            for r in self.results:
                emit_metrics_json(r.metrics(cfg.num_workers,
                                            cfg.learning_rate, wc))
        return server_metrics
