"""Distributed trainer drivers of the port (counterpart of the JAX
package's ``train/distributed.py``).

:class:`AsyncTrainer` wires the host-NumPy ParameterStore to N worker
threads on the card (ps/worker.py), reproducing the reference's
async_Nworkers experiment configs (EXPERIMENT_GUIDE.md:95-111), and emits
the METRICS_JSON lines the reference's ETL expects. ``SyncTrainer`` (SPMD
sync data parallelism with its int8 ring, kernels K2-K4) comes with the
sync-DP slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..data.cifar import Dataset
from ..ps import make_store
from ..ps.store import StoreConfig
from ..ps.worker import WorkerConfig, run_workers
from ..utils.device import resolve_device
from ..utils.metrics import emit_metrics_json
from ..utils.pytree import params_to_jax


@dataclass
class DistributedConfig:
    mode: str = "async"            # SERVER_MODE (server.py:407-417)
    num_workers: int = 4           # TOTAL_WORKERS_EXPECTED
    learning_rate: float = 0.1     # server lr (server.py:413)
    num_epochs: int = 3            # worker.py:466 default
    batch_size: int = 128          # per worker (worker.py:462)
    sync_steps: int = 1            # K (worker.py:468)
    k_step_mode: str = "faithful"
    staleness_bound: int = 5       # server.py:418
    delta_fetch: bool = True
    store_backend: str = "python"
    augment: bool = True
    num_classes: int = 100
    dtype: str = "bfloat16"
    model: str = "resnet18"        # models/registry.py name
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.mode == "sync":
            raise NotImplementedError(
                "mode='sync' (SyncTrainer) comes with the sync-DP slice")
        if self.mode != "async":
            raise ValueError(f"mode must be async, got {self.mode!r}")
        resolve_device(self.device)


class AsyncTrainer:
    """Async bounded-staleness training: host store + N worker threads."""

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
                        staleness_bound=cfg.staleness_bound))

    def _worker_config(self) -> WorkerConfig:
        cfg = self.config
        return WorkerConfig(batch_size=cfg.batch_size,
                            num_epochs=cfg.num_epochs,
                            sync_steps=cfg.sync_steps,
                            k_step_mode=cfg.k_step_mode,
                            delta_fetch=cfg.delta_fetch,
                            augment=cfg.augment, seed=cfg.seed,
                            device=cfg.device)

    def train(self, emit_metrics: bool = False) -> dict:
        cfg = self.config
        wc = self._worker_config()
        self.results = run_workers(self.store, self.model, self.dataset,
                                   cfg.num_workers, wc)
        server_metrics = self.store.metrics()
        if emit_metrics:
            emit_metrics_json(server_metrics)
            for r in self.results:
                emit_metrics_json(r.metrics(cfg.num_workers,
                                            cfg.learning_rate, wc))
        return server_metrics
