"""Experiment matrix runner: the reference's §6 tables, in-process.

The JAX package's ``analysis/runner.py`` on the port's pieces. The
reference produced its sync/async x {4,8,16} worker results by deploying
Fargate clusters per cell (EXPERIMENT_GUIDE.md:95-111) and scraping
CloudWatch. Here one process runs the full matrix: each cell is a
parameter store (``ps.make_store``: sync or async aggregation) + N
worker threads (``ps.run_workers``) sharing the card, and the output is
one experiment JSON per cell in the recorded
``experiment_results/*.json`` schema (:data:`RECORD_KEYS`), plus the
comparison/scaling figures.
"""

from __future__ import annotations

import json
import os

import torch

from ..data.cifar import Dataset
from ..models import get_model
from ..ps import make_store
from ..ps.store import StoreConfig
from ..ps.worker import WorkerConfig, run_workers
from ..utils.device import resolve_device
from ..utils.pytree import params_to_jax
from .parse_logs import aggregate_worker_metrics

#: The keys of one cell's record, in the JAX runner's order.
RECORD_KEYS = ("experiment_name", "dataset", "device", "server_metrics",
               "worker_metrics_aggregated", "raw_worker_metrics")


def _device_name(device) -> str:
    """The record's ``device``: the torch device, and the card's name
    when it is a CUDA device (the JAX runner's ``str(jax.devices()[0])``
    names the accelerator the same way)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"


def run_cell(dataset: Dataset, mode: str, n_workers: int, *,
             epochs: int = 3, batch_size: int = 128, lr: float = 0.1,
             staleness_bound: int = 5, num_classes: int = 100,
             model=None, seed: int = 0, backend: str = "python",
             augment: bool = True, device: str = "cuda") -> dict:
    """One experiment cell -> experiment record (reference JSON schema).
    ``model`` (a registry model on ``device``) replaces the default
    ResNet-18 drawn from ``seed``."""
    model = model or get_model("resnet18", num_classes=num_classes,
                               dtype=torch.bfloat16, device=device,
                               seed=seed)
    flat, _ = params_to_jax(model)
    cfg = StoreConfig(mode=mode, total_workers=n_workers, learning_rate=lr,
                      staleness_bound=staleness_bound)
    # 'device' keeps the store's tensors on the card: no host<->device
    # traffic per step.
    store = make_store(backend, flat, cfg, device=device)

    results = run_workers(
        store, model, dataset, n_workers,
        WorkerConfig(batch_size=batch_size, num_epochs=epochs,
                     augment=augment, seed=seed, device=device))
    wc = WorkerConfig(batch_size=batch_size, num_epochs=epochs,
                      device=device)
    worker_dicts = [r.metrics(n_workers, lr, wc) for r in results]
    return {
        "experiment_name": f"{mode}_{n_workers}workers",
        # Provenance: the reference's records came from real CIFAR-100 on
        # Fargate; ours must say what data (and device) produced them.
        "dataset": {
            "synthetic": bool(dataset.synthetic),
            "num_classes": int(dataset.num_classes),
            "n_train": int(len(dataset.x_train)),
            "n_test": int(len(dataset.x_test)),
        },
        "device": _device_name(device),
        "server_metrics": store.metrics(),
        "worker_metrics_aggregated": aggregate_worker_metrics(worker_dicts),
        "raw_worker_metrics": worker_dicts,
    }


def run_matrix(dataset: Dataset, out_dir: str, *,
               modes=("sync", "async"), worker_counts=(4, 8),
               epochs: int = 3, batch_size: int = 128, lr: float = 0.1,
               num_classes: int = 100, backend: str = "python",
               plots: bool = True, **cell_kw) -> list[dict]:
    os.makedirs(out_dir, exist_ok=True)
    records = []
    for mode in modes:
        for n in worker_counts:
            print(f"=== cell: {mode} x {n} workers ===", flush=True)
            rec = run_cell(dataset, mode, n, epochs=epochs,
                           batch_size=batch_size, lr=lr,
                           num_classes=num_classes, backend=backend,
                           **cell_kw)
            records.append(rec)
            path = os.path.join(out_dir, rec["experiment_name"] + ".json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            agg = rec["worker_metrics_aggregated"]
            print(f"    total {agg['total_training_time_seconds']:.1f}s, "
                  f"final acc {agg['average_final_accuracy']:.4f}")
    if plots:
        from .visualize import ExperimentVisualizer
        viz = ExperimentVisualizer(out_dir)
        viz.plot_sync_vs_async(os.path.join(out_dir, "sync_vs_async.png"))
        viz.plot_scaling_analysis(os.path.join(out_dir, "scaling.png"))
        print(viz.summary_table())
    return records
