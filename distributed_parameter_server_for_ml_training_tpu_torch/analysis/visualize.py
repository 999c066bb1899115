"""Experiment visualization (reference: scripts/visualize_results.py).

The JAX package's ``analysis/visualize.py``, carried over whole;
matplotlib is imported only when a figure is drawn, so ``--no-plots``
runs without it.

Reads experiment JSONs (ours or the reference's recorded
``experiment_results/*.json`` — same schema) and produces the same figure
families: sync-vs-async comparison panels per worker count
(visualize_results.py:77-170), scaling analysis with log2 axes and an
ideal-speedup line (172-276), and a console summary table (278-296).
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np


class ExperimentVisualizer:
    def __init__(self, results_dir: str):
        self.results_dir = results_dir
        self.experiments: dict[str, dict] = {}
        for path in sorted(glob(os.path.join(results_dir, "*.json"))):
            with open(path) as f:
                rec = json.load(f)
            if "worker_metrics_aggregated" not in rec:
                continue  # manifests / convergence curves, not matrix cells
            name = rec.get("experiment_name") or os.path.splitext(
                os.path.basename(path))[0]
            self.experiments[name] = rec

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _mode_workers(rec: dict) -> tuple[str, int]:
        server = rec.get("server_metrics", {})
        mode = server.get("mode", "unknown")
        workers = server.get("total_workers") or rec.get(
            "worker_metrics_aggregated", {}).get("num_workers", 0)
        return mode, int(workers)

    @staticmethod
    def _total_time(rec: dict) -> float:
        agg = rec.get("worker_metrics_aggregated", {})
        return float(agg.get("total_training_time_seconds")
                     or rec.get("server_metrics", {}).get(
                         "total_training_time_seconds", 0.0))

    @staticmethod
    def _final_acc(rec: dict) -> float:
        return float(rec.get("worker_metrics_aggregated", {}).get(
            "average_final_accuracy", 0.0))

    # -- figures -------------------------------------------------------------

    def plot_sync_vs_async(self, out_path: str) -> None:
        """4-panel sync-vs-async comparison (visualize_results.py:77-170)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        by_workers: dict[int, dict[str, dict]] = {}
        for rec in self.experiments.values():
            mode, workers = self._mode_workers(rec)
            by_workers.setdefault(workers, {})[mode] = rec

        fig, axes = plt.subplots(2, 2, figsize=(13, 9))
        counts = sorted(by_workers)
        width = 0.35
        xs = np.arange(len(counts))

        for i, (metric, title) in enumerate([
                (self._total_time, "Total training time (s)"),
                (self._final_acc, "Final accuracy")]):
            ax = axes[0, i]
            for j, mode in enumerate(["sync", "async"]):
                vals = [metric(by_workers[c][mode])
                        if mode in by_workers[c] else 0.0 for c in counts]
                ax.bar(xs + (j - 0.5) * width, vals, width, label=mode)
            ax.set_xticks(xs)
            ax.set_xticklabels([f"{c} workers" for c in counts])
            ax.set_title(title)
            ax.legend()

        ax = axes[1, 0]
        for name, rec in self.experiments.items():
            per_epoch = rec.get("worker_metrics_aggregated", {}).get(
                "per_epoch", [])
            if per_epoch:
                ax.plot([p["epoch"] for p in per_epoch],
                        [p["avg_accuracy"] for p in per_epoch],
                        "o-", label=name)
        ax.set_title("Accuracy per epoch")
        ax.set_xlabel("epoch")
        ax.legend(fontsize=7)

        ax = axes[1, 1]
        for name, rec in self.experiments.items():
            per_epoch = rec.get("worker_metrics_aggregated", {}).get(
                "per_epoch", [])
            if per_epoch:
                ax.plot([p["epoch"] for p in per_epoch],
                        [p["avg_time"] for p in per_epoch],
                        "s-", label=name)
        ax.set_title("Epoch time (s)")
        ax.set_xlabel("epoch")
        ax.legend(fontsize=7)

        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)

    def plot_scaling_analysis(self, out_path: str) -> None:
        """Scaling panels with log2 axes + ideal-speedup line
        (visualize_results.py:172-276)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        series: dict[str, list[tuple[int, float]]] = {}
        for rec in self.experiments.values():
            mode, workers = self._mode_workers(rec)
            if workers:
                series.setdefault(mode, []).append(
                    (workers, self._total_time(rec)))
        for mode in series:
            series[mode].sort()

        fig, axes = plt.subplots(2, 2, figsize=(13, 9))

        ax = axes[0, 0]
        for mode, pts in series.items():
            ax.plot([w for w, _ in pts], [t for _, t in pts], "o-",
                    label=mode)
        ax.set_xscale("log", base=2)
        ax.set_title("Total time vs workers")
        ax.set_xlabel("workers")
        ax.legend()

        ax = axes[0, 1]
        for mode, pts in series.items():
            if not pts:
                continue
            w0, t0 = pts[0]
            ws = [w for w, _ in pts]
            speedup = [t0 / t if t else 0.0 for _, t in pts]
            ax.plot(ws, speedup, "o-", label=f"{mode} measured")
            ax.plot(ws, [w / w0 for w in ws], "--", label=f"{mode} ideal")
        ax.set_xscale("log", base=2)
        ax.set_yscale("log", base=2)
        ax.set_title("Speedup vs ideal")
        ax.legend()

        ax = axes[1, 0]
        for mode, pts in series.items():
            if not pts:
                continue
            w0, t0 = pts[0]
            eff = [100.0 * (t0 / t) / (w / w0) if t else 0.0
                   for w, t in pts]
            ax.plot([w for w, _ in pts], eff, "o-", label=mode)
        ax.set_xscale("log", base=2)
        ax.set_title("Scaling efficiency (%)")
        ax.axhline(100, ls="--", c="gray")
        ax.legend()

        ax = axes[1, 1]
        for rec in self.experiments.values():
            mode, workers = self._mode_workers(rec)
            ax.scatter(self._total_time(rec), self._final_acc(rec),
                       label=f"{mode}-{workers}")
        ax.set_xlabel("total time (s)")
        ax.set_ylabel("final accuracy")
        ax.set_title("Time/accuracy tradeoff")
        ax.legend(fontsize=7)

        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)

    # -- live-telemetry time-series (snapshot streams) -----------------------

    @staticmethod
    def plot_telemetry(ts_record: dict, out_path: str) -> None:
        """4-panel view of a run's snapshot stream
        (``analysis.build_telemetry_timeseries`` output): per-worker
        training throughput, wire bytes/s, the async staleness histogram,
        and store global-step progress. The live complement to the
        exit-line figures above — regenerable from any run's logs with
        ``--telemetry`` enabled (docs/OBSERVABILITY.md)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .parse_logs import (_parse_metric_key, staleness_series,
                                 worker_throughput_series)

        fig, axes = plt.subplots(2, 2, figsize=(13, 9))

        ax = axes[0, 0]
        for label, s in sorted(worker_throughput_series(ts_record).items()):
            ax.plot(s["t"], s["steps_per_second"], "o-", ms=3, label=label)
        ax.set_title("Training throughput (steps/s)")
        ax.set_xlabel("run time (s)")
        ax.legend(fontsize=7)

        ax = axes[0, 1]
        for proc_key, proc in sorted(ts_record.get("procs", {}).items()):
            for key, rate in sorted(proc.get("rates", {}).items()):
                name, labels = _parse_metric_key(key)
                if name not in ("dps_rpc_client_bytes_total",
                                "dps_worker_push_bytes_total"):
                    continue
                tag = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                label = f"{name.split('_bytes')[0]}[{tag}]"
                if len(ts_record["procs"]) > 1:
                    label += f" ({proc_key})"  # disambiguate across procs
                ax.plot(proc["t"][1:], [r / 1e6 for r in rate], "-",
                        label=label)
        ax.set_title("Bytes on wire (MB/s)")
        ax.set_xlabel("run time (s)")
        ax.legend(fontsize=6)

        ax = axes[1, 0]
        st = staleness_series(ts_record)
        if st["le"]:
            edges = [str(int(e)) for e in st["le"]] + ["inf"]
            ax.bar(range(len(st["counts"])), st["counts"])
            ax.set_xticks(range(len(edges)))
            ax.set_xticklabels(edges, fontsize=7)
            ax.set_xlabel("staleness (versions behind, bucket <= edge)")
        ax.set_title("Async staleness distribution")

        ax = axes[1, 1]
        for proc_key, proc in sorted(ts_record.get("procs", {}).items()):
            for key, vals in sorted(proc.get("gauges", {}).items()):
                name, labels = _parse_metric_key(key)
                if name != "dps_store_global_step":
                    continue
                ax.plot(proc["t"], vals, "s-", ms=3,
                        label=f"{labels.get('backend', '?')} ({proc_key})")
        ax.set_title("Store global step")
        ax.set_xlabel("run time (s)")
        ax.legend(fontsize=7)

        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)

    # -- cluster health (kind=cluster monitor records) -----------------------

    @staticmethod
    def plot_cluster_health(logs: str, out_path: str) -> dict:
        """4-panel cluster-health figure from a run's captured stdout
        (``serve --telemetry`` emits the ``"kind": "cluster"`` records):
        per-worker step progress and loss curves with ALERT overlays
        (vertical lines at each fired alert, colored by severity), the
        alert timeline itself (rule vs time), and per-worker examples/s.
        Returns ``{"timeline": [...], "workers": [...]}`` so callers (the
        recorded demo) can assert on what was plotted."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .parse_logs import alert_timeline, cluster_worker_series

        timeline = alert_timeline(logs)
        series = cluster_worker_series(logs)
        sev_color = {"critical": "tab:red", "warning": "tab:orange",
                     "info": "tab:blue"}
        fired = [e for e in timeline if e["state"] == "fired"]

        fig, axes = plt.subplots(2, 2, figsize=(13, 9))

        def overlay(ax):
            for e in fired:
                ax.axvline(e["t"], color=sev_color.get(e["severity"],
                                                       "gray"),
                           ls="--", lw=1, alpha=0.7)

        ax = axes[0, 0]
        for name, w in sorted(series["workers"].items()):
            ax.plot(series["t"], w["step"], "o-", ms=3, label=name)
        overlay(ax)
        ax.set_title("Worker step progress (cluster view)")
        ax.set_xlabel("run time (s)")
        ax.legend(fontsize=7)

        ax = axes[0, 1]
        for name, w in sorted(series["workers"].items()):
            ax.plot(series["t"], w["loss"], "o-", ms=3, label=name)
        overlay(ax)
        ax.set_title("Worker loss (alert overlays)")
        ax.set_xlabel("run time (s)")
        ax.legend(fontsize=7)

        ax = axes[1, 0]
        rules = sorted({e["rule"] for e in timeline})
        ridx = {r: i for i, r in enumerate(rules)}
        marks = {"fired": "o", "refired": "s", "resolved": "x"}
        for e in timeline:
            ax.scatter(e["t"], ridx[e["rule"]],
                       marker=marks.get(e["state"], "."),
                       color=sev_color.get(e["severity"], "gray"), s=60)
        ax.set_yticks(range(len(rules)))
        ax.set_yticklabels(rules, fontsize=8)
        ax.set_title("Alert timeline (o fired, s refired, x resolved)")
        ax.set_xlabel("run time (s)")

        ax = axes[1, 1]
        for name, w in sorted(series["workers"].items()):
            ax.plot(series["t"], w["examples_per_s"], "o-", ms=3,
                    label=name)
        ax.set_title("Worker throughput (examples/s, reported)")
        ax.set_xlabel("run time (s)")
        ax.legend(fontsize=7)

        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return {"timeline": timeline,
                "workers": sorted(series["workers"])}

    def summary_table(self) -> str:
        """Console summary (visualize_results.py:278-296)."""
        lines = [f"{'experiment':<28}{'mode':<8}{'workers':>8}"
                 f"{'time(s)':>12}{'final acc':>12}",
                 "-" * 68]
        for name, rec in sorted(self.experiments.items()):
            mode, workers = self._mode_workers(rec)
            lines.append(f"{name:<28}{mode:<8}{workers:>8}"
                         f"{self._total_time(rec):>12.1f}"
                         f"{self._final_acc(rec):>12.4f}")
        return "\n".join(lines)
