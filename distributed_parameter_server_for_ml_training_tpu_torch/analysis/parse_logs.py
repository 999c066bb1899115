"""Log -> experiment-JSON ETL (reference: scripts/parse_cloudwatch_logs.py).

The JAX package's ``analysis/parse_logs.py``, carried over whole, over
the port's ``utils/metrics.py:parse_metrics_lines``.

The reference shells out to ``aws logs filter-log-events`` and regex-extracts
``METRICS_JSON:`` lines (parse_cloudwatch_logs.py:61-121). Here logs are
local files or strings (there is no CloudWatch in the loop), but the
aggregation semantics are reproduced exactly
(parse_cloudwatch_logs.py:125-177):

- server metrics pass through,
- worker totals: MAX total time across workers (the slowest worker defines
  the run), MEAN epoch time, MEAN final accuracy,
- per-epoch: max/avg/min across workers,
- raw per-worker records preserved under ``raw_worker_metrics``.

Output schema matches ``experiment_results/*.json`` (e.g.
sync_4workers.json) so the visualizer — ours or the reference's — can read
either's files.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np

from ..utils.metrics import parse_metrics_lines


def _is_worker(m: dict) -> bool:
    return "worker_id" in m


def _is_snapshot(m: dict) -> bool:
    """Live-telemetry snapshot lines (telemetry/snapshot.py) share the
    METRICS_JSON wire convention but are a different record kind: they
    carry ``"kind": "snapshot"`` and must not enter the final-stats
    aggregation (the reference schema has exactly one exit record per
    process)."""
    return m.get("kind") == "snapshot"


def _is_cluster(m: dict) -> bool:
    """Cluster-monitor records (telemetry/cluster.py ``"kind": "cluster"``)
    — same wire convention, same exclusion from the final aggregation."""
    return m.get("kind") == "cluster"


def aggregate_worker_metrics(workers: list[dict]) -> dict:
    """parse_cloudwatch_logs.py:125-177 semantics."""
    if not workers:
        return {}
    total_times = [w.get("total_training_time_seconds", 0.0) for w in workers]
    epoch_means = [w.get("average_epoch_time_seconds", 0.0) for w in workers]
    final_accs = [w.get("final_test_accuracy", 0.0) for w in workers]

    n_epochs = max((len(w.get("epoch_times_seconds", [])) for w in workers),
                   default=0)
    per_epoch = []
    for e in range(n_epochs):
        times = [w["epoch_times_seconds"][e] for w in workers
                 if len(w.get("epoch_times_seconds", [])) > e]
        accs = [w["all_test_accuracies"][e] for w in workers
                if len(w.get("all_test_accuracies", [])) > e]
        row = {
            "epoch": e + 1,
            "max_time": float(np.max(times)) if times else 0.0,
            "avg_time": float(np.mean(times)) if times else 0.0,
            "min_time": float(np.min(times)) if times else 0.0,
            "max_accuracy": float(np.max(accs)) if accs else 0.0,
            "avg_accuracy": float(np.mean(accs)) if accs else 0.0,
            "min_accuracy": float(np.min(accs)) if accs else 0.0,
        }
        # Measured per-slot training metrics (SPMD sync rows): unlike the
        # time/test-accuracy fields above — which sync workers share by
        # construction — these genuinely differ per worker.
        for field, label in (("train_loss_per_epoch", "train_loss"),
                             ("train_accuracy_per_epoch",
                              "train_accuracy")):
            vals = [w[field][e] for w in workers
                    if len(w.get(field, [])) > e]
            if vals:
                row.update({f"max_{label}": float(np.max(vals)),
                            f"avg_{label}": float(np.mean(vals)),
                            f"min_{label}": float(np.min(vals))})
        per_epoch.append(row)

    out = {
        "num_workers": len(workers),
        # the slowest worker defines the run's wall clock
        "total_training_time_seconds": float(np.max(total_times)),
        "average_epoch_time_seconds": float(np.mean(epoch_means)),
        "average_final_accuracy": float(np.mean(final_accs)),
        "per_epoch": per_epoch,
    }
    # Surface the measured-vs-derived distinction (round-4 VERDICT item
    # 10): SPMD sync rows mark which fields were measured per worker and
    # that the rest are one shared model/program measurement.
    measured = sorted({f for w in workers
                       for f in w.get("measured_per_worker_fields", [])})
    if measured:
        out["measured_per_worker_fields"] = measured
    if any(w.get("shared_model_metrics") for w in workers):
        out["shared_model_metrics"] = True
    return out


def parse_experiment(logs: str | Iterable[str],
                     experiment_name: str = "experiment") -> dict:
    """Full log text (possibly many processes' stdout) -> experiment record."""
    metrics = [m for m in parse_metrics_lines(logs)
               if not _is_snapshot(m) and not _is_cluster(m)]
    server = next((m for m in metrics
                   if not _is_worker(m) and "mode" in m), None)
    workers = [m for m in metrics if _is_worker(m)]
    return {
        "experiment_name": experiment_name,
        "server_metrics": server or {},
        "worker_metrics_aggregated": aggregate_worker_metrics(workers),
        "raw_worker_metrics": workers,
    }


# ---------------------------------------------------------------------------
# Live-telemetry snapshot streams (telemetry/snapshot.py) -> time-series.
#
# Snapshots are CUMULATIVE registry dumps on a fixed interval; rates are
# derived here from consecutive-snapshot deltas. A run's interleaved stdout
# (many processes tee into one log) demultiplexes on (role, pid).
# ---------------------------------------------------------------------------

def _parse_metric_key(key: str) -> tuple[str, dict]:
    """``'name{k=v,k2=v2}'`` -> ('name', {'k': 'v', 'k2': 'v2'})."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = dict(part.split("=", 1) for part in rest.rstrip("}").split(",")
                  if "=" in part)
    return name, labels


def parse_snapshot_series(logs: str | Iterable[str]) -> dict[str, list[dict]]:
    """All snapshot payloads, grouped by emitting process (``role:pid``),
    each group sorted by ``seq``."""
    out: dict[str, list[dict]] = {}
    for m in parse_metrics_lines(logs):
        if not _is_snapshot(m):
            continue
        key = f"{m.get('role', 'process')}:{m.get('pid', 0)}"
        out.setdefault(key, []).append(m)
    for snaps in out.values():
        snaps.sort(key=lambda s: s.get("seq", 0))
    return out


def _counter_series(snaps: list[dict]) -> tuple[dict, dict]:
    """Per-counter cumulative values and interval rates across snapshots.

    Rates align with ``t[1:]`` (a rate needs two samples); the first
    snapshot's cumulative value is still visible in ``values``.
    """
    names = sorted({k for s in snaps for k in s.get("counters", {})})
    values = {n: [float(s.get("counters", {}).get(n, 0.0)) for s in snaps]
              for n in names}
    ts = [float(s.get("ts", 0.0)) for s in snaps]
    rates = {}
    for n in names:
        r = []
        for i in range(1, len(snaps)):
            dt = ts[i] - ts[i - 1]
            dv = values[n][i] - values[n][i - 1]
            r.append(round(dv / dt, 6) if dt > 0 else 0.0)
        rates[n] = r
    return values, rates


def build_telemetry_timeseries(logs: str | Iterable[str]) -> dict:
    """Snapshot stream -> per-process time-series record.

    Output shape (JSON-ready; consumed by
    :meth:`.visualize.ExperimentVisualizer.plot_telemetry` and the recorded
    demo artifacts under ``experiments/results/telemetry/``)::

        {"procs": {"worker:1234": {
            "role": "worker", "pid": 1234,
            "t": [...relative seconds...],
            "counters": {key: [cumulative...]},
            "rates":    {key: [per-second, aligned to t[1:]]},
            "gauges":   {key: [...]},
            "histograms_final": {key: {le, counts, sum, count}},
            "pipeline": {  # only when comms-pipeline metrics were recorded
                "not_modified_ratio": [...aligned to t...],
                "queue_depth": {"worker-N": [...]},
                "overlap_saved_seconds_total": float,
                "overlap_windows": int}}}}
    """
    series = parse_snapshot_series(logs)
    procs = {}
    for proc_key, snaps in series.items():
        if not snaps:
            continue
        t0 = float(snaps[0].get("ts", 0.0)) \
            - float(snaps[0].get("uptime_seconds", 0.0))
        values, rates = _counter_series(snaps)
        gauge_names = sorted({k for s in snaps for k in s.get("gauges", {})})
        proc = {
            "role": snaps[0].get("role", "process"),
            "pid": snaps[0].get("pid", 0),
            "t": [round(float(s.get("ts", 0.0)) - t0, 3) for s in snaps],
            "counters": values,
            "rates": rates,
            "gauges": {n: [s.get("gauges", {}).get(n) for s in snaps]
                       for n in gauge_names},
            "histograms_final": dict(snaps[-1].get("histograms", {})),
        }
        pipeline = _pipeline_series(proc)
        if pipeline:
            proc["pipeline"] = pipeline
        procs[proc_key] = proc
    return {"procs": procs}


def _pipeline_series(proc: dict) -> dict:
    """Comms-pipeline evidence from one process's series (docs/
    WIRE_PROTOCOL.md metrics): the delta-fetch not-modified ratio over
    time, per-worker pipeline queue-depth series, and the total overlap
    saving. Empty dict when the process recorded none of them."""
    out: dict = {}
    # Not-modified ratio: store-side NOT_MODIFIED replies over all fetches,
    # cumulative per snapshot, summed across backends.
    fetches = [0.0] * len(proc["t"])
    not_mod = [0.0] * len(proc["t"])
    saw_nm = False
    for key, series in proc.get("counters", {}).items():
        name, _ = _parse_metric_key(key)
        if name == "dps_store_fetches_total":
            fetches = [a + b for a, b in zip(fetches, series)]
        elif name == "dps_store_fetch_not_modified_total":
            saw_nm = True
            not_mod = [a + b for a, b in zip(not_mod, series)]
    if saw_nm:
        out["not_modified_ratio"] = [
            round(nm / f, 4) if f > 0 else 0.0
            for nm, f in zip(not_mod, fetches)]
    # Queue depth: one gauge series per overlapped worker.
    depth = {}
    for key, series in proc.get("gauges", {}).items():
        name, labels = _parse_metric_key(key)
        if name == "dps_worker_pipeline_depth":
            depth[f"worker-{labels.get('worker', '?')}"] = series
    if depth:
        out["queue_depth"] = depth
    # Overlap savings: final-histogram totals (seconds of comms hidden
    # behind compute) summed across workers.
    saved_s = 0.0
    saved_n = 0
    for key, hist in proc.get("histograms_final", {}).items():
        name, _ = _parse_metric_key(key)
        if name == "dps_worker_overlap_saved_seconds":
            saved_s += float(hist.get("sum", 0.0))
            saved_n += int(hist.get("count", 0))
    if saved_n:
        out["overlap_saved_seconds_total"] = round(saved_s, 6)
        out["overlap_windows"] = saved_n
    return out


def worker_throughput_series(ts_record: dict) -> dict[str, dict]:
    """Per-worker training throughput from a built time-series record.

    Pulls every ``dps_worker_steps_total{worker=N}`` (PS workers) and
    ``dps_trainer_steps_total{mode=...}`` (SPMD trainer) counter; keys are
    ``worker-N`` / ``trainer-<mode>``, values carry the rate series aligned
    to ``t[1:]``.
    """
    out: dict[str, dict] = {}
    for proc_key, proc in ts_record.get("procs", {}).items():
        for key, rate in proc.get("rates", {}).items():
            name, labels = _parse_metric_key(key)
            if name == "dps_worker_steps_total":
                label = f"worker-{labels.get('worker', '?')}"
            elif name == "dps_trainer_steps_total":
                label = f"trainer-{labels.get('mode', '?')}"
            else:
                continue
            out[f"{label} ({proc_key})" if len(
                ts_record["procs"]) > 1 else label] = {
                "t": proc["t"][1:],
                "steps_per_second": rate,
                "cumulative_steps": proc["counters"][key],
            }
    return out


def staleness_series(ts_record: dict) -> dict:
    """Aggregate async-staleness evidence from a time-series record:
    the final histogram (summed across backends/processes) plus the
    per-snapshot observation-count series (arrival intensity over time).
    """
    le = None
    counts = None
    total_series: dict[str, dict] = {}
    for proc_key, proc in ts_record.get("procs", {}).items():
        for key, hist in proc.get("histograms_final", {}).items():
            name, _ = _parse_metric_key(key)
            if name != "dps_store_staleness_versions":
                continue
            if le is None:
                le = list(hist["le"])
                counts = [0] * len(hist["counts"])
            for i, c in enumerate(hist["counts"]):
                counts[i] += c
    for proc_key, proc in ts_record.get("procs", {}).items():
        for key in proc.get("rates", {}):
            name, labels = _parse_metric_key(key)
            if name == "dps_store_pushes_total":
                total_series[f"{labels.get('outcome', '?')} ({proc_key})"] = {
                    "t": proc["t"][1:],
                    "pushes_per_second": proc["rates"][key],
                }
    return {"le": le or [], "counts": counts or [],
            "push_rates": total_series}


# ---------------------------------------------------------------------------
# Cluster-monitor records (telemetry/cluster.py "kind": "cluster") ->
# health history. The monitor emits one record per evaluation interval:
# the live worker table + active alerts, plus the EDGE events (fired/
# refired/resolved) since the previous record. These parsers turn a run's
# captured stdout into an alert timeline and per-worker health series the
# visualizer overlays on the training curves.
# ---------------------------------------------------------------------------

def parse_cluster_series(logs: str | Iterable[str]
                         ) -> dict[str, list[dict]]:
    """All ``"kind": "cluster"`` records, grouped by emitting process
    (``role:pid``), each group sorted by ``seq``."""
    out: dict[str, list[dict]] = {}
    for m in parse_metrics_lines(logs):
        if not _is_cluster(m):
            continue
        key = f"{m.get('role', 'server')}:{m.get('pid', 0)}"
        out.setdefault(key, []).append(m)
    for recs in out.values():
        recs.sort(key=lambda r: r.get("seq", 0))
    return out


def alert_timeline(logs: str | Iterable[str]) -> list[dict]:
    """Flattened alert edge events across every cluster record, ordered by
    time. Each event: ``{"t" (seconds since the first record), "ts",
    "state" (fired|refired|resolved), "rule", "severity", "worker",
    "message", ...}`` — the overlay input for
    :meth:`.visualize.ExperimentVisualizer.plot_cluster_health`."""
    series = parse_cluster_series(logs)
    starts = [float(rec["ts"]) - float(rec.get("uptime_seconds", 0.0))
              for recs in series.values() for rec in recs
              if rec.get("ts")]
    t0 = min(starts) if starts else None
    events: list[dict] = []
    for proc_key, recs in series.items():
        for rec in recs:
            for ev in rec.get("events", []):
                if not isinstance(ev, dict):
                    continue
                ts = float(ev.get("last_ts") or ev.get("since")
                           or rec.get("ts") or 0.0)
                events.append({
                    "t": round(ts - t0, 3) if t0 is not None else 0.0,
                    "ts": ts,
                    "proc": proc_key,
                    "state": ev.get("state"),
                    "rule": ev.get("rule"),
                    "severity": ev.get("severity"),
                    "worker": ev.get("worker"),
                    "message": ev.get("message"),
                    "value": ev.get("value"),
                    "threshold": ev.get("threshold"),
                })
    events.sort(key=lambda e: e["ts"])
    return events


def cluster_worker_series(logs: str | Iterable[str]) -> dict:
    """Per-worker health time-series from the cluster records: ``t``
    (relative seconds) plus step/loss/grad-norm/examples-per-second
    sequences keyed ``worker-N`` — the cluster-eye view of each worker,
    as opposed to the worker's own snapshot stream."""
    series = parse_cluster_series(logs)
    recs = [r for recs in series.values() for r in recs]
    recs.sort(key=lambda r: float(r.get("ts", 0.0)))
    if not recs:
        return {"t": [], "workers": {}}
    t0 = float(recs[0].get("ts", 0.0)) \
        - float(recs[0].get("uptime_seconds", 0.0))
    t = [round(float(r.get("ts", 0.0)) - t0, 3) for r in recs]
    workers: dict[str, dict] = {}
    for i, rec in enumerate(recs):
        for row in rec.get("workers", []):
            wid = row.get("worker")
            if wid is None:
                continue
            w = workers.setdefault(
                f"worker-{wid}",
                {k: [None] * len(recs)
                 for k in ("step", "loss", "grad_norm",
                           "examples_per_s", "alive")})
            for k in ("step", "loss", "grad_norm", "examples_per_s",
                      "alive"):
                w[k][i] = row.get(k)
    return {"t": t, "workers": workers}


def parse_log_files(paths: list[str], experiment_name: str,
                    out_path: str | None = None) -> dict:
    texts = []
    for p in paths:
        with open(p) as f:
            texts.append(f.read())
    record = parse_experiment("\n".join(texts), experiment_name)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)
    return record
