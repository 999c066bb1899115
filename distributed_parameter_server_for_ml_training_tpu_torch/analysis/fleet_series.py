"""Fleet-series analysis: joining ``/fleet`` rollups to flight recorders.

The JAX package's ``analysis/fleet_series.py``, carried over whole, over
the port's ``analysis/traces.py``.

The fleet observatory (telemetry/fleet.py) attaches head-sampled trace
exemplars to the serve-path latency histograms it merges, so a fleet
p99 spike is not just a number — it carries the trace ids of recent
requests that actually landed in the slow buckets. This module closes
the loop: extract those exemplars from a ``/fleet`` snapshot and
resolve them against flight-recorder dumps (``trace-*.json``,
analysis/traces.py conventions) into assembled trace trees, so "the
fleet p99 jumped at 14:02" becomes "…and here is the worker step /
RPC handler tree of a request that was slow".

Offline and dependency-free (pure dicts in, dicts out): runs in the
same environments as the rest of ``analysis/``.
"""

from __future__ import annotations

from .traces import assemble_traces, find_trace_dumps, load_trace_dumps

__all__ = ["extract_exemplars", "resolve_exemplars"]


def extract_exemplars(fleet_view: dict, min_value_s: float = 0.0,
                      series_prefix: str | None = None) -> list[dict]:
    """Flatten every histogram exemplar in a ``/fleet`` snapshot.

    Returns rows ``{"series", "bucket", "le", "trace_id", "value",
    "ts"}`` sorted slowest-first — the head of the list is what a p99
    investigation wants. ``min_value_s`` keeps only exemplars at or
    above a latency floor (e.g. the SLO threshold); ``series_prefix``
    restricts to one histogram family (``"dps_rpc_server_latency"``).
    """
    rows: list[dict] = []
    hists = (fleet_view.get("rollups") or {}).get("histograms") or {}
    for series, snap in hists.items():
        if series_prefix is not None \
                and not series.startswith(series_prefix):
            continue
        edges = snap.get("le") or []
        for idx_s, ex in (snap.get("exemplars") or {}).items():
            try:
                idx = int(idx_s)
            except (TypeError, ValueError):
                continue
            value = float(ex.get("value", 0.0))
            if value < min_value_s:
                continue
            rows.append({
                "series": series,
                "bucket": idx,
                "le": (edges[idx] if 0 <= idx < len(edges) else None),
                "trace_id": ex.get("trace_id"),
                "value": value,
                "ts": ex.get("ts"),
            })
    rows.sort(key=lambda r: -r["value"])
    return rows


def resolve_exemplars(fleet_view: dict, dump_dir: str | None = None,
                      dump_paths: list | None = None,
                      min_value_s: float = 0.0,
                      series_prefix: str | None = None) -> dict:
    """Join a snapshot's exemplars against flight-recorder dumps.

    Loads every ``trace-*.json`` under ``dump_dir`` (and/or the explicit
    ``dump_paths``), assembles the spans into per-trace trees, and marks
    each exemplar resolved when its trace id has at least one recorded
    span. Returns::

        {"exemplars": [row + {"resolved", "span_count"}],
         "resolved": n, "unresolved": n,
         "traces": {trace_id: assembled-trace}}   # resolved ones only

    Unresolved exemplars are expected in steady state — the recorder is
    a bounded ring, so only exemplars recent enough to still be in some
    process's buffer (or in a dump taken near the spike) resolve. The
    slowest-resolved exemplar's tree is the one to read first.
    """
    paths = list(dump_paths or [])
    if dump_dir is not None:
        paths.extend(find_trace_dumps(dump_dir))
    spans = load_trace_dumps(dict.fromkeys(paths)) if paths else []
    assembled = assemble_traces(spans) if spans else {"traces": []}
    by_trace = {t["trace_id"]: t for t in assembled["traces"]}
    rows = extract_exemplars(fleet_view, min_value_s=min_value_s,
                             series_prefix=series_prefix)
    resolved_traces: dict[str, dict] = {}
    n_resolved = 0
    for row in rows:
        t = by_trace.get(row["trace_id"])
        row["resolved"] = t is not None
        row["span_count"] = 0 if t is None else t["span_count"]
        if t is not None:
            n_resolved += 1
            resolved_traces[row["trace_id"]] = t
    return {"exemplars": rows, "resolved": n_resolved,
            "unresolved": len(rows) - n_resolved,
            "traces": resolved_traces}
