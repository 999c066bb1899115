"""Trace assembly, Perfetto export, and critical-path straggler attribution.

The JAX package's ``analysis/traces.py``, carried over whole (it is
framework-neutral). Consumes the span records the flight recorder
produces (``telemetry/trace.py``): crash/atexit dump files,
``/debug/trace`` bodies, or raw span lists. Three capabilities:

- :func:`assemble_traces` — join spans from MANY processes by
  ``trace_id`` and parent links into per-step trace trees (the server's
  ``rpc.server``/``store.*`` spans nest under the originating worker's
  step via the wire-propagated context);
- :func:`to_chrome_trace` — Chrome trace-event JSON (the ``traceEvents``
  array format), loadable directly in Perfetto / ``chrome://tracing``;
- :func:`critical_path_report` — classify each ``worker.step``'s wall
  time into **compute / fetch-wait / push-wait / server-apply / codec**
  and rank steps by wall time with their dominant phase.

Attribution semantics: the wait phases are the training thread's blocked
time measured inline; nested codec spans are subtracted from the wait
they occurred under, and ``store.apply`` time reached through the push's
propagated context is reported as its own ``server_apply`` phase
(subtracted from push-wait, where it physically overlapped). The phases
are therefore disjoint and their sum over wall time is the report's
``coverage``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

#: Span names the attribution pass classifies (telemetry SPAN_CATALOG).
_PHASE_OF = {
    "worker.compute": "compute",
    "worker.fetch_wait": "fetch_wait",
    "worker.push_wait": "push_wait",
    "worker.codec": "codec",
    "store.apply": "server_apply",
}
_WAIT_NAMES = ("worker.fetch_wait", "worker.push_wait")
PHASES = ("compute", "fetch_wait", "push_wait", "server_apply", "codec")


def load_trace_dumps(paths: Iterable[str]) -> list[dict]:
    """Merge span records from flight-recorder dump files (or any JSON
    file holding either a ``{"spans": [...]}`` payload or a bare span
    list). Deduplicates by ``span_id`` — a SIGTERM dump followed by an
    atexit dump of the same process overlaps almost entirely."""
    spans: list[dict] = []
    seen: set[str] = set()
    for path in paths:
        with open(path) as f:
            payload = json.load(f)
        records = payload.get("spans", []) if isinstance(payload, dict) \
            else payload
        for s in records:
            sid = s.get("span_id")
            if isinstance(sid, str) and sid in seen:
                continue
            if isinstance(sid, str):
                seen.add(sid)
            spans.append(s)
    return spans


def find_trace_dumps(dump_dir: str) -> list[str]:
    """All flight-recorder dump files under ``dump_dir`` (the
    ``trace-<role>-<pid>-<reason>.json`` naming of
    ``FlightRecorder.dump_to_dir``), sorted for stable assembly order."""
    return sorted(
        os.path.join(dump_dir, f) for f in os.listdir(dump_dir)
        if f.startswith("trace-") and f.endswith(".json"))


# -- assembly ----------------------------------------------------------------

def assemble_traces(spans: list[dict]) -> dict:
    """Join spans (any mix of processes) into per-trace trees.

    Returns ``{"traces": [{"trace_id", "span_count", "roots": [tree...]}],
    "orphan_spans": n}`` where each tree node is the span dict plus a
    ``"children"`` list (sorted by start time). A span whose parent never
    made it into a dump (ring-buffer eviction, a process that produced no
    dump) becomes a root of its trace rather than disappearing — partial
    post-mortems still assemble.
    """
    by_id: dict[str, dict] = {}
    span_counts: dict[str, int] = {}
    for s in spans:
        sid = s.get("span_id")
        if isinstance(sid, str):
            by_id[sid] = {**s, "children": []}
    traces: dict[str, list] = {}
    orphans = 0
    for node in by_id.values():
        tid = node.get("trace_id", "?")
        span_counts[tid] = span_counts.get(tid, 0) + 1
        pid_ = node.get("parent_id")
        parent = by_id.get(pid_) if isinstance(pid_, str) else None
        if parent is not None and parent.get("trace_id") == tid:
            parent["children"].append(node)
        else:
            if pid_ is not None and parent is None:
                orphans += 1
            traces.setdefault(tid, []).append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n.get("ts", 0.0))
    out = []
    for tid, roots in traces.items():
        roots.sort(key=lambda n: n.get("ts", 0.0))
        out.append({
            "trace_id": tid,
            "span_count": span_counts.get(tid, 0),
            "roots": roots,
        })
    out.sort(key=lambda t: t["roots"][0].get("ts", 0.0) if t["roots"]
             else 0.0)
    return {"traces": out, "orphan_spans": orphans}


def _walk(node: dict):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


def _walk_critical(node: dict):
    """Descendants on the training thread's critical path: subtrees under
    a ``pipeline.comms`` span are the OVERLAPPED comms work — it ran on
    the comms thread hidden behind compute, so counting its store/apply/
    codec time as step phases would double-book wall clock (the step only
    paid the submit/await waits, which are measured directly)."""
    for c in node.get("children", ()):
        if c.get("name") == "pipeline.comms":
            continue
        yield c
        yield from _walk_critical(c)


# -- Chrome trace-event / Perfetto export ------------------------------------

def to_chrome_trace(spans: list[dict]) -> dict:
    """Span records -> Chrome trace-event JSON object format.

    Loadable by Perfetto (ui.perfetto.dev) and ``chrome://tracing``:
    complete events (``"ph": "X"``) with microsecond ``ts``/``dur``, one
    timeline row per (process, thread), process rows named
    ``<role>:<pid>``, and the trace/span ids in ``args`` so a row can be
    joined back to the JSON dumps."""
    events: list[dict] = []
    seen_procs: set = set()
    for s in spans:
        pid_ = int(s.get("pid", 0))
        tid = int(s.get("tid", 0)) % (1 << 31)  # Perfetto wants small-ish ints
        if pid_ not in seen_procs:
            seen_procs.add(pid_)
            events.append({"ph": "M", "name": "process_name", "pid": pid_,
                           "tid": 0,
                           "args": {"name": f"{s.get('role', 'process')}:"
                                            f"{pid_}"}})
        args = dict(s.get("attrs", {}))
        args["trace_id"] = s.get("trace_id")
        args["span_id"] = s.get("span_id")
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        events.append({
            "ph": "X",
            "name": str(s.get("name", "?")),
            "cat": str(s.get("name", "?")).split(".", 1)[0],
            "ts": round(float(s.get("ts", 0.0)) * 1e6, 3),
            "dur": max(0.0, round(float(s.get("dur", 0.0)) * 1e6, 3)),
            "pid": pid_,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_chrome_trace(spans: list[dict], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans), f)
    return path


# -- critical-path attribution -----------------------------------------------

def _attribute_step(root: dict) -> dict:
    """Phase breakdown of one ``worker.step`` tree (docstring above for
    the disjointness rules)."""
    wall = float(root.get("dur", 0.0))
    phases = {p: 0.0 for p in PHASES}
    # Pass 1: per-span phase durations along the critical path; nested
    # codec/apply noted per wait in pass 2.
    for node in _walk_critical(root):
        phase = _PHASE_OF.get(node.get("name"))
        if phase:
            phases[phase] += float(node.get("dur", 0.0))
    # Pass 2: waits are reported EXCLUSIVE of the codec/apply work nested
    # under them (physically inside the wait, reported as their own
    # phases).
    for wait_name in _WAIT_NAMES:
        phase = _PHASE_OF[wait_name]
        for node in _walk_critical(root):
            if node.get("name") != wait_name:
                continue
            nested = sum(
                float(d.get("dur", 0.0)) for d in _walk_critical(node)
                if _PHASE_OF.get(d.get("name")) in ("codec",
                                                    "server_apply"))
            phases[phase] = max(0.0, phases[phase] - nested)
    covered = sum(phases.values())
    attrs = dict(root.get("attrs", {}))
    staleness = [
        n.get("attrs", {}).get("staleness") for n in _walk(root)
        if n.get("name") == "store.apply"
        and n.get("attrs", {}).get("staleness") is not None]
    entry = {
        "trace_id": root.get("trace_id"),
        "worker": attrs.get("worker"),
        "step": attrs.get("step"),
        "epoch": attrs.get("epoch"),
        "epoch_open": bool(attrs.get("epoch_open", False)),
        "role": root.get("role"),
        "pid": root.get("pid"),
        "ts": root.get("ts"),
        "wall_s": round(wall, 6),
        "phases_s": {p: round(v, 6) for p, v in phases.items()},
        "coverage": round(covered / wall, 4) if wall > 0 else 0.0,
        "dominant_phase": max(phases, key=phases.get) if covered > 0
        else "other",
    }
    if staleness:
        entry["staleness"] = max(staleness)
    return entry


def critical_path_report(spans: list[dict], top: int = 10) -> dict:
    """Rank ``worker.step`` traces by wall time with per-phase attribution.

    Returns::

        {"steps": n,
         "step_wall_total_s": summed wall over ALL steps (not just the
                              top-N — the perf-observatory
                              reconciliation base),
         "phase_totals_s": {compute, fetch_wait, push_wait,
                            server_apply, codec},
         "stragglers": [top-N step entries, slowest first, each with
                        wall_s / phases_s / coverage / dominant_phase
                        (+ staleness when an async apply recorded it)],
         "by_dominant_phase": {phase: count}}
    """
    assembled = assemble_traces(spans)
    entries = []
    for trace in assembled["traces"]:
        for root in trace["roots"]:
            if root.get("name") == "worker.step":
                entries.append(_attribute_step(root))
    entries.sort(key=lambda e: e["wall_s"], reverse=True)
    totals = {p: 0.0 for p in PHASES}
    by_dom: dict[str, int] = {}
    for e in entries:
        for p in PHASES:
            totals[p] += e["phases_s"][p]
        by_dom[e["dominant_phase"]] = by_dom.get(e["dominant_phase"], 0) + 1
    return {
        "steps": len(entries),
        "step_wall_total_s": round(sum(e["wall_s"] for e in entries), 6),
        "phase_totals_s": {p: round(v, 6) for p, v in totals.items()},
        "stragglers": entries[:top],
        "by_dominant_phase": by_dom,
    }
