"""Causal postmortem timelines from the durable telemetry journal.

The JAX package's ``analysis/incidents.py``, carried over whole, over
the port's ``telemetry/journal.py:JournalReader``: it reads the bundles
the port's ``telemetry/incidents.py`` writes and the JAX package's alike.

``cli incident report`` answers the morning-after question — *what
happened, in what order, and did the system heal itself?* — from disk
alone: every live process may be gone. This module is the pure
(dicts-in, dicts-out, dependency-free) engine behind it:

- :func:`load_incident` reads a frozen ``incidents/<id>/`` bundle and
  merges its ``journal_window.jsonl`` with the live journal directory
  named in the manifest — the window ends at the capture edge, but the
  remediation and resolution that FOLLOW the edge live in the journal's
  later segments, and a postmortem needs the whole arc.
- :func:`build_timeline` joins the merged records across processes by
  time (and worker/rule/shard identity) into an ordered
  fault → alert → remediation → resolution narrative, with per-phase
  first-arrival stamps and an ``ordered`` verdict (did causality run
  the right way?).
- :func:`render_timeline` formats it for humans; the dict shape is the
  JSON form.

Timeline phases (:data:`PHASE_ORDER`): a ``fault`` record marks the
seeded/observed root cause; ``alert``/``slo_burn`` fired edges are the
detection; ``remediation``/``respawn``/``directive`` the response;
``alert`` resolved edges the resolution. Everything else journaled
(checkpoints, migrations, re-parents, incident captures) rides along as
``context`` — present in the narrative, not in the causal verdict.
"""

from __future__ import annotations

import json
import os

from ..telemetry.journal import JournalReader

__all__ = [
    "PHASE_ORDER",
    "build_timeline",
    "classify_event",
    "describe_event",
    "list_incidents",
    "load_incident",
    "render_timeline",
]

#: Causal phases in the order a healthy self-healing arc visits them.
PHASE_ORDER = ("fault", "alert", "remediation", "resolution")

#: Journal types that never enter the timeline (dense metric samples).
_SERIES_TYPES = ("snapshot", "fleet_tick")


def classify_event(rec: dict) -> str | None:
    """Phase for one journal record; ``"context"`` for narrative-only
    types, ``None`` for dense series records."""
    t = rec.get("type")
    if t in _SERIES_TYPES:
        return None
    if t == "fault":
        return "fault"
    if t == "alert":
        return ("resolution" if rec.get("state") == "resolved"
                else "alert")
    if t == "slo_burn":
        return "alert"
    if t in ("remediation", "respawn", "directive"):
        return "remediation"
    return "context"


def describe_event(rec: dict) -> str:
    """One human line for a timeline record."""
    t = rec.get("type")
    if t == "fault":
        return f"fault plan armed: {rec.get('spec')!r}"
    if t == "alert":
        return (f"{rec.get('state')} {rec.get('rule')} "
                f"[{rec.get('severity')}]"
                + (f" worker={rec.get('worker')}"
                   if rec.get("worker") is not None else "")
                + (f" value={rec.get('value')}"
                   if rec.get("value") is not None else ""))
    if t == "slo_burn":
        return (f"SLO burn {rec.get('rule')} {rec.get('objective')} "
                f"burn={rec.get('burn')} "
                f"(threshold {rec.get('burn_threshold')})")
    if t in ("remediation", "respawn"):
        return f"{rec.get('action')} -> {rec.get('outcome')}"
    if t == "directive":
        return (f"directive {rec.get('action')} -> worker "
                f"{rec.get('worker')} (seq {rec.get('seq')})")
    if t == "migration":
        return (f"migration {rec.get('id')} phase={rec.get('phase')} "
                f"role={rec.get('mig_role')}")
    if t == "reparent":
        return (f"replica shard {rec.get('shard')} reparented "
                f"{rec.get('old')} -> {rec.get('new')}")
    if t == "checkpoint":
        return f"checkpoint step {rec.get('step')} -> {rec.get('path')}"
    if t == "incident":
        return f"incident bundle {rec.get('id')} frozen"
    return json.dumps({k: v for k, v in rec.items()
                       if k not in ("v", "seq")}, default=str)


def build_timeline(records: list) -> dict:
    """The ordered cross-process narrative over merged journal records.

    Returns ``{"events", "phases", "span", "counts", "ordered",
    "workers"}``: events sorted by ``(ts, pid, seq)`` each carrying
    ``phase``/``rel_s``/``summary``; ``phases`` maps each causal phase
    present to its first/last arrival and count; ``ordered`` is True
    when the first arrivals of the present causal phases respect
    :data:`PHASE_ORDER`; ``workers`` groups event indices by worker
    identity for per-actor reading."""
    rows = []
    for rec in records:
        phase = classify_event(rec)
        if phase is None:
            continue
        rows.append((rec, phase))
    rows.sort(key=lambda rp: (rp[0].get("ts", 0.0),
                              rp[0].get("pid", 0),
                              rp[0].get("seq", 0)))
    t0 = rows[0][0].get("ts", 0.0) if rows else 0.0
    events = []
    phases: dict = {}
    counts: dict = {}
    workers: dict = {}
    for i, (rec, phase) in enumerate(rows):
        ts = rec.get("ts", 0.0)
        ev = {
            "ts": ts,
            "rel_s": round(ts - t0, 3),
            "phase": phase,
            "type": rec.get("type"),
            "role": rec.get("role"),
            "pid": rec.get("pid"),
            "summary": describe_event(rec),
        }
        for key in ("worker", "rule", "shard", "action", "state"):
            if rec.get(key) is not None:
                ev[key] = rec[key]
        events.append(ev)
        counts[ev["type"]] = counts.get(ev["type"], 0) + 1
        if phase in PHASE_ORDER:
            row = phases.setdefault(phase, {"first_ts": ts,
                                            "last_ts": ts, "count": 0})
            row["first_ts"] = min(row["first_ts"], ts)
            row["last_ts"] = max(row["last_ts"], ts)
            row["count"] += 1
        if ev.get("worker") is not None:
            workers.setdefault(str(ev["worker"]), []).append(i)
    firsts = [phases[p]["first_ts"] for p in PHASE_ORDER if p in phases]
    ordered = all(a <= b for a, b in zip(firsts, firsts[1:]))
    span = {"start_ts": t0,
            "end_ts": rows[-1][0].get("ts", 0.0) if rows else 0.0}
    return {"events": events, "phases": phases, "span": span,
            "counts": counts, "ordered": ordered, "workers": workers}


def render_timeline(timeline: dict, manifest: dict | None = None) -> str:
    """Human rendering: header, phase ledger, then the event log."""
    lines = []
    if manifest:
        lines.append(f"incident {manifest.get('id')} — trigger "
                     f"{(manifest.get('trigger') or {}).get('rule')} "
                     f"[{(manifest.get('trigger') or {}).get('severity')}]")
    span = timeline["span"]
    dur = span["end_ts"] - span["start_ts"]
    lines.append(f"{len(timeline['events'])} events over {dur:.1f}s — "
                 f"causal order "
                 f"{'OK' if timeline['ordered'] else 'VIOLATED'}")
    for phase in PHASE_ORDER:
        row = timeline["phases"].get(phase)
        if row is None:
            lines.append(f"  {phase:<12} -")
            continue
        lines.append(f"  {phase:<12} first +"
                     f"{row['first_ts'] - span['start_ts']:.2f}s "
                     f"x{row['count']}")
    lines.append("")
    for ev in timeline["events"]:
        who = f"{ev.get('role')}/{ev.get('pid')}"
        lines.append(f"  +{ev['rel_s']:8.2f}s  [{ev['phase']:<11}] "
                     f"{who:<16} {ev['summary']}")
    return "\n".join(lines)


def load_incident(bundle_dir: str, journal_dir: str | None = None
                  ) -> dict:
    """One frozen bundle + the journal's post-edge continuation.

    ``journal_dir`` overrides the manifest's recorded directory (the
    bundle may have moved hosts). Records are deduped by
    ``(role, pid, seq)`` — the frozen window and the live journal
    overlap by construction."""
    with open(os.path.join(bundle_dir, "manifest.json"),
              encoding="utf-8") as f:
        manifest = json.load(f)
    records = []
    stats: dict = {}
    window = os.path.join(bundle_dir, "journal_window.jsonl")
    if os.path.exists(window):
        reader = JournalReader(window)
        records.extend(reader.records())
        stats["window"] = dict(reader.stats)
    jdir = journal_dir or manifest.get("journal_dir")
    if jdir and os.path.isdir(jdir):
        reader = JournalReader(jdir)
        records.extend(reader.records())
        stats["journal"] = dict(reader.stats)
    seen = set()
    deduped = []
    for rec in sorted(records, key=lambda r: (r.get("ts", 0.0),
                                              r.get("pid", 0),
                                              r.get("seq", 0))):
        key = (rec.get("role"), rec.get("pid"), rec.get("seq"))
        if key in seen:
            continue
        seen.add(key)
        deduped.append(rec)
    return {"manifest": manifest, "records": deduped, "stats": stats}


def list_incidents(incidents_dir: str) -> list:
    """Manifest rows for every bundle under ``incidents_dir``, oldest
    first; unreadable bundles are reported, not fatal."""
    out = []
    try:
        names = sorted(os.listdir(incidents_dir))
    except OSError:
        return out
    for name in names:
        bundle = os.path.join(incidents_dir, name)
        manifest_path = os.path.join(bundle, "manifest.json")
        if not os.path.isfile(manifest_path):
            continue
        try:
            with open(manifest_path, encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            out.append({"id": name, "path": bundle,
                        "error": repr(e)})
            continue
        manifest["path"] = bundle
        out.append(manifest)
    return out
