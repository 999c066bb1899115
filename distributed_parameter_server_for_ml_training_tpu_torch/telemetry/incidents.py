"""Automatic black-box capture: freeze a forensic bundle at the edge.

The JAX package's ``telemetry/incidents.py``, carried over whole (it is
framework-neutral) with the port's journal and registry. The moment a
critical health rule fires is exactly when the evidence is richest and
the operator is absent. :class:`IncidentCapture` rides the edge sources
— ``ClusterMonitor.add_listener`` on the serving coordinator, or a
polled fleet view — and freezes a bundle into ``incidents/<id>/`` the
instant an edge arrives:

- ``manifest.json`` — the :data:`MANIFEST_FIELDS` schema;
- ``journal_window.jsonl`` — the merged journal slice covering
  ``window_s`` seconds before the edge;
- ``snapshots.json`` — point-in-time views (``/cluster``) from
  ``views_fn``;
- ``traces/`` — flight-recorder dumps via ``traces_fn``.

An alert storm must yield ONE bundle, not a bundle per refire: captures
dedupe per rule inside ``cooldown_s`` (suppressions are counted on
``dps_incidents_suppressed_total``; captures on
``dps_incidents_captured_total``). Capture is best-effort everywhere —
a missing trace endpoint degrades the bundle, never the serving path.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .journal import JournalReader, JournalWriter, journal_event
from .registry import MetricsRegistry, get_registry

__all__ = ["MANIFEST_FIELDS", "IncidentCapture"]

#: ``manifest.json`` schema: field -> meaning (the JAX package's, key for
#: key, so either package's bundles read the same).
MANIFEST_FIELDS = {
    "id": "bundle id: inc-<utc stamp>-<pid>-<rule>",
    "created_ts": "unix seconds the capture fired",
    "role": "role of the capturing process (server, observer, ...)",
    "trigger": "the full edge event that fired the capture "
               "(rule, severity, worker, value, threshold, ...)",
    "window_s": "seconds of journal history frozen before the edge",
    "journal_dir": "journal directory the window was sliced from",
    "files": "bundle-relative file names actually written",
    "records": "record count inside journal_window.jsonl",
}


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, path)


class IncidentCapture:
    """Edge-triggered bundle freezer with per-rule cooldown dedupe.

    ``journal`` is a :class:`JournalWriter` (sealed best-effort before
    slicing so the window includes the freshest records) or a journal
    directory path. ``views_fn()`` returns ``{name: snapshot}`` dicts;
    ``traces_fn(trigger)`` returns ``[(file_name, payload), ...]``.
    """

    def __init__(self, incidents_dir: str, journal=None, views_fn=None,
                 traces_fn=None, window_s: float = 120.0,
                 cooldown_s: float = 120.0, role: str = "server",
                 registry: MetricsRegistry | None = None,
                 clock=time.time):
        if window_s <= 0 or cooldown_s < 0:
            raise ValueError("window_s must be > 0 and cooldown_s >= 0")
        self.incidents_dir = incidents_dir
        self.journal = journal
        self.views_fn = views_fn
        self.traces_fn = traces_fn
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.role = role
        self.clock = clock
        reg = registry or get_registry()
        self._tm_captured = reg.counter("dps_incidents_captured_total")
        self._tm_suppressed = reg.counter(
            "dps_incidents_suppressed_total")
        self._lock = threading.Lock()
        self._last_capture = {}   # guarded by: self._lock
        self._seen_edges = set()  # guarded by: self._lock

    # -- edge sources ------------------------------------------------------

    def on_alert_events(self, events) -> None:
        """``ClusterMonitor.add_listener`` entry: capture on every
        *newly fired* critical edge (refires and resolves never
        trigger; the cooldown handles storms of distinct fires)."""
        for ev in events:
            if ev.get("state") == "fired" \
                    and ev.get("severity") == "critical":
                self.maybe_capture(dict(ev))

    def on_fleet_view(self, view: dict) -> None:
        """Observer-side edge source: scan one ``/fleet`` view for
        critical active alerts and fleet SLO breaches, triggering once
        per distinct edge identity (then cooldown applies)."""
        triggers = []
        for alert in view.get("alerts") or ():
            if alert.get("severity") != "critical":
                continue
            key = ("alert", alert.get("rule"), alert.get("worker"),
                   alert.get("since"))
            triggers.append((key, dict(alert)))
        for breach in (view.get("slo") or {}).get("breaches") or ():
            if breach.get("severity") != "critical":
                continue
            key = ("slo", breach.get("rule"), breach.get("objective"))
            triggers.append((key, dict(breach)))
        for key, trigger in triggers:
            with self._lock:
                if key in self._seen_edges:
                    continue
                self._seen_edges.add(key)
            self.maybe_capture(trigger)

    # -- capture -----------------------------------------------------------

    def maybe_capture(self, trigger: dict) -> str | None:
        """Freeze one bundle unless the rule is inside its cooldown.
        Returns the bundle directory, or ``None`` when suppressed."""
        rule = trigger.get("rule") or "unknown"
        now = self.clock()
        with self._lock:
            last = self._last_capture.get(rule)
            if last is not None and now - last < self.cooldown_s:
                self._tm_suppressed.inc()
                return None
            self._last_capture[rule] = now
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))
        inc_id = f"inc-{stamp}-{os.getpid()}-{rule}"
        bundle = os.path.join(self.incidents_dir, inc_id)
        n = 1
        while os.path.exists(bundle):
            # two same-rule edges inside one second (cooldown_s=0, or
            # distinct fleet-edge identities) must not share a bundle
            n += 1
            inc_id = f"inc-{stamp}-{os.getpid()}-{rule}-{n}"
            bundle = os.path.join(self.incidents_dir, inc_id)
        os.makedirs(bundle)
        files = []
        records = 0
        journal_dir = self._journal_dir()
        if journal_dir:
            records = self._freeze_window(bundle, journal_dir, now)
            files.append("journal_window.jsonl")
        if self.views_fn is not None:
            try:
                views = self.views_fn()
            except Exception:  # noqa: BLE001 — degrade, never fail
                views = None
            if views is not None:
                _atomic_json(os.path.join(bundle, "snapshots.json"),
                             views)
                files.append("snapshots.json")
        if self.traces_fn is not None:
            try:
                traces = list(self.traces_fn(trigger) or ())
            except Exception:  # noqa: BLE001 — degrade, never fail
                traces = []
            if traces:
                tdir = os.path.join(bundle, "traces")
                os.makedirs(tdir, exist_ok=True)
                for name, payload in traces:
                    base = os.path.basename(str(name)) or "trace.json"
                    _atomic_json(os.path.join(tdir, base), payload)
                    files.append(os.path.join("traces", base))
        manifest = {
            "id": inc_id,
            "created_ts": round(now, 3),
            "role": self.role,
            "trigger": trigger,
            "window_s": self.window_s,
            "journal_dir": journal_dir,
            "files": sorted(files),
            "records": records,
        }
        _atomic_json(os.path.join(bundle, "manifest.json"), manifest)
        self._tm_captured.inc()
        journal_event("incident", id=inc_id, rule=rule, path=bundle)
        return bundle

    def _journal_dir(self) -> str | None:
        if isinstance(self.journal, JournalWriter):
            try:
                self.journal.seal()
            except Exception:  # noqa: BLE001 — stale tail beats no tail
                pass
            return self.journal.directory
        if isinstance(self.journal, str):
            return self.journal
        return None

    def _freeze_window(self, bundle: str, journal_dir: str,
                       now: float) -> int:
        reader = JournalReader(journal_dir)
        try:
            window = reader.records(start_ts=now - self.window_s)
        except Exception:  # noqa: BLE001 — degrade, never fail
            window = []
        path = os.path.join(bundle, "journal_window.jsonl")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in window:
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=str) + "\n")
        os.replace(tmp, path)
        return len(window)
