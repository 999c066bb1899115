"""ClusterMonitor: the parameter server's live cluster-wide health view.

The JAX package's ``telemetry/cluster.py``, carried over with the port's
registry, journal, flight recorder and METRICS_JSON emitter. The registry,
the snapshot stream and the traces make every PROCESS observable; the
cluster itself is N disjoint scrape targets with no central aggregation.
This module closes that gap at the one process that already talks to
every worker — the parameter server:

- workers piggyback a compact **health report** on their heartbeat pings and
  pushes (``comms/client.py`` attaches it to the envelope meta,
  capability-gated at registration exactly like delta-fetch/trace-context;
  legacy peers degrade to report-less heartbeats);
- :meth:`ClusterMonitor.ingest` collects those reports,
  :meth:`ClusterMonitor.evaluate` joins them with the store's membership
  state (``MembershipMixin.membership_snapshot`` / ``last_seen`` / the serve
  loop's ``expire_stale_workers`` results via :meth:`note_expired`) into a
  :class:`~.health.ClusterState` and runs the
  :class:`~.health.HealthRuleEngine` over it;
- alert events land in the **flight recorder** (``cluster.alert`` records
  beside the trace spans, so a post-mortem dump carries the alert history),
  increment ``dps_alerts_total{rule,severity}``, and ride
  ``"kind": "cluster"`` METRICS_JSON records (:meth:`emit_once`).

In the port, ``cli serve`` serves the view at ``GET /cluster`` and
``/healthz`` (``telemetry/prometheus.py``), streams the records with
``--telemetry`` and attaches the memory monitor and the profile trigger;
``cli status`` and the sharding and tenancy attachments come with ROADMAP
§1 item 8's rest and item 9, and their attributes are here, so those
slices only have to set them.

Everything here is observe-only: ingest and evaluation never touch the
store's training state, and every consumer-facing entry point swallows its
own failures — monitoring a server must never be able to break it.
"""

from __future__ import annotations

import math
import os
import threading
import time

from .health import (
    RULE_CATALOG,
    SEVERITIES,
    ClusterState,
    HealthRuleEngine,
    HealthThresholds,
    WorkerState,
)
from .journal import journal_event
from .registry import VALUE_BUCKETS, get_registry

__all__ = [
    "ClusterMonitor",
    "REPORT_FIELDS",
    "get_cluster_monitor",
    "sanitize_report",
    "set_cluster_monitor",
]

#: The wire report schema (docs/OBSERVABILITY.md): every field optional,
#: unknown fields dropped, values coerced/nulled by :func:`sanitize_report`.
#: Non-finite loss/grad values are transmitted as ``None`` + a false
#: ``*_finite`` flag so NaN never has to survive a JSON hop.
REPORT_FIELDS = {
    "step": int,
    "epoch": int,
    "loss": float,
    "grad_norm": float,
    "loss_finite": bool,
    "grad_finite": bool,
    "examples_per_s": float,
    "pipeline_depth": int,
    "reconnects": int,
    "heartbeat_errors": int,
    # Negotiated push codec as the worker currently runs it, e.g.
    # "int4+ef" or "adaptive(topk)+ef" (docs/WIRE_PROTOCOL.md); length-
    # capped on ingest so a hostile peer can't balloon the view.
    "push_codec": str,
    # Productive fraction of this worker's wall so far (telemetry/
    # goodput.py) — the `cli status`/`cli top` goodput column.
    "goodput_fraction": float,
}


def sanitize_report(report) -> dict | None:
    """Coerce a wire health report to the schema; None if unusable.

    Never raises: a garbled report from a buggy/hostile peer degrades to
    "no report", not a failed RPC or a poisoned monitor."""
    if not isinstance(report, dict):
        return None
    out: dict = {}
    for name, cast in REPORT_FIELDS.items():
        v = report.get(name)
        if v is None:
            continue
        try:
            if cast is bool:
                out[name] = bool(v)
            elif cast is str:
                s = str(v)[:32]
                if s:
                    out[name] = s
            elif cast is int:
                if isinstance(v, bool):
                    continue
                out[name] = int(v)
            else:
                v = float(v)
                if not math.isfinite(v):
                    # Belt and braces: a peer that DID ship a NaN through
                    # (python json accepts it) gets normalized to the
                    # null-plus-flag convention.
                    out[name] = None
                    out.setdefault(
                        "loss_finite" if name == "loss" else "grad_finite",
                        False)
                else:
                    out[name] = v
        except (TypeError, ValueError):
            continue
    return out if out else None


class ClusterMonitor:
    """Aggregates worker health reports + membership into alerts and a view.

    Thread-safety: ``ingest`` is called from gRPC handler threads on every
    reporting fetch/push; ``evaluate``/``cluster_view`` from the background
    tick, the HTTP endpoint (possibly many concurrent scrapes), and the
    serve loop. A single monitor lock guards the report table and the
    engine; every critical section is small and touches no store locks
    other than the registration lock inside ``membership_snapshot``.
    """

    def __init__(self, store, thresholds: HealthThresholds | None = None,
                 interval: float = 5.0, role: str = "server",
                 emit_stream: bool = False, registry=None,
                 clock=time.time):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.store = store
        self.interval = float(interval)
        self.role = role
        self.emit_stream = emit_stream
        self.clock = clock
        self.engine = HealthRuleEngine(thresholds)
        self._lock = threading.Lock()
        # Serializes whole evaluation passes (the engine is stateful and
        # the push-delta accounting is read-modify-write); concurrent
        # /cluster scrapes queue here briefly instead of corrupting state.
        self._eval_lock = threading.Lock()
        self._reports: dict[int, tuple[dict, float]] = {}  # guarded by: self._lock
        self._expired_pending: list[int] = []  # guarded by: self._lock
        self._started_ts = clock()
        self._seq = 0  # guarded by: self._lock
        self._last_events: list[dict] = []  # guarded by: self._lock
        # Staleness-spike measurement window, anchored in TIME — (start_ts,
        # accepted_total, rejected_total at start). Rolled at most once per
        # monitor interval, NOT per evaluation: /healthz and /cluster each
        # trigger an evaluation, and a 2 s readiness probe consuming the
        # window per scrape would slice it so thin the spike rule could
        # never accumulate staleness_min_pushes.
        self._push_window: tuple[float, int, int] = \
            (clock(), *self._push_totals())
        # Corrupt-frame refusals (wire CRC, comms/service.py): a running
        # total fed by note_corrupt_frame, windowed exactly like the push
        # deltas so the wire_corrupt alert holds for a full monitor
        # interval rather than the single scrape that drained it.
        self._corrupt_total = 0  # guarded by: self._lock
        self._corrupt_window: tuple[float, int] = (clock(), 0)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Alert edge-event listeners (the remediation engine attaches
        # here, docs/ROBUSTNESS.md): called with each non-empty batch of
        # events after an evaluation pass. Listener failures are
        # swallowed — acting on alerts must not break detecting them.
        self._listeners: list = []  # guarded by: self._lock
        #: Optional RemediationEngine; when set, cluster_view() carries
        #: its state under "remediation" (cli serve --remediate wires it).
        self.remediation = None
        #: Optional sharding state (ps/sharding.py ShardInfo); when set,
        #: cluster_view() carries shard identity, the live shard map
        #: version, and per-replica lag under "sharding" (cli serve
        #: --shard-count wires it) — the surface the remediation engine
        #: and `cli status` read to act on a lagging replica.
        self.sharding = None
        #: Optional ReplicaAutoscaler (telemetry/autoscale.py); when set,
        #: the background tick drives its control loop and
        #: cluster_view() carries its state under "autoscale" (cli serve
        #: --autoscale wires it).
        self.autoscaler = None
        #: Optional SloEvaluator (telemetry/slo.py); when set, every
        #: evaluation pass folds its burn-rate breaches into the
        #: ClusterState (-> slo_burn_fast/slo_burn_slow alerts) and
        #: cluster_view() carries its state under "slo" (cli serve
        #: wires it unless --no-slo).
        self.slo = None
        #: Optional JobManager (ps/tenancy.py); when set, membership and
        #: last_seen come from the UNION of every job's store (global,
        #: strided worker ids), worker rows carry a "job" column, and
        #: cluster_view() serves the per-job block under "jobs" (cli
        #: serve --jobs wires it).
        self.jobs = None
        #: Optional WorkerAutoscaler (telemetry/remediation.py); when
        #: set, the background tick drives its control loop and
        #: cluster_view() carries its state under "worker_autoscale".
        self.worker_autoscaler = None
        #: Optional MemoryMonitor (telemetry/memory.py); when set, every
        #: evaluation pass folds its self-paced sample verdict into the
        #: ClusterState (-> memory_growth alerts) and cluster_view()
        #: carries it under "memory" (cli serve wires it unless
        #: --no-memory-telemetry).
        self.memory = None
        #: Optional ProfileTrigger (telemetry/proftrigger.py); when set,
        #: every evaluation feeds it the fleet-merged goodput fraction so
        #: a goodput-drop edge freezes a device-profile window (cli serve
        #: --profile-triggers). Its slo_burn edge source attaches via
        #: add_listener separately.
        self.profile_trigger = None

        reg = registry or get_registry()
        # Alert counters pre-created for every rule so a scrape shows the
        # full rule vocabulary at zero, not a table that grows as things
        # break (docs/OBSERVABILITY.md).
        self._tm_alerts = {
            rule: reg.counter("dps_alerts_total", rule=rule, severity=sev)
            for rule, (sev, _) in RULE_CATALOG.items()
        }
        self._tm_reports = reg.counter("dps_cluster_reports_total")
        self._tm_workers = reg.gauge("dps_cluster_workers")
        self._tm_active = reg.gauge("dps_cluster_alerts_active")
        # Value-scale (log) buckets — the satellite scheme added for
        # loss/grad-norm magnitudes (telemetry/registry.py VALUE_BUCKETS).
        self._tm_loss = reg.histogram("dps_cluster_report_loss",
                                      buckets=VALUE_BUCKETS)
        self._tm_grad = reg.histogram("dps_cluster_report_grad_norm",
                                      buckets=VALUE_BUCKETS)

    # -- write side ----------------------------------------------------------

    def ingest(self, worker_id, report) -> bool:
        """Record one worker's wire health report. Returns True when the
        report was usable. Never raises (handler hot path)."""
        try:
            wid = int(worker_id)
        except (TypeError, ValueError):
            return False
        clean = sanitize_report(report)
        if clean is None:
            return False
        now = self.clock()
        with self._lock:
            prev = self._reports.get(wid)
            self._reports[wid] = (clean, now)
        self._tm_reports.inc()
        # The worker rebuilds its report at push boundaries but EVERY
        # fetch/push/heartbeat carries the current one, so the same values
        # arrive once per RPC. Only a changed report feeds the value
        # histograms — otherwise their distributions are weighted by each
        # worker's RPC rate (slow-pushing fast-pinging workers dominate),
        # not by actual training observations.
        if prev is None or prev[0] != clean:
            loss, gn = clean.get("loss"), clean.get("grad_norm")
            if isinstance(loss, (int, float)):
                self._tm_loss.observe(loss)
            if isinstance(gn, (int, float)):
                self._tm_grad.observe(gn)
        return True

    def note_corrupt_frame(self, n: int = 1) -> None:
        """Count one refused corrupt push frame (the service calls this
        beside ``dps_wire_corrupt_total``); feeds the ``wire_corrupt``
        health rule on the next evaluation pass."""
        with self._lock:
            self._corrupt_total += int(n)

    def note_expired(self, worker_ids) -> None:
        """Feed membership-expiry results (the serve loop already calls
        ``store.expire_stale_workers()`` every tick; it hands the reaped ids
        here so dead-worker alerts fire on the very next evaluation)."""
        if not worker_ids:
            return
        with self._lock:
            self._expired_pending.extend(int(w) for w in worker_ids)

    # -- evaluation ----------------------------------------------------------

    def _push_totals(self) -> tuple[int, int]:
        stats = getattr(self.store, "stats", None)
        return (int(getattr(stats, "gradients_processed", 0)),
                int(getattr(stats, "gradients_rejected", 0)))

    def _build_state(self, now: float) -> ClusterState:
        # Tenancy: the JobManager unions every job store's membership /
        # last_seen under GLOBAL strided worker ids, so one flat rule
        # engine covers all jobs.
        source = self.jobs if self.jobs is not None else self.store
        try:
            membership = list(source.membership_snapshot())
        except Exception:  # noqa: BLE001 — any store backend, any failure
            membership = []
        last_seen = dict(getattr(source, "last_seen", {}) or {})
        cfg = getattr(self.store, "config", None)
        with self._lock:
            reports = dict(self._reports)
            expired = self._expired_pending
            self._expired_pending = []
            corrupt_total = self._corrupt_total
            # A worker that left membership WITHOUT being expired finished
            # cleanly — drop its report so it neither alerts nor lingers
            # in the view. Expired workers keep theirs (the dead-worker
            # alert's evidence).
            dead = set(self.engine._dead) | set(expired)
            for wid in [w for w in self._reports
                        if w not in membership and w not in dead]:
                del self._reports[wid]
                reports.pop(wid, None)
        workers: dict[int, WorkerState] = {}
        for wid in set(membership) | set(reports) | set(expired):
            rep, rts = reports.get(wid, (None, 0.0))
            workers[wid] = WorkerState(
                worker_id=wid, report=rep, received_ts=rts,
                last_seen=float(last_seen.get(wid, 0.0)),
                in_membership=wid in membership)
        # Push-outcome deltas over the CURRENT window. The store counts
        # accepted pushes in gradients_processed and rejected ones ONLY in
        # gradients_rejected (ps/store.py:_push_async), so the two deltas
        # are independent — no cross-subtraction.
        acc, rej = self._push_totals()
        w_start, acc0, rej0 = self._push_window
        if now - w_start >= self.interval:
            self._push_window = (now, acc, rej)
        c_start, c0 = self._corrupt_window
        if now - c_start >= self.interval:
            self._corrupt_window = (now, corrupt_total)
        slo_breaches: list = []
        if self.slo is not None:
            try:
                slo_breaches = self.slo.evaluate(now)
            except Exception:  # noqa: BLE001 — SLO math must not stop health
                slo_breaches = []
        memory = None
        if self.memory is not None:
            try:
                memory = self.memory.observe(now)
            except Exception:  # noqa: BLE001 — sampling must not stop health
                memory = None
        return ClusterState(
            ts=now,
            global_step=int(getattr(self.store, "global_step", 0)),
            mode=getattr(cfg, "mode", "sync"),
            workers=workers,
            expired=expired,
            pushes_accepted_delta=max(0, acc - acc0),
            pushes_rejected_delta=max(0, rej - rej0),
            corrupt_frames_delta=max(0, corrupt_total - c0),
            slo_breaches=slo_breaches,
            memory=memory)

    def evaluate(self) -> list[dict]:
        """One evaluation pass; returns the new edge events. Serialized
        under the monitor lock (the engine is stateful); callers include
        the background tick, every ``/cluster``/``/healthz`` request, and
        tests."""
        with self._eval_lock:
            now = self.clock()
            state = self._build_state(now)
            with self._lock:
                events = self.engine.evaluate(state)
                active = self.engine.active_alerts()
            for ev in events:
                if ev["state"] in ("fired", "refired"):
                    counter = self._tm_alerts.get(ev["rule"])
                    if counter is not None:
                        counter.inc()
                self._record_event(ev)
                journal_event("alert",
                              **{k: v for k, v in ev.items()
                                 if v is not None})
            self._tm_workers.set(len([w for w in state.workers.values()
                                      if w.in_membership]))
            self._tm_active.set(len(active))
            if events:
                # Listener snapshot under the lock: an unguarded
                # list() raced add_listener's append from another
                # thread (remediation attaches mid-flight).
                with self._lock:
                    self._last_events.extend(events)
                    listeners = list(self._listeners)
                for fn in listeners:
                    try:
                        fn(events)
                    except Exception:  # noqa: BLE001
                        pass
            if self.profile_trigger is not None:
                fracs = [w.report.get("goodput_fraction")
                         for w in state.workers.values() if w.report]
                fracs = [f for f in fracs
                         if isinstance(f, (int, float))
                         and not isinstance(f, bool)]
                if fracs:
                    try:
                        # Fleet-merged productive fraction (mean of the
                        # reporting workers): a fall through the trigger's
                        # threshold captures a profile window.
                        self.profile_trigger.observe_goodput(
                            sum(fracs) / len(fracs), now=now)
                    except Exception:  # noqa: BLE001 — capture is best-effort
                        pass
            self._state_cache = state
            return events

    def add_listener(self, fn) -> None:
        """Subscribe to alert edge events: ``fn(events)`` is called after
        every evaluation pass that produced any (the remediation engine's
        intake; docs/ROBUSTNESS.md)."""
        with self._lock:
            self._listeners.append(fn)

    def _record_event(self, ev: dict) -> None:
        """Drop the alert event into the flight recorder, span-shaped so
        trace dumps and ``/debug/trace`` carry the alert history beside the
        spans a post-mortem already shows."""
        from .trace import get_recorder
        try:
            get_recorder().record({
                "name": "cluster.alert",
                "trace_id": os.urandom(8).hex(),
                "span_id": os.urandom(8).hex(),
                "parent_id": None,
                "ts": ev.get("last_ts") or self.clock(),
                "dur": 0.0,
                "role": self.role,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "attrs": {k: v for k, v in ev.items() if v is not None},
            })
        except Exception:  # noqa: BLE001 — recording must not hurt
            pass

    # -- read side -----------------------------------------------------------

    def active_alerts(self, evaluate: bool = True) -> list[dict]:
        if evaluate:
            self.evaluate()
        with self._lock:
            return [a.to_dict() for a in self.engine.active_alerts()]

    def has_critical(self) -> bool:
        return any(a["severity"] == "critical"
                   for a in self.active_alerts())

    def cluster_view(self, evaluate: bool = True) -> dict:
        """The JSON served at ``GET /cluster`` and embedded in the
        ``"kind": "cluster"`` stream records (docs/OBSERVABILITY.md)."""
        if evaluate:
            self.evaluate()
        now = self.clock()
        state = getattr(self, "_state_cache", None) \
            or self._build_state(now)
        with self._lock:
            alerts = [a.to_dict() for a in self.engine.active_alerts()]
        totals = {s: 0 for s in SEVERITIES}
        for a in alerts:
            totals[a["severity"]] = totals.get(a["severity"], 0) + 1
        rows = []
        for wid, ws in sorted(state.workers.items()):
            row: dict = {"worker": wid, "alive": ws.in_membership
                         and ("dead_worker", wid)
                         not in self.engine._active}
            if self.jobs is not None:
                row["job"] = self.jobs.job_name_of(wid)
            if ws.report:
                row.update(ws.report)
                row["report_age_s"] = round(max(0.0, now - ws.received_ts),
                                            3)
            if ws.last_seen:
                row["last_seen_age_s"] = round(max(0.0, now - ws.last_seen),
                                               3)
            rows.append(row)
        out = {
            "ts": round(now, 3),
            "role": self.role,
            "pid": os.getpid(),
            "mode": state.mode,
            "global_step": state.global_step,
            "uptime_seconds": round(now - self._started_ts, 3),
            "monitor_interval_s": self.interval,
            "workers": rows,
            "alerts": alerts,
            "alerts_total": totals,
        }
        gfs = [r.get("goodput_fraction") for r in rows]
        gfs = [f for f in gfs if isinstance(f, (int, float))
               and not isinstance(f, bool)]
        if gfs:
            # Fleet-merged productive fraction (mean over reporting
            # workers) — the `cli status` header goodput figure.
            out["goodput_fraction"] = round(sum(gfs) / len(gfs), 4)
        # Self-healing surfaces (docs/ROBUSTNESS.md): live quorum-round
        # state from the store and the remediation engine's active/recent
        # actions. Both best-effort — the health view must render even if
        # the healing layer breaks.
        rs = getattr(self.store, "round_status", None)
        if callable(rs) and state.mode == "sync":
            try:
                out["round"] = rs()
            except Exception:  # noqa: BLE001
                pass
        if self.remediation is not None:
            try:
                out["remediation"] = self.remediation.view()
            except Exception:  # noqa: BLE001
                pass
        if self.sharding is not None:
            try:
                out["sharding"] = self.sharding.view()
            except Exception:  # noqa: BLE001
                pass
        if self.autoscaler is not None:
            try:
                out["autoscale"] = self.autoscaler.view()
            except Exception:  # noqa: BLE001
                pass
        if self.slo is not None:
            try:
                out["slo"] = self.slo.view()
            except Exception:  # noqa: BLE001
                pass
        if self.memory is not None:
            try:
                out["memory"] = self.memory.observe(now)
            except Exception:  # noqa: BLE001
                pass
        if self.jobs is not None:
            try:
                out["jobs"] = self.jobs.view()
            except Exception:  # noqa: BLE001
                pass
        if self.worker_autoscaler is not None:
            try:
                out["worker_autoscale"] = self.worker_autoscaler.view()
            except Exception:  # noqa: BLE001
                pass
        return out

    # -- snapshot-stream record ---------------------------------------------

    def emit_once(self, stream=None) -> dict:
        """Emit one ``"kind": "cluster"`` METRICS_JSON record: the cluster
        view plus the edge events since the previous emit. Rides the same
        wire convention as the snapshot stream, so the existing log ETL
        collects cluster history for free
        (``analysis/parse_logs.py:parse_cluster_series``)."""
        from ..utils.metrics import emit_metrics_json
        view = self.cluster_view()
        with self._lock:
            self._seq += 1
            events, self._last_events = self._last_events, []
            payload = {"kind": "cluster", "seq": self._seq, **view,
                       "events": events}
        emit_metrics_json(payload, stream)
        return payload

    # -- background tick -----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                if self.emit_stream:
                    self.emit_once()
                else:
                    self.evaluate()
            except Exception:  # noqa: BLE001
                pass  # the monitor must never take the server down
            if self.autoscaler is not None:
                try:
                    self.autoscaler.tick()
                except Exception:  # noqa: BLE001
                    pass  # scaling must never take the server down
            if self.worker_autoscaler is not None:
                try:
                    self.worker_autoscaler.tick()
                except Exception:  # noqa: BLE001
                    pass

    def start(self) -> "ClusterMonitor":
        if self._thread is not None:
            raise RuntimeError("monitor already started")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cluster-monitor")
        self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, self.interval))
            self._thread = None
        if final and self.emit_stream:
            try:
                self.emit_once()
            except Exception:  # noqa: BLE001 — shutdown path must not raise
                pass


# -- process-global handle (the HTTP endpoint needs one) ----------------------

_MONITOR: ClusterMonitor | None = None
_MONITOR_LOCK = threading.Lock()


def set_cluster_monitor(monitor: ClusterMonitor | None) -> None:
    """Register the process's monitor for the ``/cluster`` endpoint and the
    ``/healthz`` readiness check (``cli serve`` wires this)."""
    global _MONITOR
    with _MONITOR_LOCK:
        _MONITOR = monitor


def get_cluster_monitor() -> ClusterMonitor | None:
    with _MONITOR_LOCK:
        return _MONITOR
