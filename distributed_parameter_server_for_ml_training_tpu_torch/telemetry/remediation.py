"""Remediation policy engine: cluster alerts -> self-healing actions.

The JAX package's ``telemetry/remediation.py``, carried over with the
port's registry, journal and flight recorder. The
:class:`~.cluster.ClusterMonitor` is the *detect* half of the loop — a
``dead_worker`` alert fires, lands in ``/cluster``, and would then sit
there while the sync round keeps waiting on the corpse. This module is
the *act* half (docs/ROBUSTNESS.md "Self-healing"): it listens to the
monitor's alert edge events and maps rule firings to concrete actions
through a fixed, drift-pinned action catalog:

- ``dead_worker`` -> **respawn**: the process restart itself belongs to
  the :class:`~..ps.supervisor.WorkerSupervisor` colocated with the worker
  (it sees the child die within its poll interval); the server-side engine
  records the request so ``/cluster`` shows the loop closing end to end.
- ``straggler_lag`` -> **quorum_exclude** (the store stops sizing sync
  rounds to include the laggard, ``ps/store.py:exclude_worker``) +
  **rebalance** (a ``rebalance_shard`` directive so the cluster resharding
  covers the work it is no longer keeping up with).
- ``nonfinite_loss``/``nonfinite_grad`` -> **quarantine** (the service
  refuses the worker's pushes server-side — even a legacy peer can't
  poison the aggregate — and a ``quarantine`` directive tells capable
  workers to pause pushing and reset error-feedback residuals) +
  **refetch** (a ``refetch_params`` directive: drop the possibly-poisoned
  local basis, take a full fresh fetch).

Alert *resolution* lifts what it caused: a resolved ``straggler_lag``
re-includes the worker, a resolved non-finite alert unquarantines it.

Discipline, in the monitor's image: actions are **rate-limited** per
(action, worker) pair (``cooldown_s``), **dry-runnable** (compute and
record everything, touch nothing), and every decision is a stateful
**remediation event** — counted in
``dps_remediation_actions_total{action,outcome}``, dropped into the flight
recorder as a ``cluster.remediation`` record, embedded in the
``"kind": "cluster"`` stream via the monitor's view, and served live in
``GET /cluster`` under ``"remediation"``. The engine never raises into the
monitor: remediating a cluster must not be able to take its server down.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .journal import journal_event
from .registry import get_registry

__all__ = [
    "ACTION_CATALOG",
    "ACTION_OUTCOMES",
    "DEFAULT_POLICY_RULES",
    "RemediationEngine",
    "RemediationPolicy",
    "WorkerAutoscalePolicy",
    "WorkerAutoscaler",
    "note_action",
]

#: action name -> one-line meaning. A wire/doc contract like rule and
#: directive names: docs/ROBUSTNESS.md documents exactly these rows and
#: ``tests/test_docs_drift.py`` pins the two to each other both
#: directions. ``dps_remediation_actions_total`` label values come from
#: this table (plus the supervisor's own ``respawn`` increments).
ACTION_CATALOG = {
    "respawn": "restart a dead worker's process — executed by the "
               "supervisor watching it; the server-side engine records "
               "the request (outcome `delegated`)",
    "quorum_exclude": "drop a straggler from the sync round target so "
                      "rounds stop waiting for it (its pushes still "
                      "land; late ones reconcile via staleness)",
    "rebalance": "post a `rebalance_shard` directive: finish the epoch "
                 "early and reshard from live membership",
    "quarantine": "refuse the worker's pushes server-side and post a "
                  "`quarantine` directive (pause pushes, reset error "
                  "feedback)",
    "refetch": "post a `refetch_params` directive: drop the delta "
               "basis, take a full fresh fetch",
    "replica_grow": "spawn one read replica — decided by the "
                    "autoscaler (telemetry/autoscale.py) from windowed "
                    "fetch QPS, executed by the ReplicaPool",
    "replica_shrink": "retire the youngest read replica when fetch "
                      "load stays under the low-water mark and no "
                      "replica lags",
    "worker_grow": "add one worker slot for a job whose admission "
                   "queue depth / straggler pressure stays high — "
                   "decided by the WorkerAutoscaler, executed by the "
                   "WorkerSupervisor colocated with the workers "
                   "(outcome `delegated` when recorded server-side)",
    "worker_shrink": "retire a job's youngest worker slot once "
                     "pressure stays under the low-water mark for the "
                     "full sustain window",
}

#: Every outcome an action decision can record. Counters are pre-created
#: for the full action x outcome grid so scrapes show the vocabulary at
#: zero (the ``dps_alerts_total`` discipline).
ACTION_OUTCOMES = ("ok", "delegated", "dry_run", "rate_limited",
                   "skipped", "error", "lifted", "crash_loop")

#: rule -> actions, the default policy table (docs/ROBUSTNESS.md).
DEFAULT_POLICY_RULES = {
    "dead_worker": ("respawn",),
    "straggler_lag": ("quorum_exclude", "rebalance"),
    "nonfinite_loss": ("quarantine", "refetch"),
    "nonfinite_grad": ("quarantine", "refetch"),
}

#: Remediation events kept for the `/cluster` view.
EVENTS_KEPT = 256


def note_action(action: str, outcome: str, registry=None) -> None:
    """Count one remediation action outcome. The ONE place the metric
    name lives, shared by the server-side engine and the worker-process
    supervisor (which executes ``respawn`` where the process actually
    lives)."""
    reg = registry or get_registry()
    reg.counter("dps_remediation_actions_total", action=action,
                outcome=outcome).inc()
    journal_event("respawn" if action == "respawn" else "remediation",
                  action=action, outcome=outcome)


@dataclass
class RemediationPolicy:
    """Engine knobs (defaults documented in docs/ROBUSTNESS.md)."""

    #: Compute and record every decision; execute nothing.
    dry_run: bool = False
    #: Minimum seconds between repeated decisions for the same
    #: (action, worker) pair — an alert that refires every evaluation
    #: produces one action per cooldown, not one per tick.
    cooldown_s: float = 30.0
    #: Hard cap on actions executed per event batch.
    max_actions_per_batch: int = 8
    #: Server-side push-refusal window for the quarantine action.
    quarantine_s: float = 30.0
    #: Boundary windows the quarantine directive tells the worker to skip.
    quarantine_steps: int = 3
    #: rule -> tuple of action names (see :data:`DEFAULT_POLICY_RULES`).
    rules: dict = field(default_factory=lambda: dict(DEFAULT_POLICY_RULES))


class RemediationEngine:
    """Maps alert edge events to actions against the store + service.

    Attach with ``monitor.add_listener(engine.handle_events)`` (and
    ``monitor.remediation = engine`` so ``cluster_view`` carries the
    remediation state). ``handle_events`` runs on whatever thread
    evaluated the monitor — it must stay cheap and must never raise.
    """

    def __init__(self, store, service=None,
                 policy: RemediationPolicy | None = None,
                 clock=time.time, registry=None, role: str = "server"):
        self.store = store
        self.service = service
        self.policy = policy or RemediationPolicy()
        self.clock = clock
        self.role = role
        self._lock = threading.Lock()
        self._last_action: dict[tuple, float] = {}  # guarded by: self._lock
        #: (action, worker) -> the event dict that activated it; an entry
        #: here is an ACTIVE remediation (shown in /cluster, lifted on
        #: alert resolution).
        self._active: dict[tuple, dict] = {}  # guarded by: self._lock
        self.events: deque = deque(maxlen=EVENTS_KEPT)  # guarded by: self._lock
        reg = registry or get_registry()
        self._tm = {
            (a, o): reg.counter("dps_remediation_actions_total",
                                action=a, outcome=o)
            for a in ACTION_CATALOG for o in ACTION_OUTCOMES
        }

    # -- event intake ---------------------------------------------------------

    def handle_events(self, events) -> list[dict]:
        """Consume one batch of monitor edge events; returns the
        remediation events recorded. Never raises."""
        out: list[dict] = []
        try:
            budget = self.policy.max_actions_per_batch
            for ev in events or []:
                state = ev.get("state")
                rule = ev.get("rule")
                worker = ev.get("worker")
                actions = self.policy.rules.get(rule) or ()
                if state in ("fired", "refired"):
                    for action in actions:
                        if budget <= 0:
                            break
                        rec = self._act(action, rule, worker)
                        if rec is not None:
                            out.append(rec)
                            if rec["outcome"] not in ("rate_limited",):
                                budget -= 1
                elif state == "resolved":
                    for action in actions:
                        rec = self._lift(action, rule, worker)
                        if rec is not None:
                            out.append(rec)
        except Exception:  # noqa: BLE001 — remediation must not hurt
            pass
        return out

    # -- decisions ------------------------------------------------------------

    def _act(self, action: str, rule: str, worker) -> dict | None:
        now = self.clock()
        key = (action, worker)
        with self._lock:
            last = self._last_action.get(key)
            limited = (last is not None
                       and now - last < self.policy.cooldown_s)
            if not limited:
                self._last_action[key] = now
        if limited:
            return self._record(action, rule, worker, "rate_limited", now)
        if self.policy.dry_run:
            rec = self._record(action, rule, worker, "dry_run", now)
        else:
            try:
                outcome = self._execute(action, worker)
            except Exception as e:  # noqa: BLE001
                rec = self._record(action, rule, worker, "error", now,
                                   detail=repr(e))
                return rec
            rec = self._record(action, rule, worker, outcome, now)
        if rec["outcome"] in ("ok", "delegated", "dry_run"):
            with self._lock:
                self._active[key] = rec
        return rec

    def _execute(self, action: str, worker) -> str:
        store, svc = self.store, self.service
        if action == "respawn":
            # Process restarts belong to the supervisor colocated with
            # the worker (ps/supervisor.py detects the death itself and
            # counts its own respawn outcome); the server records the
            # request so the healing loop is visible end to end.
            return "delegated"
        if worker is None:
            return "skipped"
        if action == "quorum_exclude":
            fn = getattr(store, "exclude_worker", None)
            if not callable(fn):
                return "skipped"  # backend without quorum rounds
            fn(worker)
            return "ok"
        if action == "rebalance":
            if svc is None:
                return "skipped"
            seq = svc.post_directive(worker, "rebalance_shard")
            return "ok" if seq is not None else "skipped"  # legacy peer
        if action == "quarantine":
            if svc is None:
                return "skipped"
            svc.quarantine(worker, self.policy.quarantine_s)
            # The directive half is best-effort: a legacy peer can't
            # hear it, but the server-side refusal above already holds.
            svc.post_directive(worker, "quarantine",
                               steps=self.policy.quarantine_steps)
            return "ok"
        if action == "refetch":
            if svc is None:
                return "skipped"
            seq = svc.post_directive(worker, "refetch_params")
            return "ok" if seq is not None else "skipped"
        return "skipped"

    def _lift(self, action: str, rule: str, worker) -> dict | None:
        key = (action, worker)
        with self._lock:
            active = self._active.pop(key, None)
            if active is None:
                return None
        if not self.policy.dry_run:
            try:
                if action == "quorum_exclude":
                    fn = getattr(self.store, "include_worker", None)
                    if callable(fn) and worker is not None:
                        fn(worker)
                elif action == "quarantine" and self.service is not None \
                        and worker is not None:
                    self.service.unquarantine(worker)
            except Exception:  # noqa: BLE001
                pass
        return self._record(action, rule, worker, "lifted", self.clock())

    # -- recording ------------------------------------------------------------

    def _record(self, action: str, rule: str, worker, outcome: str,
                ts: float, detail: str | None = None) -> dict:
        rec = {"ts": round(ts, 3), "action": action, "rule": rule,
               "worker": worker, "outcome": outcome,
               "dry_run": self.policy.dry_run}
        if detail:
            rec["detail"] = detail
        counter = self._tm.get((action, outcome))
        if counter is not None:
            counter.inc()
        with self._lock:
            self.events.append(rec)
        self._flight_record(rec)
        if outcome != "rate_limited":
            print(f"REMEDIATION action={action} rule={rule} "
                  f"worker={worker} outcome={outcome}", flush=True)
        return rec

    def _flight_record(self, rec: dict) -> None:
        """Span-shaped ``cluster.remediation`` record beside the
        ``cluster.alert`` ones, so post-mortem dumps and ``/debug/trace``
        carry the action history too."""
        from .trace import get_recorder
        try:
            get_recorder().record({
                "name": "cluster.remediation",
                "trace_id": os.urandom(8).hex(),
                "span_id": os.urandom(8).hex(),
                "parent_id": None,
                "ts": rec["ts"],
                "dur": 0.0,
                "role": self.role,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "attrs": {k: v for k, v in rec.items() if v is not None},
            })
        except Exception:  # noqa: BLE001
            pass

    # -- read side ------------------------------------------------------------

    def view(self) -> dict:
        """The ``"remediation"`` block of ``GET /cluster``
        (docs/ROBUSTNESS.md)."""
        with self._lock:
            active = sorted(self._active.values(),
                            key=lambda r: (r["action"],
                                           -1 if r["worker"] is None
                                           else r["worker"]))
            recent = list(self.events)[-32:]
        out = {
            "dry_run": self.policy.dry_run,
            "cooldown_s": self.policy.cooldown_s,
            "policy": {rule: list(actions)
                       for rule, actions in self.policy.rules.items()},
            "active": active,
            "recent": recent,
        }
        svc = self.service
        if svc is not None:
            try:
                q = svc.quarantine_view()
                if q:
                    out["quarantined"] = {str(w): s for w, s in q.items()}
            except Exception:  # noqa: BLE001
                pass
        return out


@dataclass
class WorkerAutoscalePolicy:
    """Per-job worker-scaling knobs (docs/TENANCY.md "Scaling policy").

    Same discipline as :class:`~.autoscale.AutoscalePolicy`, but the
    signal is QUEUE PRESSURE, not QPS: admission queue depth is spiky
    (one push storm fills it for a tick), so both directions require the
    condition to hold for ``sustain_ticks`` CONSECUTIVE ticks before
    acting — the hysteresis band plus the sustain window together keep a
    job hovering near one threshold from flapping its worker fleet.
    """

    #: Grow when the job's admission queue depth (waiting RPCs) exceeds
    #: this for ``sustain_ticks`` consecutive ticks — or when any of the
    #: job's workers holds an active straggler alert.
    depth_high: float = 4.0
    #: Shrink when depth stays below this (and no straggler pressure)
    #: for the full sustain window. Must sit under ``depth_high``.
    depth_low: float = 1.0
    #: Consecutive ticks a condition must hold before it acts.
    sustain_ticks: int = 3
    min_workers: int = 1
    max_workers: int = 4
    #: Minimum seconds between consecutive scaling actions.
    cooldown_s: float = 15.0
    #: Compute and record every decision; touch the supervisor never.
    dry_run: bool = False

    def __post_init__(self):
        if self.depth_low >= self.depth_high:
            raise ValueError(f"depth_low ({self.depth_low}) must be < "
                             f"depth_high ({self.depth_high})")
        if not 0 <= self.min_workers <= self.max_workers:
            raise ValueError(f"need 0 <= min ({self.min_workers}) <= "
                             f"max ({self.max_workers})")
        if self.sustain_ticks < 1:
            raise ValueError(f"sustain_ticks must be >= 1, "
                             f"got {self.sustain_ticks}")


class WorkerAutoscaler:
    """Queue-pressure policy head scaling ONE job's worker count.

    ``pressure_fn() -> dict`` supplies the signals (``queue_depth``,
    ``stragglers``, and — when no actuator is attached — ``workers``);
    ``cli supervise --autoscale-job`` builds one that polls the server's
    ``GET /cluster`` jobs block, and tests inject a fake. The EXECUTE
    half is ``supervisor.grow()/shrink()/count()``
    (:class:`~..ps.supervisor.WorkerSupervisor` slot add/remove); with
    ``supervisor=None`` the autoscaler is a server-side policy recorder
    — decisions land with outcome ``delegated`` (the remediation
    engine's respawn idiom: the process restart belongs to the
    supervisor colocated with the workers).
    """

    def __init__(self, job: str, pressure_fn, supervisor=None,
                 policy: WorkerAutoscalePolicy | None = None,
                 registry=None, clock=time.time):
        self.job = str(job)
        self.pressure_fn = pressure_fn
        self.supervisor = supervisor
        self.policy = policy or WorkerAutoscalePolicy()
        self.clock = clock
        self._reg = registry or get_registry()
        self._lock = threading.Lock()
        # Consecutive ticks the grow/shrink condition held.
        self._hot = 0    # guarded by: self._lock
        self._cold = 0   # guarded by: self._lock
        # -inf: the first action is never cooldown-held.
        self._last_action_ts = float("-inf")  # guarded by: self._lock
        self._events: deque = deque(maxlen=EVENTS_KEPT)  # guarded by: self._lock
        self.actions = {"worker_grow": 0, "worker_shrink": 0}
        self._tm_target = self._reg.gauge(
            "dps_job_autoscale_target_workers", job=self.job)

    def _live(self, signals: dict) -> int:
        if self.supervisor is not None:
            return int(self.supervisor.count())
        return int(signals.get("workers") or 0)

    def tick(self) -> dict | None:
        """One control pass; returns the decision record when one was
        made, None while pressure is in-band or still building its
        sustain window. Never raises (monitor-loop hosted)."""
        now = self.clock()
        try:
            signals = dict(self.pressure_fn() or {})
        except Exception:  # noqa: BLE001 — a poll miss is not a crash
            return None
        depth = float(signals.get("queue_depth") or 0.0)
        stragglers = int(signals.get("stragglers") or 0)
        live = self._live(signals)
        p = self.policy
        with self._lock:
            if depth > p.depth_high or stragglers > 0:
                self._hot += 1
                self._cold = 0
            elif depth < p.depth_low:
                self._cold += 1
                self._hot = 0
            else:
                self._hot = self._cold = 0
            hot, cold = self._hot, self._cold
        action = None
        if live < p.min_workers:
            action = "worker_grow"  # floor breach: act NOW, no sustain
        elif hot >= p.sustain_ticks and live < p.max_workers:
            action = "worker_grow"
        elif cold >= p.sustain_ticks and live > p.min_workers:
            action = "worker_shrink"
        if action is None:
            self._tm_target.set(live)
            return None
        with self._lock:
            if now - self._last_action_ts < p.cooldown_s:
                outcome = "rate_limited"
            elif p.dry_run:
                outcome = "dry_run"
            else:
                self._last_action_ts = now
                outcome = ("ok" if self.supervisor is not None
                           else "delegated")
                # An executed decision spends the sustain window; the
                # pressure must rebuild before the next one.
                self._hot = self._cold = 0
        if outcome == "ok":
            try:
                if action == "worker_grow":
                    self.supervisor.grow()
                    live += 1
                elif self.supervisor.shrink() is not None:
                    live -= 1
            except Exception:  # noqa: BLE001 — a failed spawn is an
                outcome = "error"  # outcome, not a host-loop crash
        self._tm_target.set(live)
        note_action(action, outcome, registry=self._reg)
        if outcome in ("ok", "delegated"):
            self.actions[action] += 1
        event = {"ts": round(now, 3), "job": self.job, "action": action,
                 "outcome": outcome, "queue_depth": round(depth, 1),
                 "stragglers": stragglers, "live": live}
        with self._lock:
            self._events.append(event)
        print(f"WORKER_AUTOSCALE job={self.job} action={action} "
              f"outcome={outcome} depth={depth:.1f} live={live}",
              flush=True)
        return event

    def view(self) -> dict:
        with self._lock:
            events = list(self._events)
            hot, cold = self._hot, self._cold
        return {"job": self.job,
                "min": self.policy.min_workers,
                "max": self.policy.max_workers,
                "depth_high": self.policy.depth_high,
                "depth_low": self.policy.depth_low,
                "sustain_ticks": self.policy.sustain_ticks,
                "hot_ticks": hot, "cold_ticks": cold,
                "dry_run": self.policy.dry_run,
                "actions": dict(self.actions),
                "events": events[-16:]}
