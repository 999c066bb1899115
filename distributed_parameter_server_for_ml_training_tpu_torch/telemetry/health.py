"""Training-quality rule engine: worker health reports -> structured alerts.

The JAX package's ``telemetry/health.py``, carried over whole (it is
framework-neutral). A process that is merely *slow* is visible in the
registry; nothing there says whether training is *working* — a NaN loss,
a diverging run, or a silently stalled worker. This module is the
decision half of the cluster health subsystem (docs/OBSERVABILITY.md):
:class:`~.cluster.ClusterMonitor` aggregates per-worker health reports
with the store's membership state into a :class:`ClusterState`, and
:class:`HealthRuleEngine` evaluates the fixed rule catalog below against
it, emitting **deduplicated, rate-limited** alert events.

Design constraints:

- **Fixed rule catalog.** Rule names are a wire/doc contract exactly like
  metric and span names: :data:`RULE_CATALOG` is the single source of truth,
  pinned to docs/OBSERVABILITY.md both directions by
  ``tests/test_docs_drift.py``. Thresholds are configurable
  (:class:`HealthThresholds`); the *names and severities* are not.
- **Alerts are stateful, not log lines.** A condition FIRES once when it
  starts holding, stays in the active set while it holds (re-emitting at
  most every ``realert_interval_s``), and RESOLVES once when it stops.
  Consumers (``/cluster``, ``cli status``, the flight recorder, the
  ``"kind": "cluster"`` stream) therefore see edge events plus a live
  active set, never a firehose of one alert per evaluation tick.
- **Never trust a report.** Reports cross the wire from arbitrary peers;
  every field access degrades (missing/garbled -> ignored), and evaluation
  never raises — a malformed report must not take down the server's
  monitoring, let alone the server.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

__all__ = [
    "RULE_CATALOG",
    "SEVERITIES",
    "Alert",
    "ClusterState",
    "HealthRuleEngine",
    "HealthThresholds",
    "WorkerState",
]

#: Alert severities, most severe first. ``critical`` drives the ``/healthz``
#: readiness flip (503) and the nonzero ``cli status`` exit code.
SEVERITIES = ("critical", "warning", "info")

#: rule name -> (severity, one-line meaning). The contract table —
#: docs/OBSERVABILITY.md documents exactly these rows and
#: ``tests/test_docs_drift.py`` pins the two to each other both directions.
RULE_CATALOG = {
    "nonfinite_loss": (
        "critical", "a worker reported a NaN/Inf training loss"),
    "nonfinite_grad": (
        "critical", "a worker reported a NaN/Inf gradient global-norm"),
    "dead_worker": (
        "critical", "a worker stopped reporting/pinging (membership expiry "
                    "or report age past dead_after_s) without JobFinished"),
    "grad_explosion": (
        "warning", "gradient global-norm above grad_explosion_factor x the "
                   "worker's rolling median (or the absolute ceiling)"),
    "loss_divergence": (
        "warning", "loss above loss_divergence_factor x the worker's best "
                   "loss after a warmup of reports"),
    "worker_stall": (
        "warning", "a worker's step stopped advancing for stall_after_s "
                   "while the cluster's global step kept moving"),
    "staleness_spike": (
        "warning", "rejected-push fraction over the evaluation window above "
                   "staleness_reject_ratio (async staleness gate thrashing)"),
    "wire_corrupt": (
        "warning", "a push payload failed the wire CRC check this window "
                   "and was refused (dps_wire_corrupt_total)"),
    "memory_growth": (
        "warning", "host RSS grew faster than memory_growth_bytes_per_s "
                   "over the sampling window (telemetry/memory.py leak "
                   "slope; an OOM in the making)"),
    "loss_plateau": (
        "info", "best loss improved less than plateau_min_improvement over "
                "plateau_window_s of reports"),
    "straggler_lag": (
        "info", "a worker's reported step more than straggler_lag_steps "
                "behind the fastest reporting worker"),
    "slo_burn_fast": (
        "critical", "an SLO objective's fast-window error-budget burn rate "
                    "crossed its threshold (telemetry/slo.py; budget gone "
                    "in hours at this rate)"),
    "slo_burn_slow": (
        "warning", "an SLO objective's slow-window error-budget burn rate "
                   "crossed its threshold (sustained budget bleed)"),
}


@dataclass
class HealthThresholds:
    """Default detector thresholds (documented in docs/OBSERVABILITY.md).

    Chosen for the CIFAR-scale runs this repo records: conservative enough
    that a healthy control run fires nothing (pinned by the recorded demo),
    tight enough that the seeded faults fire within one heartbeat interval.
    """

    grad_explosion_factor: float = 10.0
    #: Absolute grad-norm backstop: fires grad_explosion even before a
    #: rolling median exists.
    grad_norm_ceiling: float = 1e6
    #: Reports needed before the rolling-median explosion check engages.
    grad_median_warmup: int = 5
    loss_divergence_factor: float = 3.0
    loss_divergence_warmup: int = 5
    plateau_window_s: float = 300.0
    plateau_min_improvement: float = 1e-3
    stall_after_s: float = 30.0
    straggler_lag_steps: int = 100
    staleness_reject_ratio: float = 0.5
    #: Minimum pushes in the window before the spike ratio is meaningful.
    staleness_min_pushes: int = 8
    #: A worker whose newest report/liveness is older than this while the
    #: cluster is otherwise alive is declared dead (membership expiry
    #: reported by the store fires the same rule immediately).
    dead_after_s: float = 30.0
    #: Sustained host-RSS growth slope above this fires memory_growth
    #: (8 MiB/s leaks a v4 host's 400-ish GB in under a day — early
    #: enough to act, far above healthy allocator jitter).
    memory_growth_bytes_per_s: float = 8388608.0
    #: The slope is meaningless over a blip: the sampling window must
    #: span at least this long and hold this many samples first.
    memory_growth_min_window_s: float = 20.0
    memory_growth_min_samples: int = 5
    #: Re-emit cooldown per (rule, worker): an alert that KEEPS firing
    #: produces at most one event per interval (dedupe/rate-limit).
    realert_interval_s: float = 60.0
    #: Hard cap on fresh fire events per evaluation pass.
    max_alerts_per_eval: int = 16


@dataclass
class WorkerState:
    """One worker's slice of a :class:`ClusterState`."""

    worker_id: int
    report: dict | None = None
    #: When the newest report arrived (monitor clock).
    received_ts: float = 0.0
    #: Store-side liveness (``last_seen`` from fetch/push/ping), 0 if unknown.
    last_seen: float = 0.0
    in_membership: bool = True


@dataclass
class ClusterState:
    """Everything one evaluation pass sees. Built by ClusterMonitor."""

    ts: float
    global_step: int = 0
    mode: str = "sync"
    workers: dict[int, WorkerState] = field(default_factory=dict)
    #: Worker ids the membership layer expired since the last pass.
    expired: list[int] = field(default_factory=list)
    #: Push outcome deltas since the last pass (async staleness gate).
    pushes_accepted_delta: int = 0
    pushes_rejected_delta: int = 0
    #: Corrupt push frames REFUSED over the evaluation window (wire CRC
    #: trailer, comms/service.py) — any nonzero value alerts.
    corrupt_frames_delta: int = 0
    #: SLO burn-rate breaches from the attached SloEvaluator this pass
    #: (telemetry/slo.py ``evaluate()`` dicts); empty when no evaluator.
    slo_breaches: list = field(default_factory=list)
    #: Memory verdict from the attached MemoryMonitor
    #: (telemetry/memory.py ``observe()`` dict); None when no monitor.
    memory: dict | None = None


@dataclass
class Alert:
    """A firing condition: identity (rule, worker), evidence, lifecycle."""

    rule: str
    severity: str
    worker: int | None
    message: str
    value: float | None = None
    threshold: float | None = None
    first_ts: float = 0.0
    last_ts: float = 0.0
    #: Evaluation passes this alert has been continuously firing.
    count: int = 1

    def key(self) -> tuple:
        return (self.rule, self.worker)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity,
            "worker": self.worker, "message": self.message,
            "value": self.value, "threshold": self.threshold,
            "since": round(self.first_ts, 3),
            "last_ts": round(self.last_ts, 3), "count": self.count,
        }


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


class _WorkerTrack:
    """Per-worker rolling history the detectors read (engine-private)."""

    __slots__ = ("grad_norms", "best_loss", "best_loss_ts", "first_report_ts",
                 "reports", "last_report_ts", "last_step",
                 "last_step_change_ts", "step_at_last_change")

    def __init__(self):
        self.grad_norms: deque = deque(maxlen=32)
        self.best_loss: float | None = None
        self.best_loss_ts: float = 0.0
        self.first_report_ts: float = 0.0
        self.reports = 0
        #: received_ts of the newest report folded into the history above.
        #: Evaluation frequency is set by /healthz + /cluster scrape rates,
        #: not report arrival (the same report is re-seen many times), so
        #: warmup counts and the grad-norm median window only advance on a
        #: report NEWER than this — a 2 s readiness probe must not rush a
        #: 5-report warmup in 10 s or flood the median with duplicates.
        self.last_report_ts: float = 0.0
        self.last_step: int | None = None
        self.last_step_change_ts: float = 0.0
        #: Cluster global step when this worker's step last advanced — the
        #: stall rule only fires if the CLUSTER moved since (a fully idle
        #: cluster, e.g. between epochs, is not N stalled workers).
        self.step_at_last_change: int = 0


class HealthRuleEngine:
    """Evaluates :data:`RULE_CATALOG` against successive cluster states.

    Stateful: keeps per-worker rolling history (for median/best-loss/stall
    tracking) and the active-alert set (for dedupe + resolution). One engine
    per monitor; ``evaluate`` is called under the monitor's lock, so no
    internal locking here.
    """

    def __init__(self, thresholds: HealthThresholds | None = None):
        self.thresholds = thresholds or HealthThresholds()
        self._tracks: dict[int, _WorkerTrack] = {}
        self._active: dict[tuple, Alert] = {}
        self._last_emit: dict[tuple, float] = {}
        #: Workers currently considered dead -> when the latch was set.
        #: The expiry notice arrives once, but the alert must stay active
        #: until evidence NEWER than the latch shows the worker back (a
        #: fresh report, or a re-registration bumping last_seen) — a
        #: report from before the expiry must not resolve it.
        self._dead: dict[int, float] = {}

    # -- public surface ------------------------------------------------------

    def active_alerts(self) -> list[Alert]:
        order = {s: i for i, s in enumerate(SEVERITIES)}
        return sorted(self._active.values(),
                      key=lambda a: (order.get(a.severity, 9), a.rule,
                                     -1 if a.worker is None else a.worker))

    def evaluate(self, state: ClusterState) -> list[dict]:
        """One pass: returns the EDGE events (fired/resolved) this state
        produced; read the ongoing set from :meth:`active_alerts`."""
        firing = self._detect(state)
        now = state.ts
        events: list[dict] = []
        fired_budget = self.thresholds.max_alerts_per_eval
        for key, alert in firing.items():
            prev = self._active.get(key)
            if prev is None:
                if fired_budget <= 0:
                    # Burst cap: defer admission entirely — the condition
                    # still holds next pass and fires then (with its
                    # "fired" edge), rather than slipping into the active
                    # set eventless and surfacing as a refire-without-fire.
                    continue
                fired_budget -= 1
                alert.first_ts = now
                alert.last_ts = now
                self._active[key] = alert
                self._last_emit[key] = now
                events.append({"state": "fired", **alert.to_dict()})
            else:
                prev.last_ts = now
                prev.count += 1
                prev.message = alert.message
                prev.value = alert.value
                # Re-emit at most once per cooldown — a condition that
                # holds for an hour is one alert, not 720.
                if now - self._last_emit.get(key, 0.0) \
                        >= self.thresholds.realert_interval_s:
                    self._last_emit[key] = now
                    events.append({"state": "refired", **prev.to_dict()})
        for key in [k for k in self._active if k not in firing]:
            resolved = self._active.pop(key)
            self._last_emit.pop(key, None)
            resolved.last_ts = now
            events.append({"state": "resolved", **resolved.to_dict()})
        return events

    # -- detectors -----------------------------------------------------------

    def _detect(self, state: ClusterState) -> dict[tuple, Alert]:
        t = self.thresholds
        firing: dict[tuple, Alert] = {}

        def fire(rule: str, worker: int | None, message: str,
                 value=None, threshold=None) -> None:
            sev = RULE_CATALOG[rule][0]
            a = Alert(rule=rule, severity=sev, worker=worker,
                      message=message, value=value, threshold=threshold)
            firing.setdefault(a.key(), a)

        now = state.ts
        # Liveness bookkeeping first: expiry notices latch workers dead.
        for wid in state.expired:
            self._dead.setdefault(wid, now)
        reporting_steps: list[tuple[int, int]] = []

        for wid, ws in sorted(state.workers.items()):
            r = ws.report if isinstance(ws.report, dict) else None
            alive_ts = max(ws.received_ts, ws.last_seen)
            latch = self._dead.get(wid)
            if latch is not None and alive_ts > latch:
                del self._dead[wid]  # seen AFTER the latch: dead resolves
                latch = None
            if latch is not None:
                fire("dead_worker", wid,
                     f"worker {wid} expired from membership "
                     f"(no liveness for {now - alive_ts:.0f}s)",
                     value=round(now - alive_ts, 1),
                     threshold=t.dead_after_s)
                continue
            if alive_ts and now - alive_ts > t.dead_after_s \
                    and ws.in_membership:
                # Faithful-mode store never expires (SURVEY quirk 10): the
                # monitor still notices a silent worker by report age.
                fire("dead_worker", wid,
                     f"worker {wid} silent for {now - alive_ts:.0f}s "
                     f"(> {t.dead_after_s:.0f}s)",
                     value=round(now - alive_ts, 1),
                     threshold=t.dead_after_s)
                continue
            if r is None:
                continue

            track = self._tracks.setdefault(wid, _WorkerTrack())
            fresh = ws.received_ts > track.last_report_ts
            if fresh:
                if track.reports == 0:
                    track.first_report_ts = ws.received_ts
                track.reports += 1
                track.last_report_ts = ws.received_ts

            step = r.get("step")
            step = step if isinstance(step, int) \
                and not isinstance(step, bool) else None
            loss = r.get("loss")
            gnorm = r.get("grad_norm")
            loss_finite = bool(r.get("loss_finite", True))
            grad_finite = bool(r.get("grad_finite", True))

            # 1) non-finite signals (reports null the value and flag it, so
            # NaN never has to survive a JSON hop).
            if not loss_finite:
                fire("nonfinite_loss", wid,
                     f"worker {wid} reported a non-finite loss at step "
                     f"{step}")
            if not grad_finite:
                fire("nonfinite_grad", wid,
                     f"worker {wid} reported a non-finite gradient norm "
                     f"at step {step}")

            # 2) gradient explosion.
            if _finite(gnorm):
                med = None
                if len(track.grad_norms) >= t.grad_median_warmup:
                    s = sorted(track.grad_norms)
                    med = s[len(s) // 2]
                limit = t.grad_norm_ceiling
                if med is not None and med > 0:
                    limit = min(limit, t.grad_explosion_factor * med)
                if gnorm > limit:
                    fire("grad_explosion", wid,
                         f"worker {wid} grad norm {gnorm:.3g} > "
                         f"{limit:.3g} at step {step}",
                         value=float(gnorm), threshold=float(limit))
                elif fresh:
                    # Only healthy observations from NEW reports feed the
                    # median — one explosion must not drag the baseline up
                    # after it, and a re-evaluated stale report must not
                    # flood the window with duplicates.
                    track.grad_norms.append(float(gnorm))

            # 3) loss divergence / plateau.
            if _finite(loss):
                if track.best_loss is None or loss < track.best_loss \
                        - t.plateau_min_improvement:
                    track.best_loss = float(loss)
                    track.best_loss_ts = ws.received_ts
                elif track.best_loss is not None \
                        and loss < track.best_loss:
                    track.best_loss = float(loss)
                if track.reports > t.loss_divergence_warmup \
                        and track.best_loss is not None \
                        and track.best_loss > 1e-8 \
                        and loss > t.loss_divergence_factor \
                        * track.best_loss:
                    fire("loss_divergence", wid,
                         f"worker {wid} loss {loss:.4g} > "
                         f"{t.loss_divergence_factor:g}x best "
                         f"{track.best_loss:.4g}",
                         value=float(loss),
                         threshold=t.loss_divergence_factor
                         * track.best_loss)
                if track.best_loss_ts \
                        and ws.received_ts - track.best_loss_ts \
                        > t.plateau_window_s \
                        and ws.received_ts - track.first_report_ts \
                        > t.plateau_window_s:
                    fire("loss_plateau", wid,
                         f"worker {wid} loss has not improved by "
                         f"{t.plateau_min_improvement:g} in "
                         f"{ws.received_ts - track.best_loss_ts:.0f}s",
                         value=float(loss),
                         threshold=t.plateau_min_improvement)

            # 4) stall: the worker's own step froze while the cluster moved.
            if step is not None:
                if track.last_step is None or step != track.last_step:
                    track.last_step = step
                    track.last_step_change_ts = ws.received_ts
                    track.step_at_last_change = state.global_step
                elif now - track.last_step_change_ts > t.stall_after_s \
                        and state.global_step > track.step_at_last_change:
                    fire("worker_stall", wid,
                         f"worker {wid} stuck at step {step} for "
                         f"{now - track.last_step_change_ts:.0f}s while "
                         f"the cluster advanced",
                         value=round(now - track.last_step_change_ts, 1),
                         threshold=t.stall_after_s)
                reporting_steps.append((wid, step))

        # 5) stragglers, relative to the fastest reporting worker.
        if len(reporting_steps) >= 2:
            max_step = max(s for _, s in reporting_steps)
            for wid, s in reporting_steps:
                if max_step - s > t.straggler_lag_steps \
                        and ("worker_stall", wid) not in firing:
                    fire("straggler_lag", wid,
                         f"worker {wid} at step {s}, "
                         f"{max_step - s} behind the leader",
                         value=float(max_step - s),
                         threshold=float(t.straggler_lag_steps))

        # Workers latched dead that have dropped out of the state entirely
        # (expired AND pruned from membership): the alert must stay active
        # until they are seen again, not resolve because they vanished.
        for wid in sorted(self._dead):
            if wid not in state.workers \
                    and ("dead_worker", wid) not in firing:
                fire("dead_worker", wid,
                     f"worker {wid} expired from membership and has not "
                     f"returned", threshold=t.dead_after_s)

        # 6) staleness-rejection spike (cluster-wide, async mode).
        total = state.pushes_accepted_delta + state.pushes_rejected_delta
        ratio = state.pushes_rejected_delta / total if total else 0.0
        if ratio > t.staleness_reject_ratio and (
                total >= t.staleness_min_pushes
                # Resolution hysteresis: once ACTIVE, the spike holds while
                # a freshly-rolled (still undersampled) window shows the
                # same thrash ratio, instead of emitting one resolved +
                # re-fired pair per window roll during sustained thrashing
                # (each fresh "fired" edge bypasses the re-alert cooldown
                # and bumps dps_alerts_total). A genuinely quiet or
                # healthy-ratio window still resolves immediately.
                or ("staleness_spike", None) in self._active):
            fire("staleness_spike", None,
                 f"{state.pushes_rejected_delta}/{total} pushes "
                 f"rejected by the staleness gate this window",
                 value=round(ratio, 4),
                 threshold=t.staleness_reject_ratio)

        # 6b) corrupt wire frames (push CRC trailer, comms/service.py).
        # Unlike the staleness spike there is no healthy baseline rate:
        # ONE refused frame means either real wire/memory damage or an
        # injected chaos schedule doing its job, so any nonzero window
        # fires. The window is time-anchored by the monitor (one
        # interval), so the alert outlives the single scrape that saw it.
        if state.corrupt_frames_delta > 0:
            fire("wire_corrupt", None,
                 f"{state.corrupt_frames_delta} corrupt push frame(s) "
                 f"refused this window (wire CRC mismatch)",
                 value=float(state.corrupt_frames_delta), threshold=0.0)

        # 6c) host memory leak slope (telemetry/memory.py, attached by
        # the monitor). Server-scope like the SLO rules: the verdict is
        # THIS process's RSS, so worker identity is None. Gated on a
        # minimum window span + sample count — two samples a second
        # apart during an allocation burst are not a leak.
        mem = state.memory if isinstance(state.memory, dict) else None
        if mem:
            slope = mem.get("growth_bytes_per_s")
            span = mem.get("window_span_s")
            n = mem.get("samples")
            if _finite(slope) and _finite(span) \
                    and isinstance(n, int) \
                    and span >= t.memory_growth_min_window_s \
                    and n >= t.memory_growth_min_samples \
                    and slope > t.memory_growth_bytes_per_s:
                fire("memory_growth", None,
                     f"host RSS growing {slope / 1048576.0:.1f} MiB/s "
                     f"over a {span:.0f}s window "
                     f"(rss {(mem.get('rss_bytes') or 0) / 1048576.0:.0f}"
                     f" MiB)",
                     value=round(float(slope), 1),
                     threshold=t.memory_growth_bytes_per_s)

        # 7) SLO burn-rate breaches (telemetry/slo.py, attached by the
        # monitor). One aggregated alert per rule — alert identity is
        # (rule, worker) and these are server-side conditions with no
        # worker — naming every breaching objective, value = worst burn.
        for rule in ("slo_burn_fast", "slo_burn_slow"):
            hits = [b for b in state.slo_breaches
                    if isinstance(b, dict) and b.get("rule") == rule]
            if not hits:
                continue
            worst = max(hits, key=lambda b: b.get("burn") or 0.0)
            names = ", ".join(sorted(str(b.get("objective")) for b in hits))
            fire(rule, None,
                 f"SLO burn over {worst.get('window_s', 0):.0f}s window: "
                 f"{names} (worst burn {worst.get('burn', 0):.1f}x budget)",
                 value=worst.get("burn"),
                 threshold=worst.get("burn_threshold"))

        # A departed-for-good worker's history must not pin memory forever.
        for wid in [w for w in self._tracks
                    if w not in state.workers and w not in self._dead]:
            del self._tracks[wid]
        return firing
