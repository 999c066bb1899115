"""Serve-tier SLOs: declarative objectives + multi-window burn rates.

The JAX package's ``telemetry/slo.py``, carried over with the port's
registry. It gives the server its own latency distribution, objectives
and error budget, read from the RPC histograms the service records:

- **Objectives** are declarative (:class:`SloObjective`): "99% of
  FetchParameters complete under 100 ms", "99.9% of pushes succeed".
  Latency objectives read the ``dps_rpc_server_latency_seconds{method}``
  histogram (comms/service.py, shared ``LATENCY_BUCKETS`` scheme);
  availability objectives read ``dps_rpc_server_errors_total{method}``
  against the same histogram's count.
- **Evaluation** is the multi-window burn-rate recipe (SRE workbook):
  each tick snapshots cumulative (total, bad) per objective; windowed
  DELTAS over a fast and a slow window give the burn rate = observed
  bad fraction / budgeted bad fraction. Fast window hot (burn >= ~14.4)
  means the monthly budget dies in hours -> ``slo_burn_fast``
  (critical); slow window warm (burn >= ~6) means sustained bleed ->
  ``slo_burn_slow`` (warning). Both rules live in the health
  RULE_CATALOG (telemetry/health.py) and ride the existing
  alert -> remediation path; ``GET /cluster`` gains an ``"slo"`` block
  (:meth:`SloEvaluator.view`) and ``cli status`` renders it.

Latency "good" counting is bucket-exact and conservative: the threshold
snaps DOWN to the nearest histogram edge (never up), so a threshold
between edges under-counts good events rather than hiding bad ones.
The snapped value is reported in the view — honesty over flattery.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field

from .registry import LATENCY_BUCKETS, MetricsRegistry, get_registry
from .stats import histogram_quantile

__all__ = [
    "SLO_RULE_FAST",
    "SLO_RULE_SLOW",
    "SloObjective",
    "SloEvaluator",
    "default_objectives",
]

#: Health-rule names this evaluator feeds (must match RULE_CATALOG keys
#: in telemetry/health.py; tests/test_docs_drift.py pins the catalog).
SLO_RULE_FAST = "slo_burn_fast"
SLO_RULE_SLOW = "slo_burn_slow"


@dataclass(frozen=True)
class SloObjective:
    """One objective over one RPC method.

    ``target`` is the good fraction (0.99 = 99% of events good).
    ``threshold_s`` set -> latency objective (good = completed within
    the threshold); None -> availability objective (good = no error).
    """

    name: str
    method: str
    target: float
    threshold_s: float | None = None

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1), "
                f"got {self.target}")
        if self.threshold_s is not None and self.threshold_s <= 0:
            raise ValueError(
                f"objective {self.name!r}: threshold_s must be > 0, "
                f"got {self.threshold_s}")

    @property
    def budget(self) -> float:
        """Budgeted bad fraction (1 - target)."""
        return 1.0 - self.target


def default_objectives(fetch_p99_ms: float = 100.0,
                       availability: float = 0.99) -> list:
    """The serve-tier defaults ``cli serve`` installs: fetch latency at
    the given p99 threshold, plus fetch/push availability."""
    return [
        SloObjective("fetch_latency", "FetchParameters", 0.99,
                     threshold_s=fetch_p99_ms / 1e3),
        SloObjective("fetch_availability", "FetchParameters", availability),
        SloObjective("push_availability", "PushGradrients", availability),
    ]


@dataclass
class _Window:
    """One burn-rate window: span + the burn threshold that breaches it."""

    window_s: float
    burn_threshold: float
    rule: str = SLO_RULE_FAST
    severity: str = "critical"
    min_events: int = field(default=1)


class SloEvaluator:
    """Window-delta burn-rate evaluator over the server RPC metrics.

    ``evaluate(now)`` is driven by the cluster monitor's tick (no thread
    of its own); ``view()`` may be read concurrently from the HTTP
    surface, so the sample history has its own lock.
    """

    def __init__(self, objectives: list | None = None,
                 registry: MetricsRegistry | None = None,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 fast_burn_threshold: float = 14.4,
                 slow_burn_threshold: float = 6.0,
                 min_events: int = 1):
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.registry = registry if registry is not None else get_registry()
        if slow_window_s < fast_window_s:
            raise ValueError(
                f"slow window ({slow_window_s}s) must be >= fast window "
                f"({fast_window_s}s)")
        self.windows = (
            _Window(fast_window_s, fast_burn_threshold, SLO_RULE_FAST,
                    "critical", min_events),
            _Window(slow_window_s, slow_burn_threshold, SLO_RULE_SLOW,
                    "warning", min_events),
        )
        self._lock = threading.Lock()
        # (ts, {objective_name: (total, bad)}) — guarded by: self._lock
        self._samples: deque = deque()
        self._last_breaches: list = []  # guarded by: self._lock

    # -- reading the instruments --------------------------------------------

    def _instruments(self, method: str):
        hist = self.registry.histogram("dps_rpc_server_latency_seconds",
                                       buckets=LATENCY_BUCKETS,
                                       method=method)
        errors = self.registry.counter("dps_rpc_server_errors_total",
                                       method=method)
        return hist, errors

    @staticmethod
    def _good_upto(snap: dict, threshold_s: float) -> tuple[int, float]:
        """(good count, snapped threshold): cumulative count through the
        last bucket whose edge <= threshold. Snapping DOWN keeps the
        estimate conservative when the threshold is between edges."""
        edges = snap["le"]
        k = bisect_right(edges, threshold_s)  # buckets [0, k) are good
        if k == 0:
            return 0, 0.0  # threshold below the first edge: nothing provably good
        return sum(snap["counts"][:k]), float(edges[k - 1])

    def _totals(self, obj: SloObjective) -> tuple[int, int]:
        """Cumulative (total, bad) for one objective, right now."""
        hist, errors = self._instruments(obj.method)
        snap = hist.snapshot()
        total = int(snap["count"])
        err = int(errors.value)
        if obj.threshold_s is None:
            return total, min(total, err)
        good, _ = self._good_upto(snap, obj.threshold_s)
        # Errored calls still observe a duration (service.py records in
        # the finally), so a fast abort can land in a "good" latency
        # bucket; adding the error count back may double-count a SLOW
        # error — conservative by design, never flattering.
        return total, min(total, (total - good) + err)

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, now: float) -> list:
        """Record one sample and return current breaches (list of dicts
        ``{rule, severity, objective, window_s, burn, burn_threshold,
        bad, total}``), newest evaluation wins."""
        sample = {o.name: self._totals(o) for o in self.objectives}
        breaches = []
        with self._lock:
            self._samples.append((float(now), sample))
            horizon = now - self.windows[-1].window_s * 1.5
            while len(self._samples) > 1 and self._samples[0][0] < horizon:
                self._samples.popleft()
            samples = list(self._samples)
        for win in self.windows:
            for obj in self.objectives:
                d = self._window_delta(samples, obj.name, now, win.window_s)
                if d is None or d["total"] < win.min_events:
                    continue
                burn = self._burn(obj, d["bad"], d["total"])
                if burn >= win.burn_threshold:
                    breaches.append({
                        "rule": win.rule, "severity": win.severity,
                        "objective": obj.name, "window_s": win.window_s,
                        "burn": round(burn, 2),
                        "burn_threshold": win.burn_threshold,
                        "bad": d["bad"], "total": d["total"],
                    })
        with self._lock:
            self._last_breaches = list(breaches)
        return breaches

    @staticmethod
    def _burn(obj: SloObjective, bad: int, total: int) -> float:
        if total <= 0:
            return 0.0
        return (bad / total) / obj.budget

    @staticmethod
    def _window_delta(samples: list, name: str, now: float,
                      window_s: float) -> dict | None:
        """Delta between the newest sample and the newest sample at or
        before the window start. One sample (no baseline) -> the full
        cumulative value counts as the delta: a freshly started server
        must not get a breach-free grace period just for being new."""
        if not samples:
            return None
        start = now - window_s
        base = None
        for ts, vals in samples:
            if ts <= start:
                base = vals
            else:
                break
        _, newest = samples[-1]
        nt, nb = newest.get(name, (0, 0))
        if base is None:
            bt = bb = 0
        else:
            bt, bb = base.get(name, (0, 0))
        return {"total": max(0, nt - bt), "bad": max(0, nb - bb)}

    # -- read surface ---------------------------------------------------------

    def view(self) -> dict:
        """The ``GET /cluster`` ``"slo"`` block: per-objective lifetime
        quantiles + per-window burn, plus the active breaches from the
        latest :meth:`evaluate` tick."""
        with self._lock:
            samples = list(self._samples)
            breaches = list(self._last_breaches)
        now = samples[-1][0] if samples else 0.0
        out_objs = []
        for obj in self.objectives:
            hist, _ = self._instruments(obj.method)
            snap = hist.snapshot()
            entry = {
                "name": obj.name, "method": obj.method,
                "target": obj.target,
                "kind": ("latency" if obj.threshold_s is not None
                         else "availability"),
                "total": int(snap["count"]),
            }
            if obj.threshold_s is not None:
                _, snapped = self._good_upto(snap, obj.threshold_s)
                entry["threshold_ms"] = round(obj.threshold_s * 1e3, 3)
                entry["snapped_threshold_ms"] = round(snapped * 1e3, 3)
            for pct, key in ((50, "p50_ms"), (95, "p95_ms"), (99, "p99_ms")):
                q = histogram_quantile(snap["le"], snap["counts"], pct)
                entry[key] = None if q is None else round(q * 1e3, 3)
            windows = {}
            for win in self.windows:
                d = self._window_delta(samples, obj.name, now, win.window_s)
                if d is None:
                    d = {"total": 0, "bad": 0}
                burn = self._burn(obj, d["bad"], d["total"])
                windows[win.rule] = {
                    "window_s": win.window_s, "total": d["total"],
                    "bad": d["bad"], "burn": round(burn, 2),
                    "burn_threshold": win.burn_threshold,
                    "breaching": any(b["rule"] == win.rule
                                     and b["objective"] == obj.name
                                     for b in breaches),
                }
            entry["windows"] = windows
            out_objs.append(entry)
        return {"objectives": out_objs, "breaches": breaches}
