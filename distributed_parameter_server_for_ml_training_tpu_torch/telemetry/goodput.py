"""Goodput accounting: classify every second of worker wall (a copy of the
JAX package's ``telemetry/goodput.py``).

The training loop brackets its phases with :meth:`GoodputAccount.span`
and every second lands in exactly one :data:`GOODPUT_CATEGORIES` bucket,
cumulative on ``dps_goodput_seconds_total{category=...}`` counters beside
a ``dps_goodput_wall_seconds_total`` anchor. Spans nest; a parent is
charged only its exclusive time, so the categories are disjoint, and the
residual ``wall - sum(categories)`` is reported as ``other``.
"""

from __future__ import annotations

import threading
import time

from .registry import MetricsRegistry, get_registry

__all__ = [
    "GOODPUT_CATEGORIES",
    "GOODPUT_METRIC",
    "GOODPUT_WALL_METRIC",
    "PRODUCTIVE_CATEGORIES",
    "GoodputAccount",
    "delta_counters",
    "goodput_report",
    "parse_goodput_counters",
    "report_from_counters",
]

#: category -> one-line meaning: the JAX package's table, so goodput
#: counters of either package merge (docs/OBSERVABILITY.md).
GOODPUT_CATEGORIES = {
    "compute": "device step work (train + eval): the productive bucket",
    "fetch_wait": "blocked on a boundary parameter fetch (RPC + decode "
                  "wait, net of nested recovery/codec time)",
    "push_wait": "blocked on a gradient push (serial RPC or pipeline "
                 "backpressure, net of nested codec time)",
    "codec": "wire codec work: push quantize/pack/encode + fetch "
             "decompress",
    "checkpoint": "blocked on a checkpoint save in the training loop",
    "reconnect_recovery": "session-resume state machine after a lost "
                          "server (register + refetch + reconcile, "
                          "including backoff sleeps)",
    "quarantine_idle": "step work thrown away while the server had this "
                       "worker's pushes quarantined",
    "startup": "process start to the training loop: registration, "
               "dataset/model/template init",
    "other": "residual: wall seconds no instrumented phase claimed "
             "(reported, never hidden)",
}

#: Categories that count as PRODUCTIVE in the goodput fraction.
PRODUCTIVE_CATEGORIES = ("compute",)

GOODPUT_METRIC = "dps_goodput_seconds_total"
GOODPUT_WALL_METRIC = "dps_goodput_wall_seconds_total"


class _GoodputSpan:
    """One phase bracket. Charges its category the *exclusive* duration
    (total minus enclosed child spans) so nested brackets never double
    count a second. Reentrant-safe via the account's per-thread stack."""

    __slots__ = ("_acct", "category", "_t0", "_child_s")

    def __init__(self, acct: "GoodputAccount", category: str):
        self._acct = acct
        self.category = category
        self._t0 = 0.0
        self._child_s = 0.0

    def __enter__(self):
        self._child_s = 0.0
        self._acct._stack().append(self)
        self._t0 = self._acct._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = self._acct._clock() - self._t0
        stack = self._acct._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1]._child_s += dt
        self._acct.add(self.category, max(0.0, dt - self._child_s))
        return False


class GoodputAccount:
    """The wall-clock ledger for ONE logical worker/trainer.

    Keeps its own per-instance totals (so a multi-worker process reports
    an honest per-worker fraction) while mirroring every addition onto
    the process-global cumulative counters (which therefore sum
    worker-seconds across however many accounts share the registry —
    exactly the semantics the fleet rollup wants).
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 clock=time.perf_counter):
        reg = registry or get_registry()
        self._clock = clock
        # Literal names at the registration sites (== GOODPUT_METRIC /
        # GOODPUT_WALL_METRIC): the metric<->doc drift pin extracts
        # registrations textually, and these two must stay pinned.
        self._counters = {
            c: reg.counter("dps_goodput_seconds_total", category=c)
            for c in GOODPUT_CATEGORIES}
        self._wall = reg.counter("dps_goodput_wall_seconds_total")
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._local = {c: 0.0 for c in GOODPUT_CATEGORIES}  # by: _lock
        self._local_wall = 0.0   # guarded by: self._lock
        self._wall_mark = None   # guarded by: self._lock

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- recording -----------------------------------------------------------

    def add(self, category: str, seconds: float) -> None:
        """Charge ``seconds`` of wall to one catalog category."""
        if category not in GOODPUT_CATEGORIES:
            raise ValueError(f"unknown goodput category {category!r} "
                             f"(catalog: {sorted(GOODPUT_CATEGORIES)})")
        if seconds < 0:
            return
        with self._lock:
            self._local[category] += seconds
        self._counters[category].inc(seconds)

    def span(self, category: str) -> _GoodputSpan:
        """Phase bracket: ``with acct.span("fetch_wait"): ...``."""
        if category not in GOODPUT_CATEGORIES:
            raise ValueError(f"unknown goodput category {category!r}")
        return _GoodputSpan(self, category)

    def start_wall(self, mark: float | None = None) -> None:
        """Anchor the wall clock (loop entry; ``mark`` backdates it to
        an earlier ``clock()`` reading so startup time is inside)."""
        with self._lock:
            self._wall_mark = self._clock() if mark is None else mark

    def tick_wall(self) -> None:
        """Advance the wall counter to now (call once per step/epoch —
        wall accrues regardless of which categories claimed it)."""
        now = self._clock()
        with self._lock:
            if self._wall_mark is None:
                self._wall_mark = now
                return
            dt = now - self._wall_mark
            self._wall_mark = now
            if dt <= 0:
                return
            self._local_wall += dt
        self._wall.inc(dt)

    # -- reading -------------------------------------------------------------

    def totals(self) -> dict:
        """This account's own ledger: ``{"categories": {...},
        "wall_s": float}`` (instance-local, not the shared counters)."""
        with self._lock:
            return {"categories": dict(self._local),
                    "wall_s": self._local_wall}

    def fraction(self) -> float | None:
        """Productive fraction of this account's wall so far, or None
        before any wall has accrued."""
        with self._lock:
            if self._local_wall <= 0:
                return None
            good = sum(self._local[c] for c in PRODUCTIVE_CATEGORIES)
            return min(1.0, good / self._local_wall)


# -- report math (pure; shared by cli goodput, cli query, the demo) ----------

def parse_goodput_counters(counters: dict) -> dict:
    """Extract the goodput ledger from a snapshot ``counters`` mapping
    (``name{category=x}`` -> value, the shape /metrics.json, journal
    snapshots, and fleet rollups all carry). Unknown categories are kept
    — a newer producer's category shows up rather than vanishing."""
    cats: dict[str, float] = {}
    wall = 0.0
    prefix = GOODPUT_METRIC + "{category="
    for key, value in (counters or {}).items():
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if key.startswith(prefix) and key.endswith("}"):
            cat = key[len(prefix):-1]
            cats[cat] = cats.get(cat, 0.0) + float(value)
        elif key == GOODPUT_WALL_METRIC \
                or key.startswith(GOODPUT_WALL_METRIC + "{"):
            wall += float(value)
    return {"categories": cats, "wall_s": wall}


def delta_counters(newest: dict, base: dict) -> dict:
    """Per-key counter subtraction (window math for retro queries).
    Negative deltas clamp to 0 — a counter that went backward is a
    process restart, not negative time."""
    out = {}
    for key, v in (newest or {}).items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        b = (base or {}).get(key, 0.0)
        b = b if isinstance(b, (int, float)) \
            and not isinstance(b, bool) else 0.0
        out[key] = max(0.0, float(v) - float(b))
    return out


def goodput_report(categories: dict, wall_s: float,
                   tolerance: float = 0.02) -> dict:
    """The reconciliation report over one ledger (cumulative or a
    window delta). The residual (wall minus every recorded category) is
    folded into ``other`` AND reported separately — never hidden; when
    the recorded categories OVERSHOOT the wall by more than
    ``tolerance`` (fraction of wall), ``reconciled`` is False and the
    overshoot is reported too (clock skew or a missing wall tick)."""
    cats = {c: float(categories.get(c, 0.0))
            for c in GOODPUT_CATEGORIES}
    for c, v in (categories or {}).items():  # keep unknown categories
        if c not in cats and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            cats[c] = float(v)
    recorded = sum(v for c, v in cats.items() if c != "other")
    wall = max(0.0, float(wall_s))
    residual = wall - recorded
    overshoot = max(0.0, -residual)
    cats["other"] += max(0.0, residual)
    total = max(wall, recorded)
    good = sum(cats.get(c, 0.0) for c in PRODUCTIVE_CATEGORIES)
    rows = {
        c: {"seconds": round(v, 3),
            "fraction": round(v / total, 4) if total > 0 else 0.0}
        for c, v in sorted(cats.items(), key=lambda kv: -kv[1])
    }
    return {
        "wall_s": round(wall, 3),
        "categories": rows,
        "goodput_fraction": round(good / total, 4) if total > 0 else None,
        "badput_s": round(max(0.0, total - good), 3),
        "residual_s": round(max(0.0, residual), 3),
        "residual_fraction": round(max(0.0, residual) / total, 4)
        if total > 0 else 0.0,
        "overshoot_s": round(overshoot, 3),
        "reconciled": bool(wall > 0
                           and overshoot <= tolerance * max(wall, 1e-9)),
    }


def report_from_counters(counters: dict, tolerance: float = 0.02) -> dict:
    """Convenience: parse + report in one call (live /metrics.json,
    fleet rollup sums, or a window delta from :func:`delta_counters`)."""
    parsed = parse_goodput_counters(counters)
    return goodput_report(parsed["categories"], parsed["wall_s"],
                          tolerance=tolerance)
