"""Trigger-driven continuous profiling: capture a window at the edge.

The JAX package's ``telemetry/proftrigger.py`` with the port's capture
(``torch.profiler``, :func:`.profiler.capture`). ``cli perf profile`` is
a manual one-shot — by the time an operator runs it the regression that
mattered is hours old. This engine rides the same edge sources the
incident capturer does and freezes a bounded profiler window the instant
something degrades, while the degraded behavior is still on the card:

- **benchwatch regression verdict** (``on_bench_verdict``) — a bench
  round's ledger check came back ``regression``;
- **SLO burn edge** (``on_alert_events`` via
  ``ClusterMonitor.add_listener``) — a freshly fired ``slo_burn_*``
  alert;
- **goodput-fraction drop edge** (``observe_goodput``) — the fleet's
  productive fraction fell through the threshold after having been
  healthy.

Each capture runs through :func:`..analysis.device_profile.
attribute_profile` and lands as ONE self-contained ``PROFILE_*.json``
record in the profile ledger directory. Raw Chrome traces are pruned
after a successful attribution and kept as evidence when the join fails
(:func:`..telemetry.profiler.prune_capture`).

A degradation storm must yield ONE capture, not one per refire:
triggers dedupe per rule inside ``cooldown_s`` exactly like
:class:`~.incidents.IncidentCapture` (suppressions counted on
``dps_profiles_suppressed_total``, captures on
``dps_profiles_captured_total``). Capture is best-effort everywhere: a
capture that fails (one ``torch.profiler`` session cannot start while
another is active) degrades to a ledger record with ``basis: none`` and
keeps the raw dir, never a broken serving path. The capture runs on the
caller's thread (the monitor's evaluation thread); CUPTI's activity
records are process-wide, so the card's kernels launched by the
service's threads land in it.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .journal import journal_event
from .registry import MetricsRegistry, get_registry

__all__ = ["PROFILE_RECORD_FIELDS", "ProfileTrigger"]

#: ``PROFILE_*.json`` ledger record schema: field -> meaning (the JAX
#: package's, key for key, so either package's records read the same).
PROFILE_RECORD_FIELDS = {
    "id": "record id: prof-<utc stamp>-<pid>-<rule>",
    "created_ts": "unix seconds the capture fired",
    "role": "role of the capturing process (server, bench, demo, ...)",
    "rule": "trigger rule: bench_regression, slo_burn, or goodput_drop",
    "trigger": "the full edge event that fired the capture",
    "window_s": "seconds of device activity the capture bracketed",
    "profile": "attribution artifact: basis, lanes, per-op-class "
               "time_s/events/fraction, total_attributed_s, "
               "trace_wall_s (analysis/device_profile.py)",
    "parse_errors": "per-file attribution failures (traces kept on "
                    "disk when any are fatal)",
    "traces_pruned": "whether the raw capture dir was deleted after a "
                     "successful join",
}


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, path)


def default_capture(logdir: str, window_s: float,
                    device: str = "cuda") -> None:
    """Real capture: bracket ``window_s`` seconds of whatever the
    process's ``device`` is doing with ``torch.profiler`` (``cli serve``
    binds its own ``--device``)."""
    from .profiler import capture
    with capture(logdir, device):
        time.sleep(window_s)


class ProfileTrigger:
    """Edge-triggered profile capturer with per-rule cooldown dedupe.

    ``capture_fn(logdir, window_s)`` produces the raw dump (injectable:
    tests write synthetic Chrome traces; the default brackets a real
    ``torch.profiler`` window). ``profiles_dir`` receives the
    ``PROFILE_*.json`` ledger records; raw dumps go under
    ``profiles_dir/raw/<id>/`` and are pruned on a successful join.
    """

    def __init__(self, profiles_dir: str, capture_fn=default_capture,
                 window_s: float = 1.5, cooldown_s: float = 600.0,
                 goodput_drop_threshold: float = 0.5,
                 role: str = "server",
                 registry: MetricsRegistry | None = None,
                 clock=time.time):
        if window_s <= 0 or cooldown_s < 0:
            raise ValueError("window_s must be > 0 and cooldown_s >= 0")
        if not 0.0 < goodput_drop_threshold <= 1.0:
            raise ValueError("goodput_drop_threshold must be in (0, 1]")
        self.profiles_dir = profiles_dir
        self.capture_fn = capture_fn
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.goodput_drop_threshold = float(goodput_drop_threshold)
        self.role = role
        self.clock = clock
        reg = registry or get_registry()
        self._tm_captured = reg.counter("dps_profiles_captured_total")
        self._tm_suppressed = reg.counter("dps_profiles_suppressed_total")
        self._lock = threading.Lock()
        self._last_capture = {}          # guarded by: self._lock
        self._last_goodput: float | None = None  # guarded by: self._lock

    # -- edge sources ------------------------------------------------------

    def on_alert_events(self, events) -> None:
        """``ClusterMonitor.add_listener`` entry: capture on every
        *newly fired* SLO-burn edge (refires and resolves never
        trigger; the cooldown handles storms of distinct fires)."""
        for ev in events:
            if ev.get("state") == "fired" \
                    and str(ev.get("rule", "")).startswith("slo_burn"):
                self.maybe_capture({**dict(ev), "rule": "slo_burn",
                                    "slo_rule": ev.get("rule")})

    def on_bench_verdict(self, verdict: dict) -> str | None:
        """benchwatch edge source: a ``regression`` verdict triggers a
        capture naming the regressed metrics; pass/malformed never
        does."""
        if not isinstance(verdict, dict) \
                or verdict.get("status") != "regression":
            return None
        return self.maybe_capture({
            "rule": "bench_regression",
            "regressions": list(verdict.get("regressions") or ()),
        })

    def observe_goodput(self, fraction, now: float | None = None) -> str | None:
        """Goodput-drop edge source: triggers once when the observed
        productive fraction FALLS THROUGH the threshold (the previous
        observation was at or above it) — a run that starts degraded
        never edges, and a run sitting below re-arms only by climbing
        back over."""
        if not isinstance(fraction, (int, float)) \
                or isinstance(fraction, bool):
            return None
        with self._lock:
            prev = self._last_goodput
            self._last_goodput = float(fraction)
        thr = self.goodput_drop_threshold
        if prev is None or prev < thr or fraction >= thr:
            return None
        return self.maybe_capture({
            "rule": "goodput_drop",
            "fraction": round(float(fraction), 4),
            "previous": round(float(prev), 4),
            "threshold": thr,
        })

    # -- capture -----------------------------------------------------------

    def maybe_capture(self, trigger: dict) -> str | None:
        """Capture + attribute + ledger-append one window unless the
        rule is inside its cooldown. Returns the ledger record path, or
        ``None`` when suppressed."""
        rule = trigger.get("rule") or "unknown"
        now = self.clock()
        with self._lock:
            last = self._last_capture.get(rule)
            if last is not None and now - last < self.cooldown_s:
                self._tm_suppressed.inc()
                return None
            self._last_capture[rule] = now
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))
        prof_id = f"prof-{stamp}-{os.getpid()}-{rule}"
        record_path = os.path.join(self.profiles_dir,
                                   f"PROFILE_{stamp}_{rule}.json")
        n = 1
        while os.path.exists(record_path):
            # two same-rule edges inside one second (cooldown_s=0) must
            # not clobber each other's ledger record
            n += 1
            prof_id = f"prof-{stamp}-{os.getpid()}-{rule}-{n}"
            record_path = os.path.join(
                self.profiles_dir, f"PROFILE_{stamp}_{rule}-{n}.json")
        raw_dir = os.path.join(self.profiles_dir, "raw", prof_id)
        os.makedirs(raw_dir, exist_ok=True)
        try:
            self.capture_fn(raw_dir, self.window_s)
        except Exception:  # noqa: BLE001 — degrade, never fail the edge
            pass
        artifact = self._attribute(raw_dir)
        profile = artifact.get("profile") or {}
        parse_errors = artifact.get("parse_errors") or []
        # Prune the raw dump only once the join SUCCEEDED (something was
        # attributed and nothing failed to parse); a failed join keeps
        # the traces as the evidence.
        pruned = False
        if profile.get("basis") not in (None, "none") \
                and not parse_errors:
            from .profiler import prune_capture
            prune_capture(raw_dir)
            pruned = True
            # raw/<id>/ then raw/ if empty — but never ascend past
            # raw/ (os.removedirs would take the empty profiles_dir
            # with it, right before the record write needs it).
            for d in (raw_dir, os.path.dirname(raw_dir)):
                try:
                    os.rmdir(d)
                except OSError:
                    break
        record = {
            "id": prof_id,
            "created_ts": round(now, 3),
            "role": self.role,
            "rule": rule,
            "trigger": trigger,
            "window_s": self.window_s,
            "profile": profile,
            "parse_errors": parse_errors,
            "traces_pruned": pruned,
        }
        _atomic_json(record_path, record)
        self._tm_captured.inc()
        journal_event("profile", id=prof_id, rule=rule, path=record_path)
        return record_path

    def _attribute(self, raw_dir: str) -> dict:
        try:
            from ..analysis.device_profile import attribute_profile
            return attribute_profile(raw_dir)
        except Exception as e:  # noqa: BLE001 — degrade, never fail
            return {"profile": {"basis": "none", "op_classes": {},
                                "total_attributed_s": 0.0,
                                "trace_wall_s": None},
                    "parse_errors": [f"attribution failed: {e}"]}
