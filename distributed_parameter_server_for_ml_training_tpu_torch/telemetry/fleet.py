"""Fleet observatory: cross-process metrics aggregation plane.

The JAX package's ``telemetry/fleet.py``, carried over whole (it is
host Python over HTTP: it reads the port's ``/metrics.json`` and
``/cluster`` as it reads the JAX package's).

Every other observability surface is per-process: ``/metrics``
and ``/cluster`` describe ONE process and ``cli status`` polls exactly
one URL — unusable for a fleet of sharded primaries, delta-fed replicas
and supervised workers (and exactly the gap ACE-Sync's cloud-edge
hierarchy calls out: hierarchical tiers demand tier-aware merged
visibility, not N disjoint scrapes). :class:`FleetCollector` closes it:

- **Discovery.** Explicit ``--targets`` seed the scrape set; every
  scraped ``/cluster`` view then contributes more processes — shard
  peers and announced replicas (a replica that announces a ``metrics``
  address becomes a scrape target), supervisor children and job
  membership (inventory tiers; they have no metrics endpoint of their
  own and are reported from the primaries' views).
- **Ring TSDB.** Per-target, per-series fixed-depth rings
  (``collections.deque(maxlen=ring_depth)``) — bounded memory, no
  external deps, enough history for rates and sparklines.
- **Honest rollups.** Counters roll up as sums + ring-delta rate sums;
  gauges as sum/min/max/mean; histograms via
  :func:`..telemetry.stats.merge_histograms` — bucket-EXACT because the
  bucket schemes are pinned in ``registry.py``, so fleet p50/p95/p99
  equal the percentiles of the unioned observations (property-tested).
  Exemplars ride along: a fleet p99 spike carries the trace ids of
  recent slow requests (``analysis/fleet_series.py`` joins them against
  flight-recorder dumps).
- **Partial-fleet tolerance.** Per-target timeouts; a dead target marks
  its series stale (excluded from rollups, flagged in the view) and
  NEVER blocks the tick. ``dps_fleet_scrape_errors_total{target}`` is
  minted lazily per target and removed when a discovered target drains
  — the same series-lifecycle discipline as ``dps_replica_lag_*``
  (ps/sharding.py).
- **Fleet SLO burn.** The multi-window burn-rate recipe (telemetry/slo)
  re-evaluated over the MERGED series — a latency breach that only
  shows up in the union (each shard individually under threshold, the
  fleet over it) is visible here and nowhere else.

Runs as a standalone ``cli observe`` process — off every hot path, and
it survives primary restarts because it holds no connection state, just
URLs it re-scrapes each tick. ``start_fleet_server`` exposes ``GET
/fleet`` (the full view), plus ``/metrics`` for the collector's own
instruments. ``cli top`` renders the view live; docs/OBSERVABILITY.md
("Fleet observatory") documents the payload schema and the rollup
semantics table pinned to :data:`FLEET_ROLLUP_FIELDS`.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import LATENCY_BUCKETS_S, MetricsRegistry, get_registry
from .slo import SloEvaluator, default_objectives
from .stats import histogram_quantile, merge_histograms

__all__ = [
    "FLEET_ROLLUP_FIELDS",
    "FleetCollector",
    "parse_prometheus_text",
    "start_fleet_server",
]

#: Rollup-field catalog: every field a ``/fleet`` rollup entry may carry,
#: with its merge semantics. Pure literal — dpslint's ``doc-drift`` pass
#: (tools/dpslint/catalog_drift.py, check ``fleet-rollup-fields``) pins
#: this table to the "Rollup semantics" section of docs/OBSERVABILITY.md
#: in both directions.
FLEET_ROLLUP_FIELDS = {
    "sum": "counters/gauges/histograms: values summed over fresh targets",
    "rate_per_s": "counters: ring-delta rates summed over fresh targets",
    "min": "gauges: minimum latest value across fresh targets",
    "max": "gauges: maximum latest value across fresh targets",
    "mean": "gauges: mean of latest values across fresh targets",
    "targets": "number of fresh targets contributing to the rollup",
    "le": "histograms: pinned bucket upper bounds (identical fleet-wide)",
    "counts": "histograms: exact per-bucket union counts (non-cumulative)",
    "count": "histograms: total observations in the union",
    "p50_ms": "histograms: union median from the merged buckets",
    "p95_ms": "histograms: union p95 from the merged buckets",
    "p99_ms": "histograms: union p99 from the merged buckets",
    "exemplars": "histograms: newest exemplar per bucket across the fleet",
}

#: Counter families whose fleet-wide rate sum defines "fleet QPS".
_QPS_FAMILIES = ("dps_rpc_server_calls_total", "dps_replica_fetches_total")


def _parse_label_block(block: str) -> dict:
    """``k="v",k2="v2"`` -> dict (no escape handling: our renderer never
    emits quotes or commas inside values)."""
    labels: dict[str, str] = {}
    for part in block.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k.strip()] = v.strip().strip('"')
    return labels


def _label_key(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


def parse_prometheus_text(text: str) -> dict:
    """Prometheus text exposition -> registry-snapshot shape.

    The degradation path when a target serves only ``/metrics`` (older
    build without ``/metrics.json``): reconstructs NON-cumulative bucket
    counts from the cumulative ``_bucket{le=...}`` series using the
    ``# TYPE`` directives, yielding the same ``{"counters", "gauges",
    "histograms"}`` dict ``MetricsRegistry.snapshot()`` produces —
    minus exemplars, which the text format does not carry.
    """
    kinds: dict[str, str] = {}
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    hists: dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        metric, _, value_s = line.rpartition(" ")
        metric = metric.strip()
        if "{" in metric:
            name, _, rest = metric.partition("{")
            labels = _parse_label_block(rest.rstrip("}"))
        else:
            name, labels = metric, {}
        try:
            value = float(value_s)
        except ValueError:
            continue
        base = name
        suffix = ""
        for s in ("_bucket", "_sum", "_count"):
            if name.endswith(s) and kinds.get(name[:-len(s)]) == "histogram":
                base, suffix = name[:-len(s)], s
                break
        kind = kinds.get(base)
        if kind == "histogram":
            le = labels.pop("le", None)
            key = base + _label_key(labels)
            h = hists.setdefault(key, {"cum": [], "sum": 0.0, "count": 0})
            if suffix == "_bucket" and le is not None:
                edge = float("inf") if le == "+Inf" else float(le)
                h["cum"].append((edge, int(value)))
            elif suffix == "_sum":
                h["sum"] = value
            elif suffix == "_count":
                h["count"] = int(value)
        elif kind == "gauge":
            out["gauges"][base + _label_key(labels)] = value
        else:  # counter, or untyped (counted as counter-like)
            out["counters"][base + _label_key(labels)] = value
    for key, h in hists.items():
        cum = sorted(h["cum"])
        edges = [e for e, _ in cum if e != float("inf")]
        counts: list[int] = []
        prev = 0
        for _, c in cum:
            counts.append(max(0, c - prev))
            prev = c
        if len(counts) == len(edges):  # no +Inf line: empty overflow
            counts.append(0)
        out["histograms"][key] = {"le": edges, "counts": counts,
                                  "sum": h["sum"], "count": h["count"]}
    return out


def _normalize_target(t: str) -> str:
    t = t.strip().rstrip("/")
    if t.startswith(("http://", "https://")):
        return t
    return "http://" + t


class _TargetState:
    """Everything the collector remembers about one scrape target."""

    def __init__(self, target: str, explicit: bool, ring_depth: int,
                 discovered_from: str | None = None):
        self.target = target
        self.explicit = explicit
        self.discovered_from = discovered_from
        self.ring_depth = ring_depth
        self.rings: dict[str, deque] = {}     # series key -> (ts, value)
        self.hist_latest: dict[str, dict] = {}  # series key -> snapshot
        self.cluster: dict | None = None
        self.ok = False
        self.consecutive_failures = 0
        self.last_scrape_ts = 0.0
        self.last_error: str | None = None
        self.role: str | None = None
        self.pid: int | None = None

    @property
    def stale(self) -> bool:
        return not self.ok

    def record(self, now: float, snap: dict, cluster: dict | None) -> None:
        for kind in ("counters", "gauges"):
            for key, val in snap.get(kind, {}).items():
                ring = self.rings.get(kind + ":" + key)
                if ring is None:
                    ring = deque(maxlen=self.ring_depth)
                    self.rings[kind + ":" + key] = ring
                ring.append((now, float(val)))
        self.hist_latest = dict(snap.get("histograms", {}))
        if cluster is not None:
            self.cluster = cluster
            self.role = cluster.get("role")
            self.pid = cluster.get("pid")
        self.ok = True
        self.consecutive_failures = 0
        self.last_scrape_ts = now
        self.last_error = None

    def fail(self, now: float, err: str) -> None:
        self.ok = False
        self.consecutive_failures += 1
        self.last_error = err

    def latest(self, kind: str) -> dict:
        """Latest value per series of one kind ('counters'/'gauges')."""
        prefix = kind + ":"
        return {k[len(prefix):]: ring[-1][1]
                for k, ring in self.rings.items()
                if k.startswith(prefix) and ring}

    def rate(self, key: str, now: float, window_s: float) -> float | None:
        """Ring-delta rate for one counter: newest vs the oldest sample
        inside the window (None with <2 samples). Clamped at 0 so a
        counter reset (process restart) reads as a rate dip, not a
        negative spike."""
        ring = self.rings.get("counters:" + key)
        if not ring or len(ring) < 2:
            return None
        newest_ts, newest_v = ring[-1]
        base_ts, base_v = ring[0]
        for ts, v in ring:
            if ts >= now - window_s:
                base_ts, base_v = ts, v
                break
        if newest_ts <= base_ts:
            return None
        return max(0.0, newest_v - base_v) / (newest_ts - base_ts)

    def to_row(self) -> dict:
        row = {
            "target": self.target,
            "explicit": self.explicit,
            "ok": self.ok,
            "stale": self.stale,
            "consecutive_failures": self.consecutive_failures,
            "last_scrape_ts": round(self.last_scrape_ts, 3),
            "last_error": self.last_error,
        }
        if self.role is not None:
            row["role"] = self.role
        if self.pid is not None:
            row["pid"] = self.pid
        if self.discovered_from is not None:
            row["discovered_from"] = self.discovered_from
        return row


class FleetCollector:
    """Scrape loop + ring TSDB + rollup engine (see module docstring).

    ``tick()`` is re-entrant-safe but meant to be driven by one loop
    (``run_forever`` or a test calling it directly with a fake clock);
    ``view()`` may be called concurrently from the HTTP surface.
    """

    def __init__(self, targets: list, interval_s: float = 2.0,
                 timeout_s: float = 1.5, ring_depth: int = 120,
                 rate_window_s: float = 30.0,
                 registry: MetricsRegistry | None = None,
                 objectives: list | None = None,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 journal=None, incidents=None,
                 clock=time.time):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.ring_depth = int(ring_depth)
        self.rate_window_s = float(rate_window_s)
        #: Optional JournalWriter: every tick appends one ``fleet_tick``
        #: record (the merged view minus its history rings) plus
        #: ``slo_burn`` edge records — the replay/forensics feed.
        self.journal = journal
        #: Optional IncidentCapture fed each tick's view (observer-side
        #: critical alert / SLO-burn capture).
        self.incidents = incidents
        self.clock = clock
        self.registry = registry if registry is not None else get_registry()
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        self._slo_windows = SloEvaluator(
            self.objectives, registry=MetricsRegistry(),
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s).windows
        self._lock = threading.Lock()
        # guarded by: self._lock
        self._states: dict[str, _TargetState] = {}
        for t in targets:
            t = _normalize_target(t)
            self._states[t] = _TargetState(t, explicit=True,
                                           ring_depth=self.ring_depth)
        self._ticks = 0                     # guarded by: self._lock
        self._last_scrape_ms = 0.0          # guarded by: self._lock
        # (ts, {objective: (total, bad)}) — guarded by: self._lock
        self._slo_samples: deque = deque()
        self._slo_breaches: list = []       # guarded by: self._lock
        self._history: dict[str, deque] = {  # guarded by: self._lock
            "fleet_qps": deque(maxlen=self.ring_depth),
            "p99_ms": deque(maxlen=self.ring_depth),
            "scrape_ms": deque(maxlen=self.ring_depth),
        }
        # SLO breach identities already journaled as ``slo_burn`` edges.
        self._journaled_breaches = set()  # guarded by: self._lock
        # Collector's own instruments (scraping the observer works too).
        self._tm_ticks = self.registry.counter("dps_fleet_ticks_total")
        self._tm_targets = self.registry.gauge("dps_fleet_targets")
        self._tm_series = self.registry.gauge("dps_fleet_series")
        self._tm_scrape = self.registry.histogram(
            "dps_fleet_scrape_seconds", buckets=LATENCY_BUCKETS_S)
        self._tm_err: dict[str, object] = {}  # guarded by: self._lock

    # -- scraping -------------------------------------------------------------

    def _http_json(self, base: str, path: str):
        with urllib.request.urlopen(base + path,
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def _scrape_one(self, base: str) -> tuple[dict, dict | None]:
        """(metrics snapshot, cluster view or None). Prefers the exact
        ``/metrics.json`` snapshot; falls back to parsing the Prometheus
        text; a missing ``/cluster`` (404: no monitor in that process,
        e.g. a replica) is NOT an error."""
        try:
            snap = self._http_json(base, "/metrics.json")
        except urllib.error.HTTPError:
            # Target answers HTTP but has no /metrics.json (older
            # build): degrade to parsing the text exposition. Dead
            # targets (refused/timeout) skip the fallback — one bounded
            # failure, not two.
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=self.timeout_s) as r:
                snap = parse_prometheus_text(r.read().decode())
        cluster = None
        try:
            cluster = self._http_json(base, "/cluster")
        except Exception:  # noqa: BLE001 — replicas have no monitor
            pass
        return snap, cluster

    def _err_counter_locked(self, target: str):
        """Lazy-mint ``dps_fleet_scrape_errors_total{target}`` — the
        dynamic-member series-lifecycle idiom (ps/sharding.py): minted
        on first error, removed from the registry when the discovered
        target drains."""
        c = self._tm_err.get(target)
        if c is None:
            c = self.registry.counter("dps_fleet_scrape_errors_total",
                                      target=target)
            self._tm_err[target] = c
        return c

    def tick(self) -> dict:
        """One scrape round: concurrent per-target scrapes (each GET
        bounded by ``timeout_s``; a dead target marks its series stale
        and never blocks the others), discovery refresh, drain, SLO
        sample. Returns ``{"ok": n, "failed": n, "scrape_ms": ms}``."""
        t0 = time.perf_counter()
        now = self.clock()
        with self._lock:
            targets = list(self._states)
        results: dict[str, tuple] = {}
        errors: dict[str, str] = {}
        res_lock = threading.Lock()

        def scrape(base: str) -> None:
            try:
                out = self._scrape_one(base)
            except Exception as e:  # noqa: BLE001 — any failure = stale
                with res_lock:
                    errors[base] = repr(e)
                return
            with res_lock:
                results[base] = out

        threads = [threading.Thread(target=scrape, args=(t,), daemon=True,
                                    name=f"fleet-scrape-{t}")
                   for t in targets]
        for th in threads:
            th.start()
        # Each scrape makes at most 3 GETs, each socket-bounded by
        # timeout_s, so this join cannot hang the tick.
        for th in threads:
            th.join(timeout=3.0 * self.timeout_s + 1.0)
        with self._lock:
            for base in targets:
                st = self._states.get(base)
                if st is None:
                    continue
                if base in results:
                    snap, cluster = results[base]
                    try:
                        st.record(now, snap, cluster)
                    except Exception as e:  # noqa: BLE001 — bad payload
                        st.fail(now, f"bad payload: {e!r}")
                        self._err_counter_locked(base).inc()
                else:
                    st.fail(now, errors.get(base, "scrape timed out"))
                    self._err_counter_locked(base).inc()
            self._refresh_discovery_locked()
            self._sample_slo_locked(now)
            self._ticks += 1
            ms = (time.perf_counter() - t0) * 1e3
            self._last_scrape_ms = ms
            self._history["scrape_ms"].append(round(ms, 3))
            self._history["fleet_qps"].append(
                round(self._fleet_qps_locked(now), 3))
            self._history["p99_ms"].append(self._fleet_p99_ms_locked())
            self._tm_ticks.inc()
            self._tm_targets.set(len(self._states))
            self._tm_series.set(sum(
                len(s.rings) + len(s.hist_latest)
                for s in self._states.values()))
            self._tm_scrape.observe(ms / 1e3)
            ok = sum(1 for s in self._states.values() if s.ok)
            out = {"ok": ok, "failed": len(self._states) - ok,
                   "scrape_ms": round(ms, 3)}
        self._post_tick()
        return out

    def _post_tick(self) -> None:
        """Forensics fan-out, outside the collector lock: journal this
        tick's merged view (minus the history rings — replay rebuilds
        those from consecutive ticks) and new ``slo_burn`` edges, then
        feed the incident engine. All best-effort: a full disk or a
        capture failure must never stall the scrape loop."""
        if self.journal is None and self.incidents is None:
            return
        try:
            v = self.view()
        except Exception:  # noqa: BLE001 — forensics never stalls ticks
            return
        breaches = (v.get("slo") or {}).get("breaches") or []
        with self._lock:
            new = [b for b in breaches
                   if (b["rule"], b["objective"])
                   not in self._journaled_breaches]
            self._journaled_breaches = {(b["rule"], b["objective"])
                                        for b in breaches}
        if self.journal is not None:
            try:
                slim = {k: val for k, val in v.items() if k != "history"}
                if isinstance(slim.get("rollups"), dict):
                    slim["rollups"] = self._slim_rollups(slim["rollups"])
                self.journal.append("fleet_tick",
                                    {"ts": v["ts"], "view": slim})
                for b in new:
                    self.journal.append("slo_burn", dict(b))
            except Exception:  # noqa: BLE001 — disk full degrades
                pass
        if self.incidents is not None:
            try:
                self.incidents.on_fleet_view(v)
            except Exception:  # noqa: BLE001 — capture never stalls
                pass

    @staticmethod
    def _slim_rollups(roll: dict) -> dict:
        """The journaled copy of one tick's rollups, minus the
        zero-valued counter/histogram vocabulary (same rationale as
        ``SnapshotEmitter._journal_payload``: the pre-created
        alert/fault grids dominate the bytes, and replay reads an
        absent series exactly like a present zero). The live ``/fleet``
        response keeps its full-vocabulary rollups untouched."""
        out = dict(roll)
        ctr = roll.get("counters")
        if isinstance(ctr, dict):
            out["counters"] = {
                k: r for k, r in ctr.items()
                if not isinstance(r, dict)
                or r.get("sum") or r.get("rate_per_s")}
        gauges = roll.get("gauges")
        if isinstance(gauges, dict):
            out["gauges"] = {
                k: r for k, r in gauges.items()
                if not isinstance(r, dict)
                or r.get("min") or r.get("max")}
        hists = roll.get("histograms")
        if isinstance(hists, dict):
            out["histograms"] = {
                k: h for k, h in hists.items()
                if not isinstance(h, dict)
                or h.get("count") or "error" in h}
        return out

    def _refresh_discovery_locked(self) -> None:
        """Adopt replica metrics addresses announced via the primaries'
        ``/cluster`` sharding views; drain discovered targets no view
        mentions anymore (state dropped AND the per-target error series
        removed — same lifecycle as ``dps_replica_lag_*``)."""
        announced: dict[str, str] = {}
        for st in self._states.values():
            if not st.ok or not st.cluster:
                continue
            sharding = st.cluster.get("sharding") or {}
            for rep in sharding.get("replicas", []):
                maddr = rep.get("metrics")
                if maddr:
                    announced[_normalize_target(maddr)] = st.target
        for t, src in announced.items():
            if t not in self._states:
                self._states[t] = _TargetState(
                    t, explicit=False, ring_depth=self.ring_depth,
                    discovered_from=src)
        for t in [t for t, s in self._states.items()
                  if not s.explicit and t not in announced]:
            del self._states[t]
            self._tm_err.pop(t, None)
            self.registry.remove("dps_fleet_scrape_errors_total", target=t)

    # -- fleet SLO ------------------------------------------------------------

    def _merged_hist_locked(self, key: str) -> dict | None:
        snaps = [s.hist_latest[key] for s in self._states.values()
                 if s.ok and key in s.hist_latest]
        if not snaps:
            return None
        return merge_histograms(snaps)

    def _merged_counter_locked(self, key: str) -> float:
        return sum(s.latest("counters").get(key, 0.0)
                   for s in self._states.values() if s.ok)

    def _sample_slo_locked(self, now: float) -> None:
        sample: dict[str, tuple] = {}
        for obj in self.objectives:
            hkey = f"dps_rpc_server_latency_seconds{{method={obj.method}}}"
            ekey = f"dps_rpc_server_errors_total{{method={obj.method}}}"
            merged = self._merged_hist_locked(hkey)
            if merged is None:
                continue
            total = int(merged["count"])
            err = int(self._merged_counter_locked(ekey))
            if obj.threshold_s is None:
                bad = min(total, err)
            else:
                good, _ = SloEvaluator._good_upto(merged, obj.threshold_s)
                bad = min(total, (total - good) + err)
            sample[obj.name] = (total, bad)
        self._slo_samples.append((now, sample))
        horizon = now - self._slo_windows[-1].window_s * 1.5
        while len(self._slo_samples) > 1 \
                and self._slo_samples[0][0] < horizon:
            self._slo_samples.popleft()
        breaches = []
        samples = list(self._slo_samples)
        for win in self._slo_windows:
            for obj in self.objectives:
                d = SloEvaluator._window_delta(samples, obj.name, now,
                                               win.window_s)
                if d is None or d["total"] < win.min_events:
                    continue
                burn = SloEvaluator._burn(obj, d["bad"], d["total"])
                if burn >= win.burn_threshold:
                    breaches.append({
                        "rule": win.rule, "severity": win.severity,
                        "objective": obj.name, "window_s": win.window_s,
                        "burn": round(burn, 2),
                        "burn_threshold": win.burn_threshold,
                        "bad": d["bad"], "total": d["total"],
                        "scope": "fleet",
                    })
        self._slo_breaches = breaches

    def _fleet_qps_locked(self, now: float) -> float:
        qps = 0.0
        for st in self._states.values():
            if not st.ok:
                continue
            for key in st.latest("counters"):
                if key.split("{", 1)[0] in _QPS_FAMILIES:
                    r = st.rate(key, now, self.rate_window_s)
                    if r is not None:
                        qps += r
        return qps

    def _fleet_p99_ms_locked(self) -> float | None:
        merged = self._merged_hist_locked(
            "dps_rpc_server_latency_seconds{method=FetchParameters}")
        if merged is None:
            return None
        q = histogram_quantile(merged["le"], merged["counts"], 99)
        return None if q is None else round(q * 1e3, 3)

    # -- the /fleet view ------------------------------------------------------

    def _rollups_locked(self, now: float) -> dict:
        fresh = [s for s in self._states.values() if s.ok]
        counters: dict[str, dict] = {}
        gauges: dict[str, dict] = {}
        hists: dict[str, dict] = {}
        for st in fresh:
            for key, val in st.latest("counters").items():
                row = counters.setdefault(
                    key, {"sum": 0.0, "rate_per_s": 0.0, "targets": 0})
                row["sum"] += val
                r = st.rate(key, now, self.rate_window_s)
                if r is not None:
                    row["rate_per_s"] += r
                row["targets"] += 1
            for key, val in st.latest("gauges").items():
                row = gauges.get(key)
                if row is None:
                    gauges[key] = {"sum": val, "min": val, "max": val,
                                   "mean": val, "targets": 1}
                else:
                    row["sum"] += val
                    row["min"] = min(row["min"], val)
                    row["max"] = max(row["max"], val)
                    row["targets"] += 1
        for row in counters.values():
            row["sum"] = round(row["sum"], 6)
            row["rate_per_s"] = round(row["rate_per_s"], 6)
        for row in gauges.values():
            row["mean"] = round(row["sum"] / row["targets"], 6)
            row["sum"] = round(row["sum"], 6)
        hist_keys = {k for s in fresh for k in s.hist_latest}
        for key in sorted(hist_keys):
            snaps = [s.hist_latest[key] for s in fresh
                     if key in s.hist_latest]
            try:
                merged = merge_histograms(snaps)
            except ValueError as e:  # mismatched schemes: never merge
                hists[key] = {"error": str(e), "targets": len(snaps)}
                continue
            merged["targets"] = len(snaps)
            for pct, pkey in ((50, "p50_ms"), (95, "p95_ms"),
                              (99, "p99_ms")):
                q = histogram_quantile(merged["le"], merged["counts"], pct)
                merged[pkey] = None if q is None else round(q * 1e3, 3)
            hists[key] = merged
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def _tiers_locked(self) -> dict:
        primaries, replicas, workers = [], [], []
        jobs: dict[str, dict] = {}
        seen_reps: set[str] = set()
        prim_addrs: set[str] = set()
        for st in self._states.values():
            view = st.cluster
            if view is None:
                continue
            row = {"target": st.target, "ok": st.ok,
                   "role": view.get("role"), "pid": view.get("pid"),
                   "mode": view.get("mode"),
                   "global_step": view.get("global_step"),
                   "alerts": len(view.get("alerts", []))}
            sharding = view.get("sharding") or {}
            if sharding:
                row["shard_id"] = sharding.get("shard_id")
                row["map_version"] = sharding.get("map_version")
                prim_addrs.update(a for a in (sharding.get("primaries")
                                              or []) if a)
            primaries.append(row)
            for rep in sharding.get("replicas", []):
                addr = rep.get("address")
                if addr in seen_reps:
                    continue
                seen_reps.add(addr)
                replicas.append({**rep, "via": st.target})
            for w in view.get("workers", []):
                workers.append({**w, "via": st.target})
            for name, jrow in (view.get("jobs") or {}).items():
                jobs.setdefault(name, {**jrow, "via": st.target})
        # Fan-out-tree rollup (docs/SHARDING.md "Fan-out trees"): the
        # per-tier shape of the serve tree, merged across every shard.
        tiers: dict[str, dict] = {}
        for rep in replicas:
            key = str(max(1, int(rep.get("tier") or 1)))
            roll = tiers.setdefault(
                key, {"replicas": 0, "max_lag_steps": 0.0, "fetch_qps": 0.0})
            roll["replicas"] += 1
            roll["max_lag_steps"] = max(roll["max_lag_steps"],
                                        float(rep.get("lag_steps") or 0.0))
            roll["fetch_qps"] = round(
                roll["fetch_qps"] + float(rep.get("fetch_qps") or 0.0), 2)
        out = {"primaries": primaries, "replicas": replicas,
               "workers": workers, "jobs": jobs}
        if prim_addrs:
            # gRPC addresses of the shard primaries (scrape targets above
            # are metrics endpoints) — the tree renderer roots replica
            # rows whose ``parent`` is one of these.
            out["primary_addresses"] = sorted(prim_addrs)
        if tiers:
            out["replica_tiers"] = tiers
        return out

    def _slo_view_locked(self, now: float) -> dict:
        samples = list(self._slo_samples)
        breaches = list(self._slo_breaches)
        out_objs = []
        for obj in self.objectives:
            hkey = f"dps_rpc_server_latency_seconds{{method={obj.method}}}"
            merged = self._merged_hist_locked(hkey)
            entry = {
                "name": obj.name, "method": obj.method,
                "target": obj.target,
                "kind": ("latency" if obj.threshold_s is not None
                         else "availability"),
                "total": 0 if merged is None else int(merged["count"]),
            }
            if obj.threshold_s is not None:
                entry["threshold_ms"] = round(obj.threshold_s * 1e3, 3)
            if merged is not None:
                for pct, key in ((50, "p50_ms"), (95, "p95_ms"),
                                 (99, "p99_ms")):
                    q = histogram_quantile(merged["le"], merged["counts"],
                                           pct)
                    entry[key] = None if q is None else round(q * 1e3, 3)
            windows = {}
            for win in self._slo_windows:
                d = SloEvaluator._window_delta(samples, obj.name, now,
                                               win.window_s)
                if d is None:
                    d = {"total": 0, "bad": 0}
                burn = SloEvaluator._burn(obj, d["bad"], d["total"])
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
        return {"objectives": out_objs, "breaches": breaches,
                "scope": "fleet"}

    def view(self) -> dict:
        """The ``GET /fleet`` payload (schema: docs/OBSERVABILITY.md)."""
        now = self.clock()
        with self._lock:
            alerts = []
            for st in self._states.values():
                if st.cluster is None:
                    continue
                for a in st.cluster.get("alerts", []):
                    alerts.append({**a, "target": st.target})
            remediation_active = any(
                (st.cluster or {}).get("remediation", {}).get("active")
                and not (st.cluster or {}).get("remediation",
                                               {}).get("dry_run")
                for st in self._states.values())
            return {
                "ts": round(now, 3),
                "ticks": self._ticks,
                "interval_s": self.interval_s,
                "targets": [s.to_row()
                            for s in sorted(self._states.values(),
                                            key=lambda s: s.target)],
                "tiers": self._tiers_locked(),
                "rollups": self._rollups_locked(now),
                "slo": self._slo_view_locked(now),
                "alerts": alerts,
                "remediation_active": remediation_active,
                "fleet_qps": round(self._fleet_qps_locked(now), 3),
                "history": {k: list(v)
                            for k, v in self._history.items()},
                "series_count": sum(
                    len(s.rings) + len(s.hist_latest)
                    for s in self._states.values()),
                "scrape": {
                    "last_ms": round(self._last_scrape_ms, 3),
                    "targets_scraped": sum(
                        1 for s in self._states.values() if s.ok),
                },
            }

    def run_forever(self, stop: threading.Event | None = None) -> None:
        stop = stop or threading.Event()
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass
            elapsed = time.perf_counter() - t0
            stop.wait(max(0.05, self.interval_s - elapsed))


def _since_param(query: str) -> int | None:
    """``since=<tick>`` from a raw query string; None when absent or
    unparseable (the full payload)."""
    for part in query.split("&"):
        if part.startswith("since="):
            try:
                return max(0, int(part[len("since="):]))
            except ValueError:
                return None
    return None


class _FleetHandler(BaseHTTPRequestHandler):
    collector: FleetCollector  # set by start_fleet_server

    def do_GET(self):  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        if path == "/fleet":
            try:
                view = self.collector.view()
                since = _since_param(query)
                if since is not None:
                    # Incremental poll: history entry i
                    # belongs to tick (ticks - len + 1 + i), so a client
                    # that saw tick N needs exactly the last
                    # (ticks - N) entries. ``history_since`` is the
                    # capability marker: an older server ignores the
                    # query entirely and the client detects the absence
                    # and degrades to full-ring replacement.
                    delta = max(0, view["ticks"] - since)
                    view["history"] = {
                        k: (rows[-delta:] if delta else [])
                        for k, rows in view["history"].items()}
                    view["history_since"] = since
                body = json.dumps(view).encode()
                status = 200
            except Exception as e:  # noqa: BLE001
                body = json.dumps({"error": repr(e)}).encode()
                status = 500
            ctype = "application/json"
        elif path == "/metrics":
            from .prometheus import render_prometheus
            body = render_prometheus(self.collector.registry).encode()
            status = 200
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body = json.dumps({"ok": True}).encode()
            status = 200
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrape/poll noise stays off stdout
        pass


def start_fleet_server(collector: FleetCollector, port: int = 0,
                       addr: str = "0.0.0.0"
                       ) -> tuple[ThreadingHTTPServer, int]:
    """Serve ``GET /fleet`` (+ ``/metrics`` for the collector's own
    instruments) on a daemon thread. Returns (server, bound_port);
    callers own shutdown."""
    handler = type("BoundFleetHandler", (_FleetHandler,),
                   {"collector": collector})
    server = ThreadingHTTPServer((addr, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="fleet-http").start()
    return server, server.server_address[1]
