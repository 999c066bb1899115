"""In-process metrics registry: counters, gauges, fixed-bucket histograms.

A copy of the JAX package's ``telemetry/registry.py`` (stdlib only): hot
paths record into process-global instruments created once and held as
attributes; every instrument guards its state with its own small lock;
histograms use the same fixed bucket schemes, so snapshots from a port
process and a JAX process aggregate without schema negotiation. Build
info reports the torch and CUDA versions instead of jax's.
"""

from __future__ import annotations

import sys
import threading
import time
from bisect import bisect_left

#: Wall-time buckets (seconds): 100 us .. 60 s, roughly 1-2.5-5 per decade.
#: Covers everything from a device-store dict copy to a cold sync round.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: THE shared scheme for recorded durations (SLO-grade serving latency):
#: 250 us .. 30 s with extra resolution through the 1-100 ms band where
#: RPC handler latencies and SLO thresholds live — a p99 objective at
#: 50/75/100 ms needs an edge AT the threshold for bucket-counting
#: "good" events to be exact, which the coarser LATENCY_BUCKETS_S
#: (jumping 25 -> 50 -> 100 ms) cannot give. New duration histograms use
#: this scheme; LATENCY_BUCKETS_S remains for the pre-existing series
#: whose committed snapshot history pins their edges.
LATENCY_BUCKETS = (
    0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.0075, 0.01, 0.025, 0.05,
    0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: Payload-size buckets (bytes): 1 KiB .. 1 GiB in x4 steps. The ResNet-18
#: fp32 payload (~45 MB, the reference's dominant wire term, server.py:222)
#: lands mid-scheme; its fp16/int8 codec forms land one/two buckets lower.
BYTES_BUCKETS = (
    1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10,
    1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20, 1 << 30,
)

#: Async staleness buckets (versions behind, server.py:293-294 semantics).
#: Dense through the default bound (DEFAULT_STALENESS_BOUND = 5) so the
#: bounded region is fully resolved, then doubling to the 32-worker cap.
STALENESS_BUCKETS = (0, 1, 2, 3, 4, 5, 8, 16, 32)

#: Value-magnitude buckets (dimensionless, log scale): 1e-4 .. 1e2 at
#: ~1-2.5-5 per decade, then decades to 1e6. The latency/byte schemes above
#: are wrong for LOSS and GRADIENT-NORM magnitudes — a cross-entropy loss
#: lives around 1-5, a healthy grad norm anywhere in 1e-2..1e2, and the
#: interesting excursions (vanishing grads, explosions) are orders of
#: magnitude in either direction. An observation past the last edge
#: (incl. any finite overflow) lands in the +Inf bucket.
VALUE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    1000.0, 10000.0, 100000.0, 1000000.0,
)


def _label_key(labels: dict) -> str:
    """Stable ``name{k=v,...}`` suffix; '' for an unlabelled instrument."""
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotonic float counter. ``inc`` rejects negative deltas — the
    monotonicity contract is what lets the ETL derive rates from snapshot
    deltas without sentinel handling."""

    __slots__ = ("name", "labels", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0  # guarded by: self._lock
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (global step, live worker count, last accuracy)."""

    __slots__ = ("name", "labels", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0  # guarded by: self._lock
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts (NON-cumulative), sum, and
    count. ``le`` edges are upper bounds; observations above the last edge
    land in the implicit overflow bucket (rendered ``+Inf`` on the
    Prometheus surface, stored as the final count here).

    An observation may carry an **exemplar** — a trace id sampled by the
    caller (:class:`ExemplarSampler` head sampling) — and the histogram
    keeps the LAST exemplar per bucket: one bounded dict regardless of
    traffic, so a fleet p99 spike in a high bucket always points at a
    recent trace that actually landed there (docs/OBSERVABILITY.md,
    "Fleet observatory").
    """

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count",
                 "_exemplars", "_lock")
    kind = "histogram"

    def __init__(self, name: str, buckets=LATENCY_BUCKETS_S,
                 labels: dict | None = None):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be a sorted, "
                             f"non-empty sequence, got {buckets!r}")
        self.name = name
        self.labels = dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        # guarded by: self._lock
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = overflow
        self._sum = 0.0  # guarded by: self._lock
        self._count = 0  # guarded by: self._lock
        self._exemplars: dict[int, dict] = {}  # guarded by: self._lock
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: str | None = None) -> None:
        v = float(v)
        i = bisect_left(self.buckets, v)
        if exemplar is None:
            with self._lock:
                self._counts[i] += 1
                self._sum += v
                self._count += 1
            return
        ex = {"trace_id": exemplar, "value": v, "ts": time.time()}
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._exemplars[i] = ex

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        """JSON-ready view: edges + per-bucket (non-cumulative) counts.
        ``exemplars`` (bucket index, as a string for JSON round-trips ->
        ``{trace_id, value, ts}``) appears only when at least one
        observation carried one — exemplar-free histograms keep the
        exact pre-exemplar snapshot shape."""
        with self._lock:
            out = {"le": list(self.buckets),
                   "counts": list(self._counts),
                   "sum": self._sum,
                   "count": self._count}
            if self._exemplars:
                out["exemplars"] = {str(i): dict(ex)
                                    for i, ex in self._exemplars.items()}
            return out


class ExemplarSampler:
    """Deterministic head sampler for exemplar attachment.

    Counter-based, same discipline as the serving canary split
    (comms/replica.py CanaryController): a rate of ``r`` becomes "every
    round(1/r)-th call samples", with a seed-derived phase so co-started
    processes don't all sample the same beat. No RNG on the hot path —
    one lock'd increment + modulo — which keeps the cost inside the
    hot-path budget and makes sampling decisions reproducible under a
    fixed seed.
    """

    __slots__ = ("period", "_n", "_phase", "_lock")

    def __init__(self, rate: float = 0.1, seed: int = 0):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"exemplar rate must be in (0, 1], got {rate}")
        self.period = max(1, round(1.0 / rate))
        self._phase = seed % self.period
        self._n = 0  # guarded by: self._lock
        self._lock = threading.Lock()

    def sample(self) -> bool:
        """True when this call should attach an exemplar."""
        with self._lock:
            n = self._n
            self._n += 1
        return n % self.period == self._phase


class MetricsRegistry:
    """Get-or-create instrument factory + read-side collection surface.

    Identity is (name, sorted labels): two ``counter()`` calls with the same
    name+labels return the SAME object, so call sites never coordinate.
    Re-requesting a name as a different kind (or a histogram with different
    buckets) raises — silent aliasing would corrupt both surfaces.
    """

    def __init__(self):
        self._instruments: dict[str, object] = {}  # guarded by: self._lock
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, labels: dict, **kwargs):
        key = name + _label_key(labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels=labels, **kwargs)
                self._instruments[key] = inst
                return inst
        if not isinstance(inst, cls):
            raise TypeError(f"metric {key!r} already registered as "
                            f"{inst.kind}, requested {cls.kind}")
        if kwargs.get("buckets") is not None \
                and inst.buckets != tuple(float(b)
                                          for b in kwargs["buckets"]):
            raise ValueError(f"histogram {key!r} already registered with "
                             f"buckets {inst.buckets}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, buckets=buckets)

    def remove(self, name: str, **labels) -> bool:
        """Drop one labelled series from both read surfaces. Returns
        whether anything was removed. This is the lifecycle half the
        get-or-create idiom lacks: a label set keyed on a DYNAMIC member
        (``dps_replica_lag_steps{replica=...}``) outlives the member and
        serves its last value forever unless the owner that learned of
        the departure removes the series. Holders keeping a stale
        reference can still record into it; it just stops being
        collected — and a later get-or-create mints a fresh instrument.
        """
        key = name + _label_key(labels)
        with self._lock:
            return self._instruments.pop(key, None) is not None

    def collect(self) -> list:
        """All live instruments, sorted by key (stable output ordering)."""
        with self._lock:
            return [self._instruments[k] for k in sorted(self._instruments)]

    def snapshot(self) -> dict:
        """One JSON-serializable view of everything, grouped by kind:
        ``{"counters": {key: value}, "gauges": {...},
        "histograms": {key: {le, counts, sum, count}}}``. Keys carry their
        labels inline (``name{k=v}``) so the snapshot needs no side table.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in self.collect():
            key = inst.name + _label_key(inst.labels)
            out[inst.kind + "s"][key] = inst.snapshot()
        return out

    def reset(self) -> None:
        """Drop every instrument (tests; never called on a live process —
        holders keep stale references)."""
        with self._lock:
            self._instruments.clear()


#: Process-global default registry. Hot paths (stores, RPC client/service,
#: workers, trainers) record here; the snapshot emitter and Prometheus
#: endpoint read from here. Tests that need isolation construct their own
#: MetricsRegistry — they don't reset the global one mid-run.
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def register_build_info(registry: MetricsRegistry | None = None) -> Gauge:
    """Register the ``dps_build_info`` gauge (value 1; the information is
    in the labels: package version, torch version, host platform) — the
    standard Prometheus idiom for fleet-wide scrape correlation: join any
    other series on the target to see which build produced it. The torch
    version comes from the installed package's metadata, so host-only
    processes (``cli supervise``, ``cli replica``, ``cli reshard``) serve
    it without importing torch."""
    import importlib.metadata

    from .. import __version__
    g = (registry or get_registry()).gauge(
        "dps_build_info", version=__version__,
        torch=importlib.metadata.version("torch"), platform=sys.platform)
    g.set(1)
    return g
