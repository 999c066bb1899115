"""Memory telemetry: the card's allocator stats + host RSS, with a
leak-slope rule.

The JAX package's ``telemetry/memory.py`` with the card read through
``torch.cuda``. A worker whose host arrays leak or whose device
allocator creeps toward its limit dies by OOM with no recorded warning;
this module is the sampling half of the ``memory_growth`` health rule
(:mod:`.health`):

- **Device memory** via :func:`read_device_memory` — the caching
  allocator's stats on a card (``None`` on the CPU, as the JAX package's
  is on a CPU backend) — exported as ``dps_device_memory_bytes{kind=...}``
  gauges for the :data:`DEVICE_MEMORY_KINDS`, the JAX package's keys.
- **Host RSS** from ``/proc/self/status`` (``VmRSS``/``VmHWM``, stdlib
  only, graceful ``None`` off Linux) exported as
  ``dps_host_rss_bytes``.
- **Failed reads** never raise out of the sampler: each is counted in
  ``dps_memory_read_errors_total{source=host|device}`` and the first of
  each source is logged on stderr, so a broken allocator read on a card
  reads apart from a CPU process, whose device block is None by design.
- **Leak slope**: a least-squares line through the RSS samples in a
  sliding window; the slope (bytes/s) rides the monitor's
  ``ClusterState.memory`` verdict into the rule engine, which fires
  ``memory_growth`` when sustained growth crosses the threshold.

Attached to :class:`~.cluster.ClusterMonitor` like the SLO evaluator
(``monitor.memory = MemoryMonitor(...)``); ``observe()`` self-paces on
``interval_s`` so the monitor can call it every evaluation tick.
"""

from __future__ import annotations

import sys
import time
from collections import deque

from .registry import MetricsRegistry, get_registry

__all__ = [
    "DEVICE_MEMORY_KINDS",
    "DEVICE_MEMORY_METRIC",
    "HOST_RSS_METRIC",
    "MemoryMonitor",
    "READ_ERRORS_METRIC",
    "read_device_memory",
    "read_host_rss",
]

HOST_RSS_METRIC = "dps_host_rss_bytes"
DEVICE_MEMORY_METRIC = "dps_device_memory_bytes"
READ_ERRORS_METRIC = "dps_memory_read_errors_total"

#: Device-memory keys exported as gauge labels: the JAX package's (the
#: stable core of the jax allocator stats), which :func:`read_device_memory`
#: fills from ``torch.cuda``.
DEVICE_MEMORY_KINDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def read_host_rss() -> dict | None:
    """``{"rss_bytes", "peak_rss_bytes"}`` from ``/proc/self/status``
    (``VmRSS`` / ``VmHWM``, kB lines), or None off Linux / on any read
    failure. Stdlib only — no psutil dependency."""
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="replace") as f:
            text = f.read()
    except OSError:
        return None
    out = {}
    for line in text.splitlines():
        for field, key in (("VmRSS:", "rss_bytes"),
                           ("VmHWM:", "peak_rss_bytes")):
            if line.startswith(field):
                parts = line.split()
                try:
                    out[key] = int(parts[1]) * 1024
                except (IndexError, ValueError):
                    pass
    return out if "rss_bytes" in out else None


def read_device_memory(device="cuda") -> dict | None:
    """One device's allocator stats under the JAX package's
    :data:`DEVICE_MEMORY_KINDS` plus the device kind, or None when the
    device is the CPU (no allocator stats, as on the JAX package's CPU
    backend).

    On a card: ``bytes_in_use`` is the caching allocator's
    ``allocated_bytes.all.current``, ``peak_bytes_in_use`` its
    ``allocated_bytes.all.peak`` (counted from the process's last
    ``torch.cuda.reset_peak_memory_stats()``: a caller that resets it,
    as ``chip_smoke.py``'s phases do, moves it), ``bytes_limit`` the
    card's total memory and ``device_kind`` its name, both from
    ``torch.cuda.get_device_properties``. Only ``device`` is read, and
    nothing here creates a CUDA context: the allocator's counters live
    on the host, and the total comes from the properties, not from
    ``mem_get_info``, which would create one. A process that never used
    the card (a host-store ``serve``) so reads 0 bytes in use and leaves
    the card to the processes that compute on it. A ``cuda`` device
    never reads as None: without a usable card, or when a read fails,
    this raises. (torch is imported here, not with the module: the
    telemetry package loads in the serve tier's host processes without
    it.)"""
    import torch

    from ..utils.device import resolve_device
    dev = torch.device(device)
    if dev.type == "cpu":
        return None
    dev = resolve_device(dev)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    stats = torch.cuda.memory_stats(index)
    return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "bytes_limit": int(props.total_memory),
            "device_kind": props.name}


def _slope_bytes_per_s(samples) -> float | None:
    """Least-squares slope through ``[(ts, bytes), ...]``; None below
    two distinct timestamps."""
    n = len(samples)
    if n < 2:
        return None
    t0 = samples[0][0]
    xs = [t - t0 for t, _ in samples]
    ys = [float(v) for _, v in samples]
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    denom = sum((x - mean_x) ** 2 for x in xs)
    if denom <= 0:
        return None
    return sum((x - mean_x) * (y - mean_y)
               for x, y in zip(xs, ys)) / denom


class MemoryMonitor:
    """Periodic sampler + windowed leak-slope detector.

    ``rss_fn`` / ``device_fn`` are injectable for tests (fake clocks and
    seeded leaks); real callers take the defaults, or bind
    :func:`read_device_memory` to their own ``--device``. Not thread-safe by
    itself — the cluster monitor calls ``observe`` under its own lock,
    the same discipline as the rule engine.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 interval_s: float = 5.0, window_s: float = 120.0,
                 clock=time.time, rss_fn=read_host_rss,
                 device_fn=read_device_memory):
        if interval_s <= 0 or window_s <= 0:
            raise ValueError("interval_s and window_s must be > 0")
        reg = registry or get_registry()
        self.interval_s = float(interval_s)
        self.window_s = float(window_s)
        self.clock = clock
        self._rss_fn = rss_fn
        self._device_fn = device_fn
        # Literal names at the registration sites (== HOST_RSS_METRIC /
        # DEVICE_MEMORY_METRIC): the metric<->doc drift pin extracts
        # registrations textually.
        self._tm_rss = reg.gauge("dps_host_rss_bytes")
        self._tm_device = {
            k: reg.gauge("dps_device_memory_bytes", kind=k)
            for k in DEVICE_MEMORY_KINDS
        }
        self._tm_read_errors = {
            src: reg.counter("dps_memory_read_errors_total", source=src)
            for src in ("host", "device")
        }
        self._logged_errors: set = set()
        self._samples: deque = deque()  # (ts, rss_bytes)
        self._last_sample_ts: float | None = None
        self._last: dict = {}

    def sample(self, now: float | None = None) -> dict:
        """Take one sample unconditionally; returns the verdict."""
        now = self.clock() if now is None else now
        self._last_sample_ts = now
        host = self._read("host", self._rss_fn)
        device = self._read("device", self._device_fn)
        if host:
            self._tm_rss.set(host["rss_bytes"])
            self._samples.append((now, host["rss_bytes"]))
            cutoff = now - self.window_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
        if device:
            for k in DEVICE_MEMORY_KINDS:
                if k in device:
                    self._tm_device[k].set(device[k])
        self._last = self._verdict(host, device)
        return self._last

    def _read(self, source: str, fn):
        """``fn()``, or None when it raises: the failure is counted and
        the first one of ``source`` logged (sampling never raises out)."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — counted and logged
            self._tm_read_errors[source].inc()
            if source not in self._logged_errors:
                self._logged_errors.add(source)
                print(f"memory telemetry: {source} read failed: {e!r} "
                      f"(counted in {READ_ERRORS_METRIC})",
                      file=sys.stderr, flush=True)
            return None

    def observe(self, now: float | None = None) -> dict:
        """Self-paced sample: re-samples only once per ``interval_s``,
        otherwise returns the last verdict (the monitor calls this every
        evaluation tick)."""
        now = self.clock() if now is None else now
        if self._last_sample_ts is None \
                or now - self._last_sample_ts >= self.interval_s:
            return self.sample(now)
        return self._last

    def _verdict(self, host, device) -> dict:
        span = 0.0
        if len(self._samples) >= 2:
            span = self._samples[-1][0] - self._samples[0][0]
        return {
            "rss_bytes": (host or {}).get("rss_bytes"),
            "peak_rss_bytes": (host or {}).get("peak_rss_bytes"),
            "growth_bytes_per_s": _slope_bytes_per_s(self._samples),
            "window_span_s": round(span, 3),
            "samples": len(self._samples),
            "device": device,
        }
