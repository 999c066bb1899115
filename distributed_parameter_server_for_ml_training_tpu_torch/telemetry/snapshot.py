"""Periodic registry flush as incremental ``METRICS_JSON`` snapshot lines.

The JAX package's ``telemetry/snapshot.py``, carried over whole (it is
framework-neutral) with the port's registry and emitter. The reference's
ETL regex-scrapes ``METRICS_JSON: {...}`` from process logs
(parse_cloudwatch_logs.py:100); this emitter rides the SAME convention —
``utils.metrics.emit_metrics_json`` prints the line. Snapshot payloads
are distinguished by ``"kind": "snapshot"``; the final-stats exit line
has no ``kind`` field.

Snapshot line shape::

    METRICS_JSON: {"kind": "snapshot", "seq": 3, "ts": 1724...,
                   "uptime_seconds": 15.2, "role": "server", "pid": 1234,
                   "counters": {...}, "gauges": {...}, "histograms": {...}}

Values are CUMULATIVE (counters monotonic since process start, histograms
full bucket counts); consumers derive rates from consecutive-snapshot
deltas. Cumulative beats per-interval deltas on a lossy transport: a
dropped line costs one sample, not a permanently skewed running total.
With a journal attached, each snapshot is also journaled (zeros dropped)
and the journal is sealed at stop.
"""

from __future__ import annotations

import os
import threading
import time
from typing import IO

from ..utils.metrics import emit_metrics_json
from .registry import MetricsRegistry, get_registry


class SnapshotEmitter:
    """Daemon thread flushing a registry every ``interval`` seconds.

    ``proc`` labels (role, worker name, ...) are merged into every line so a
    multi-process run's interleaved stdout remains attributable. ``stop()``
    always emits one final snapshot — a run shorter than one interval still
    leaves a complete record (the failure mode this guards against is
    "process died, nothing written").
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 interval: float = 5.0, role: str = "process",
                 proc: dict | None = None, stream: IO | None = None,
                 journal=None, clock=time.time):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.registry = registry or get_registry()
        self.interval = float(interval)
        self.proc = {"role": role, "pid": os.getpid(), **(proc or {})}
        self.stream = stream
        self.journal = journal  # guarded by: self._emit_lock
        self.clock = clock
        self.seq = 0  # guarded by: self._emit_lock
        self._t0 = clock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._emit_lock = threading.Lock()  # tick vs final-flush race

    def emit_once(self) -> dict:
        """Emit one snapshot line; returns the payload (tests, callers)."""
        with self._emit_lock:
            self.seq += 1
            payload = {
                "kind": "snapshot",
                "seq": self.seq,
                "ts": round(self.clock(), 3),
                "uptime_seconds": round(self.clock() - self._t0, 3),
                **self.proc,
                **self.registry.snapshot(),
            }
            emit_metrics_json(payload, self.stream)
            if self.journal is not None:
                try:
                    self.journal.append("snapshot",
                                        self._journal_payload(payload))
                except Exception:  # noqa: BLE001 — durability is
                    pass           # best-effort beside the live line
            return payload

    @staticmethod
    def _journal_payload(payload: dict) -> dict:
        """The journaled copy of one snapshot, minus the zero-valued
        counter/histogram vocabulary. The live METRICS_JSON line keeps
        zeros on purpose (scrapes must show the full vocabulary), but
        journaling the pre-created alert/fault grids re-serializes
        kilobytes of zeros every interval — measured ~72% of the bytes.
        Retro-query math is cumulative, so an absent series reads as
        zero exactly like a present zero did."""
        out = {k: v for k, v in payload.items() if k != "kind"}
        for group in ("counters", "gauges"):
            vals = out.get(group)
            if isinstance(vals, dict):
                out[group] = {k: v for k, v in vals.items() if v}
        hists = out.get("histograms")
        if isinstance(hists, dict):
            out["histograms"] = {
                k: h for k, h in hists.items()
                if not isinstance(h, dict) or h.get("count")}
        return out

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.emit_once()

    def flush_now(self) -> None:
        """Shutdown-hook form of :meth:`emit_once`: flush one final
        snapshot unless the emitter was already stopped (whose ``stop``
        emitted the final line). Registered with
        ``telemetry.add_shutdown_flush`` so a SIGTERM'd process's tail
        interval is never silently dropped. Also seals the journal
        segment: the shutdown path must
        leave a crash-consistent, fsync'd tail on disk."""
        if not self._stop.is_set():
            self.emit_once()
        self._seal_journal()

    def start(self) -> "SnapshotEmitter":
        if self._thread is not None:
            raise RuntimeError("emitter already started")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-snapshot")
        self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        """Stop the loop; ``final=True`` (default) flushes a last snapshot
        so the stream always ends with the process's complete totals."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, self.interval))
            self._thread = None
        if final:
            self.emit_once()
            self._seal_journal()

    def _seal_journal(self) -> None:
        with self._emit_lock:
            if self.journal is not None:
                try:
                    self.journal.seal()
                except Exception:  # noqa: BLE001 — shutdown never raises
                    pass

    def __enter__(self) -> "SnapshotEmitter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(final=True)
