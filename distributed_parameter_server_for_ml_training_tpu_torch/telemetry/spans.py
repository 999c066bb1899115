"""Span helpers: wall-time instrumentation for the hot paths (a copy of the
JAX package's ``telemetry/spans.py``).

- ``with span(hist):`` observes a block's wall time into a histogram;
- ``t0 = now(); ...; hist.observe(now() - t0)`` inlined where every
  nanosecond is on-budget (store push/fetch). ``now`` is re-exported
  ``time.perf_counter``.
"""

from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter as now

from .registry import Counter, Histogram

__all__ = ["span", "now"]


@contextmanager
def span(hist: Histogram, counter: Counter | None = None):
    """Observe the block's wall time into ``hist`` (and bump ``counter``).

    The duration is recorded even when the body raises — a failing RPC
    still spent the wire time, and dropping error durations would bias the
    distribution toward the happy path.
    """
    t0 = now()
    try:
        yield
    finally:
        hist.observe(now() - t0)
        if counter is not None:
            counter.inc()
