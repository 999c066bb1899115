"""Live telemetry for the port: the metrics registry, span helpers, the
trace flight recorder and the goodput ledger — the parts of the JAX
package's ``telemetry/`` that the store and the worker use."""

from .goodput import GOODPUT_CATEGORIES, GoodputAccount, goodput_report
from .registry import (
    BYTES_BUCKETS,
    LATENCY_BUCKETS,
    LATENCY_BUCKETS_S,
    STALENESS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    register_build_info,
)
from .spans import now, span
from .trace import (
    SPAN_CATALOG,
    FlightRecorder,
    disable_tracing,
    enable_tracing,
    get_recorder,
    trace_enabled,
    trace_span,
)

__all__ = [
    "BYTES_BUCKETS",
    "Counter",
    "FlightRecorder",
    "GOODPUT_CATEGORIES",
    "Gauge",
    "GoodputAccount",
    "Histogram",
    "LATENCY_BUCKETS",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "SPAN_CATALOG",
    "STALENESS_BUCKETS",
    "disable_tracing",
    "enable_tracing",
    "get_recorder",
    "get_registry",
    "goodput_report",
    "now",
    "register_build_info",
    "span",
    "trace_enabled",
    "trace_span",
]
