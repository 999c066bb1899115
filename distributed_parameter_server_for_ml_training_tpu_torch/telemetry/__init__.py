"""Live telemetry for the port: the metrics registry, span helpers, the
trace flight recorder, the goodput ledger, and the cluster health layer
(the rule engine, the server's cluster monitor with its SLO evaluator,
and the remediation engine) — the parts of the JAX package's
``telemetry/`` that the store, the service and the worker use."""

from .cluster import (
    ClusterMonitor,
    get_cluster_monitor,
    sanitize_report,
    set_cluster_monitor,
)
from .goodput import GOODPUT_CATEGORIES, GoodputAccount, goodput_report
from .health import (
    RULE_CATALOG,
    SEVERITIES,
    Alert,
    ClusterState,
    HealthRuleEngine,
    HealthThresholds,
    WorkerState,
)
from .journal import journal_event
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
from .remediation import (
    ACTION_CATALOG,
    RemediationEngine,
    RemediationPolicy,
    WorkerAutoscalePolicy,
    WorkerAutoscaler,
    note_action,
)
from .slo import SloEvaluator, SloObjective, default_objectives
from .spans import now, span
from .stats import histogram_quantile
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
    "ACTION_CATALOG",
    "Alert",
    "BYTES_BUCKETS",
    "ClusterMonitor",
    "ClusterState",
    "Counter",
    "FlightRecorder",
    "GOODPUT_CATEGORIES",
    "Gauge",
    "GoodputAccount",
    "HealthRuleEngine",
    "HealthThresholds",
    "Histogram",
    "LATENCY_BUCKETS",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "RULE_CATALOG",
    "RemediationEngine",
    "RemediationPolicy",
    "SEVERITIES",
    "SPAN_CATALOG",
    "STALENESS_BUCKETS",
    "SloEvaluator",
    "SloObjective",
    "WorkerAutoscalePolicy",
    "WorkerAutoscaler",
    "WorkerState",
    "default_objectives",
    "disable_tracing",
    "enable_tracing",
    "get_cluster_monitor",
    "get_recorder",
    "get_registry",
    "goodput_report",
    "histogram_quantile",
    "journal_event",
    "note_action",
    "now",
    "register_build_info",
    "sanitize_report",
    "set_cluster_monitor",
    "span",
    "trace_enabled",
    "trace_span",
]
