"""Live telemetry for the port: the metrics registry, span helpers, the
trace flight recorder, the goodput ledger, the journal, the cluster
health layer (the rule engine, the server's cluster monitor with its SLO
evaluator, and the remediation engine), and the process surfaces: the
snapshot stream, the Prometheus endpoint (``/metrics``, ``/healthz``,
``/cluster``, ``/debug/trace``), memory telemetry, incident capture, the
profiler bracket with its FLOP accounting, trigger-driven profiling,
the fleet observatory's collector and the replica autoscaler — the JAX
package's ``telemetry/`` under its names."""

from .autoscale import AutoscalePolicy, ReplicaAutoscaler
from .cluster import (
    ClusterMonitor,
    get_cluster_monitor,
    sanitize_report,
    set_cluster_monitor,
)
from .fleet import (
    FLEET_ROLLUP_FIELDS,
    FleetCollector,
    parse_prometheus_text,
    start_fleet_server,
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
from .incidents import MANIFEST_FIELDS, IncidentCapture
from .journal import (
    EVENT_CATALOG,
    JournalReader,
    JournalWriter,
    get_journal,
    journal_event,
    read_journal,
    set_journal,
)
from .memory import MemoryMonitor, read_device_memory, read_host_rss
from .proftrigger import PROFILE_RECORD_FIELDS, ProfileTrigger
from .prometheus import render_prometheus, start_metrics_server
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
from .snapshot import SnapshotEmitter
from .spans import now, span
from .stats import histogram_quantile, merge_histograms
from .trace import (
    SPAN_CATALOG,
    FlightRecorder,
    TraceContext,
    add_shutdown_flush,
    current_context,
    current_wire_trace,
    disable_tracing,
    enable_tracing,
    get_recorder,
    install_shutdown_hooks,
    remove_shutdown_flush,
    trace_enabled,
    trace_span,
    use_wire_context,
)

__all__ = [
    "ACTION_CATALOG",
    "Alert",
    "AutoscalePolicy",
    "BYTES_BUCKETS",
    "ClusterMonitor",
    "ClusterState",
    "Counter",
    "EVENT_CATALOG",
    "FLEET_ROLLUP_FIELDS",
    "FleetCollector",
    "FlightRecorder",
    "GOODPUT_CATEGORIES",
    "Gauge",
    "GoodputAccount",
    "HealthRuleEngine",
    "HealthThresholds",
    "Histogram",
    "IncidentCapture",
    "JournalReader",
    "JournalWriter",
    "LATENCY_BUCKETS",
    "LATENCY_BUCKETS_S",
    "MANIFEST_FIELDS",
    "MemoryMonitor",
    "MetricsRegistry",
    "PROFILE_RECORD_FIELDS",
    "ProfileTrigger",
    "RULE_CATALOG",
    "RemediationEngine",
    "RemediationPolicy",
    "ReplicaAutoscaler",
    "SEVERITIES",
    "SPAN_CATALOG",
    "STALENESS_BUCKETS",
    "SloEvaluator",
    "SloObjective",
    "SnapshotEmitter",
    "TraceContext",
    "WorkerAutoscalePolicy",
    "WorkerAutoscaler",
    "WorkerState",
    "add_shutdown_flush",
    "current_context",
    "current_wire_trace",
    "default_objectives",
    "disable_tracing",
    "enable_tracing",
    "get_cluster_monitor",
    "get_journal",
    "get_recorder",
    "get_registry",
    "goodput_report",
    "histogram_quantile",
    "install_shutdown_hooks",
    "journal_event",
    "merge_histograms",
    "note_action",
    "now",
    "parse_prometheus_text",
    "read_device_memory",
    "read_host_rss",
    "read_journal",
    "register_build_info",
    "remove_shutdown_flush",
    "render_prometheus",
    "sanitize_report",
    "set_cluster_monitor",
    "set_journal",
    "start_fleet_server",
    "span",
    "start_metrics_server",
    "trace_enabled",
    "trace_span",
    "use_wire_context",
]
