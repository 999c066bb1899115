"""Analysis layer of the port: the JAX package's ``analysis/`` under its
names — log parsing into experiment records (:mod:`.parse_logs`),
profiler captures (:mod:`.device_profile`: per-op-class device time,
diffs), fleet-view exemplars (:mod:`.fleet_series`), incident timelines
over the journal (:mod:`.incidents`), flight-recorder span dumps
(:mod:`.traces`: assembly, Perfetto export, critical-path attribution),
pod log ingestion (:mod:`.pod_logs`), the experiment matrix
(:mod:`.runner`) and its plots (:mod:`.visualize`)."""

from .parse_logs import (
    aggregate_worker_metrics,
    alert_timeline,
    build_telemetry_timeseries,
    cluster_worker_series,
    parse_cluster_series,
    parse_experiment,
    parse_snapshot_series,
    staleness_series,
    worker_throughput_series,
)
from .device_profile import (
    CUDA_DEVICE_CATEGORIES,
    OP_CLASSES,
    attribute_profile,
    classify_op,
    device_time_tables,
    diff_profiles,
    load_chrome_trace,
    render_profile_diff,
    render_profile_table,
    top_device_ops,
)
from .fleet_series import extract_exemplars, resolve_exemplars
from .incidents import (
    PHASE_ORDER,
    build_timeline,
    classify_event,
    describe_event,
    list_incidents,
    load_incident,
    render_timeline,
)
from .runner import RECORD_KEYS, run_cell, run_matrix
from .traces import (
    PHASES,
    assemble_traces,
    critical_path_report,
    find_trace_dumps,
    load_trace_dumps,
    save_chrome_trace,
    to_chrome_trace,
)
from .visualize import ExperimentVisualizer

__all__ = ["CUDA_DEVICE_CATEGORIES", "OP_CLASSES", "PHASES", "PHASE_ORDER",
           "RECORD_KEYS",
           "aggregate_worker_metrics", "alert_timeline",
           "assemble_traces", "attribute_profile",
           "build_telemetry_timeseries", "build_timeline",
           "classify_event", "classify_op",
           "cluster_worker_series",
           "critical_path_report", "describe_event",
           "device_time_tables", "diff_profiles",
           "extract_exemplars",
           "list_incidents", "load_incident", "render_timeline",
           "find_trace_dumps", "load_chrome_trace", "load_trace_dumps",
           "resolve_exemplars",
           "parse_cluster_series",
           "parse_experiment", "parse_snapshot_series",
           "render_profile_diff", "render_profile_table",
           "save_chrome_trace", "staleness_series", "to_chrome_trace",
           "top_device_ops", "worker_throughput_series",
           "ExperimentVisualizer", "run_cell", "run_matrix"]
