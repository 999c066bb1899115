"""Analysis layer of the port: the JAX package's ``analysis/`` parts that
read what the port's telemetry writes — flight-recorder span dumps
(:mod:`.traces`: assembly, Perfetto export, critical-path attribution)
and profiler captures (:mod:`.device_profile`: per-op-class device time,
diffs). The log parsers, incident timelines, fleet series, runners and
plots come with ROADMAP §1 item 8's rest."""

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
from .traces import (
    PHASES,
    assemble_traces,
    critical_path_report,
    find_trace_dumps,
    load_trace_dumps,
    save_chrome_trace,
    to_chrome_trace,
)

__all__ = ["CUDA_DEVICE_CATEGORIES", "OP_CLASSES", "PHASES",
           "assemble_traces", "attribute_profile", "classify_op",
           "critical_path_report", "device_time_tables", "diff_profiles",
           "find_trace_dumps", "load_chrome_trace", "load_trace_dumps",
           "render_profile_diff", "render_profile_table",
           "save_chrome_trace", "to_chrome_trace", "top_device_ops"]
