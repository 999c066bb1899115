from .device import resolve_device
from .metrics import Stopwatch, emit_metrics_json, parse_metrics_lines
from .pytree import flatten_params, tree_bytes, unflatten_params

__all__ = ["Stopwatch", "emit_metrics_json", "flatten_params",
           "parse_metrics_lines", "resolve_device", "tree_bytes",
           "unflatten_params"]
