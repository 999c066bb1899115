"""Small helpers of the port: the device resolver, the metrics lines,
the flax <-> torch parameter adapter and the collective-bytes counter.

The names are loaded on first use (PEP 562), so a host process that
needs only the metrics lines (the serve tier's) does not import torch.
"""

import importlib

#: name -> the submodule that defines it.
_EXPORTS = {"resolve_device": "device", "Stopwatch": "metrics",
            "emit_metrics_json": "metrics", "parse_metrics_lines": "metrics",
            "flatten_params": "pytree", "tree_bytes": "pytree",
            "unflatten_params": "pytree"}


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                            __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = ["Stopwatch", "emit_metrics_json", "flatten_params",
           "parse_metrics_lines", "resolve_device", "tree_bytes",
           "unflatten_params"]
