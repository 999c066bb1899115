"""Profiler capture + achieved-FLOPs accounting for the hot loop.

The JAX package's ``telemetry/profiler.py`` on ``torch.profiler``: the
write half of the perf observatory (the read half is
:mod:`..analysis.device_profile`):

- :func:`capture` — the capture bracket (``utils.tracing.trace``,
  re-exported here so profiler consumers have one import surface) plus
  dump discovery and pruning, as in the JAX package.
- :func:`step_cost` — the counterpart of the JAX package's
  ``compiled_cost``: the FLOPs of ONE step, counted while it runs under
  ``torch.utils.flop_counter.FlopCounterMode``, in the same
  ``{"flops", "bytes_accessed"}`` shape.
- :func:`mfu` — achieved / peak FLOPs. Peak comes from
  :data:`PEAK_FLOPS_BY_KIND` keyed on the device kind
  (``torch.cuda.get_device_name()`` on a card); an unknown kind yields
  ``None`` rather than an invented number — an MFU against a guessed
  peak is worse than no MFU.
"""

from __future__ import annotations

import glob
import os

import torch

from ..utils.tracing import trace as _trace

__all__ = [
    "PEAK_FLOPS_BY_KIND",
    "capture",
    "find_profile_dumps",
    "mfu",
    "peak_flops",
    "prune_capture",
    "step_cost",
]

#: device_kind -> peak dense-matmul FLOP/s at the precision the training
#: step actually runs (bf16; CPU kinds have no meaningful peak and are
#: deliberately absent). Sources: cloud TPU spec sheets (v4 275 TF bf16;
#: v5e 197 TF bf16; v5p 459 TF bf16), kept so an artifact of either
#: package reads the same; NVIDIA's H100 SXM data sheet (989.4 TF dense
#: bf16), under the name ``torch.cuda.get_device_name()`` gives.
PEAK_FLOPS_BY_KIND = {
    "TPU v4": 275.0e12,
    "TPU v5 lite": 197.0e12,
    "TPU v5e": 197.0e12,
    "TPU v5p": 459.0e12,
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def capture(logdir: str, device: str | torch.device = "cuda"):
    """Profiler capture bracket: ``with capture(dir): hot_loop()``.

    Creates ``logdir`` and brackets the body with ``torch.profiler`` on
    ``device`` (CPU and CUDA activities on a card; CPU only when the
    caller asks for the CPU); the dump lands under
    ``logdir/plugins/profile/<timestamp>/`` (one gzipped Chrome-format
    ``*.pt.trace.json.gz`` per process)."""
    os.makedirs(logdir, exist_ok=True)
    return _trace(logdir, device)


def find_profile_dumps(logdir: str) -> list[str]:
    """Chrome-trace files under a capture dir, newest run first.

    Accepts the capture root (scans ``plugins/profile/*/``), a specific
    run dir, or a direct path to one trace file."""
    if os.path.isfile(logdir):
        return [logdir]
    found: list[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        found += glob.glob(os.path.join(
            logdir, "plugins", "profile", "*", pat))
        found += glob.glob(os.path.join(logdir, pat))
    # Newest capture first: the run timestamp is the parent dir name.
    return sorted(set(found), key=lambda p: (os.path.dirname(p), p),
                  reverse=True)


def prune_capture(logdir: str) -> list[str]:
    """Delete the raw profiler dump under a capture dir once attribution
    has JOINED it into an artifact; returns the paths removed.

    Callers prune ONLY after a successful attribution: a failed parse
    keeps the raw dump as the evidence. Removes the whole ``plugins/``
    capture tree plus any direct ``*.trace.json[.gz]`` files; never
    raises (a half-pruned dir degrades to stray files, not a failed
    capture)."""
    import shutil

    removed: list[str] = []
    if os.path.isfile(logdir):
        try:
            os.remove(logdir)
            return [logdir]
        except OSError:
            return []
    plugins = os.path.join(logdir, "plugins")
    if os.path.isdir(plugins):
        shutil.rmtree(plugins, ignore_errors=True)
        if not os.path.exists(plugins):
            removed.append(plugins)
    for pat in ("*.trace.json.gz", "*.trace.json", "*.xplane.pb"):
        for path in glob.glob(os.path.join(logdir, pat)):
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                pass
    return removed


def step_cost(fn, *args, **kwargs) -> dict:
    """``{"flops": float|None, "bytes_accessed": None}`` of one call
    ``fn(*args, **kwargs)``, which runs (a training step updates its
    state as it always does).

    Counts what ``FlopCounterMode`` has formulas for: the matmul
    (``mm``, ``addmm``, ``bmm``, ...), convolution (forward and both
    backward products) and attention (``scaled_dot_product_*``) FLOPs.
    Elementwise work, normalizations and reductions count nothing, and
    the port's hand-written kernels, launched through ctypes, are
    invisible to it, as a Pallas call without a cost estimate is to
    XLA's cost analysis. Nothing counts bytes, so ``bytes_accessed`` is
    ``None``. Time one step with the SINGLE step here, never a window of
    steps."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return {"flops": float(flops) if flops else None,
            "bytes_accessed": None}


def peak_flops(device_kind: str) -> float | None:
    """Peak FLOP/s for a device kind, or None when unknown (CPU, new
    hardware this table hasn't met) — callers degrade to mfu=None."""
    return PEAK_FLOPS_BY_KIND.get(str(device_kind))


def mfu(flops_per_step: float | None, steps_per_s: float | None,
        device_kind: str, n_devices: int = 1) -> float | None:
    """Model FLOPs utilization: achieved FLOP/s over peak. None when any
    input is unavailable (no FLOP count, unknown device kind, no
    measured rate) — never a made-up number."""
    peak = peak_flops(device_kind)
    if not peak or not flops_per_step or not steps_per_s:
        return None
    if n_devices < 1:
        return None
    return (flops_per_step * steps_per_s) / (peak * n_devices)
