"""Tracing/profiling for the port: the JAX package's ``utils/tracing.py``
on ``torch.profiler``.

- :class:`StepTimer` reproduces the reference's rolling-window timing
  (server.py:121 ``deque(maxlen=100)``),
- :func:`trace` brackets a code region with ``torch.profiler``: CPU and
  CUDA activities when the device is a card, CPU activities only when
  the caller asks for the CPU. The Chrome trace lands where the JAX
  package's ``jax.profiler`` dump lands, under
  ``<logdir>/plugins/profile/<run>/`` (a gzipped ``*.pt.trace.json.gz``,
  which ``telemetry/profiler.py:find_profile_dumps`` finds), and opens in
  Perfetto or TensorBoard,
- :func:`annotate` tags a host-side region so it appears on the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch

from .device import resolve_device


class StepTimer:
    """Rolling-window step timing (server.py:121 deque(maxlen=100))."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else 0.0


@contextlib.contextmanager
def trace(logdir: str, device: str | torch.device = "cuda"):
    """Capture a ``torch.profiler`` trace around a code region::

        with trace('/tmp/trace'):
            for _ in range(10):
                step(state, x, y)

    On a card the profiler records the card's kernels and copies (CUPTI,
    process-wide: kernels launched by other threads of the process land
    in the trace too) and the device is synchronized before the trace
    stops, so every kernel issued inside the region is in it. Asking for
    CUDA without a usable card raises: the trace never falls back to the
    CPU in silence. Started without ``record_shapes`` or ``with_stack``,
    which would multiply the trace's size."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    run_dir = os.path.join(logdir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                run_dir, use_gzip=True)):
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def annotate(name: str):
    """Named region that shows up on the profiler timeline."""
    return torch.profiler.record_function(name)
