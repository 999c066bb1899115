"""Parameter store and workers of the port: the in-process NumPy store
(``make_store("python", ...)``) and the PS workers that drive it."""

from .semantics import (
    DEFAULT_STALENESS_BOUND,
    mean_gradients,
    sgd_apply,
    staleness_weight,
)
from .store import ParameterStore, StoreConfig
from .worker import PSWorker, WorkerConfig, WorkerResult, run_workers


def make_store(backend: str, flat_params, config: StoreConfig):
    """Build a parameter store by backend name. This slice ports the
    'python' (host NumPy) store; 'native' (C++ arena) and 'device'
    (HBM-resident) come with later slices."""
    if backend in ("native", "device"):
        raise NotImplementedError(
            f"store backend {backend!r} is not ported yet")
    if backend != "python":
        raise ValueError(f"unknown store backend {backend!r}")
    return ParameterStore(flat_params, config)


__all__ = [
    "DEFAULT_STALENESS_BOUND",
    "PSWorker",
    "ParameterStore",
    "StoreConfig",
    "WorkerConfig",
    "WorkerResult",
    "make_store",
    "mean_gradients",
    "run_workers",
    "sgd_apply",
    "staleness_weight",
]
