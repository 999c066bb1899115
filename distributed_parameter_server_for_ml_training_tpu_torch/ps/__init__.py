"""Parameter stores and workers of the port: the in-process NumPy store
(``make_store("python", ...)``), the device-resident store
(``make_store("device", ...)``) and the PS workers that drive them."""

from .semantics import (
    DEFAULT_STALENESS_BOUND,
    mean_gradients,
    sgd_apply,
    staleness_weight,
)
from .device_store import DeviceParameterStore
from .store import ParameterStore, StoreConfig
from .worker import PSWorker, WorkerConfig, WorkerResult, run_workers


def make_store(backend: str, flat_params, config: StoreConfig,
               device: str = "cuda"):
    """Build a parameter store by backend name: 'python' (host NumPy) or
    'device' (params on ``device``, the card unless the caller asks for
    the CPU). 'native' (the C++ arena) comes with ROADMAP §1 item 9."""
    if backend == "native":
        raise NotImplementedError(
            "store backend 'native' is not ported yet; the C++ arena "
            "comes with ROADMAP §1 item 9 (native/ps_core.cpp)")
    if backend == "device":
        return DeviceParameterStore(flat_params, config, device=device)
    if backend != "python":
        raise ValueError(f"unknown store backend {backend!r}")
    return ParameterStore(flat_params, config)


__all__ = [
    "DEFAULT_STALENESS_BOUND",
    "DeviceParameterStore",
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
