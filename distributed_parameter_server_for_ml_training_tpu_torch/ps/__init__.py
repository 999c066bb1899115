"""Parameter stores and workers of the port: the in-process NumPy store
(``make_store("python", ...)``), the C++ arena (``make_store("native",
...)``), the device-resident store (``make_store("device", ...)``), the
shard partition (``sharding.py``) and the PS workers that drive them."""

from .semantics import (
    DEFAULT_STALENESS_BOUND,
    mean_gradients,
    sgd_apply,
    staleness_weight,
)
from .device_store import DeviceParameterStore
from .sharding import (SHARD_SLOTS, ShardInfo, partition_keys,
                       shard_for_key, validate_shard_map)
from .store import ParameterStore, StoreConfig
from .worker import PSWorker, WorkerConfig, WorkerResult, run_workers


def make_store(backend: str, flat_params, config: StoreConfig,
               device: str = "cuda"):
    """Build a parameter store by backend name: 'python' (host NumPy),
    'native' (the C++ arena on the host, built from ``native/ps_core.cpp``
    at first use; a failed build raises) or 'device' (params on
    ``device``, the card unless the caller asks for the CPU)."""
    if backend == "native":
        from ..native import NativeParameterStore
        return NativeParameterStore(flat_params, config)
    if backend == "device":
        return DeviceParameterStore(flat_params, config, device=device)
    if backend != "python":
        raise ValueError(f"unknown store backend {backend!r}")
    return ParameterStore(flat_params, config)


__all__ = [
    "DEFAULT_STALENESS_BOUND",
    "SHARD_SLOTS",
    "ShardInfo",
    "DeviceParameterStore",
    "PSWorker",
    "ParameterStore",
    "StoreConfig",
    "WorkerConfig",
    "WorkerResult",
    "make_store",
    "mean_gradients",
    "partition_keys",
    "run_workers",
    "sgd_apply",
    "shard_for_key",
    "staleness_weight",
    "validate_shard_map",
]
