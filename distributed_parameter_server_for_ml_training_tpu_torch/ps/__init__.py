"""Parameter stores and workers of the port: the in-process NumPy store
(``make_store("python", ...)``), the C++ arena (``make_store("native",
...)``), the device-resident store (``make_store("device", ...)``), the
shard partition (``sharding.py``), the PS workers that drive them, and
the replica pool (``supervisor.py``).

The names are loaded on first use (PEP 562): the shard partition is
plain Python, and the serve tier's host processes (``cli replica``,
``cli loadgen``) import it through ``comms/`` without paying for torch.
"""

import importlib

#: name -> the submodule that defines it.
_EXPORTS = {
    "DEFAULT_STALENESS_BOUND": "semantics", "mean_gradients": "semantics",
    "sgd_apply": "semantics", "staleness_weight": "semantics",
    "DeviceParameterStore": "device_store",
    "SHARD_SLOTS": "sharding", "ShardInfo": "sharding",
    "partition_keys": "sharding", "shard_for_key": "sharding",
    "validate_shard_map": "sharding",
    "ParameterStore": "store", "StoreConfig": "store",
    "PSWorker": "worker", "WorkerConfig": "worker",
    "WorkerResult": "worker", "run_workers": "worker",
}


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


def make_store(backend: str, flat_params, config,
               device: str = "cuda"):
    """Build a parameter store by backend name: 'python' (host NumPy),
    'native' (the C++ arena on the host, built from ``native/ps_core.cpp``
    at first use; a failed build raises) or 'device' (params on
    ``device``, the card unless the caller asks for the CPU)."""
    from .device_store import DeviceParameterStore
    from .store import ParameterStore
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
