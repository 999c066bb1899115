"""Parallelism of the port: the worker mesh and sync data parallelism
with the int8 reduce-scatter ring (kernels K2-K4). The multi-card mesh,
multi-host, tensor, pipeline, ring-attention and MoE parallelism of the
JAX package come with later slices."""

from .mesh import DATA_AXIS, Mesh, make_mesh, worker_axis_size
from .sync_dp import make_sync_dp_step, shard_batch

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "worker_axis_size",
    "make_sync_dp_step",
    "shard_batch",
]
