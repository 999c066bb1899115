"""Parallelism of the port: the worker mesh, sync data parallelism with
the int8 reduce-scatter ring (kernels K2-K4), over the slots of one card
or, one process per card, over several (``multihost``), and ring
attention over sequence slots. Tensor, pipeline and MoE parallelism of
the JAX package come with later slices."""

from .mesh import DATA_AXIS, Mesh, make_mesh, worker_axis_size
from .multihost import (RankGroup, fetch_replicated, host_local_slice,
                        make_global_mesh, replicate_to_mesh,
                        shard_batch_global)
from .multihost import initialize as initialize_multihost
from .ring_attention import (dense_attention, make_ring_attention,
                             make_ring_flash_attention,
                             ring_attention_local)
from .sync_dp import make_sync_dp_step, shard_batch

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "RankGroup",
    "make_mesh",
    "worker_axis_size",
    "initialize_multihost",
    "make_global_mesh",
    "host_local_slice",
    "shard_batch_global",
    "replicate_to_mesh",
    "fetch_replicated",
    "make_sync_dp_step",
    "shard_batch",
    "make_ring_attention",
    "make_ring_flash_attention",
    "ring_attention_local",
    "dense_attention",
]
