"""Parallelism of the port: the worker mesh, sync data parallelism with
the int8 reduce-scatter ring (kernels K2-K4), over the slots of one card
or, one process per card, over several (``multihost``), ring attention
over sequence slots, Switch-MoE expert parallelism over expert slots,
GPipe/1F1B pipelines over stage slots and Megatron tensor parallelism
over model slots of one card, and the meshes of two or three axes that
compose them (data x model, data x expert, data x model x stage)."""

from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS,
                   Mesh, make_mesh, mesh_from_shape, worker_axis_size)
from .moe import init_moe_params, make_moe_ffn
from .multihost import (RankGroup, fetch_replicated, host_local_slice,
                        make_global_mesh, replicate_to_mesh,
                        shard_batch_global)
from .multihost import initialize as initialize_multihost
from .pipeline import make_pipeline_apply, stack_stage_params
from .ring_attention import (dense_attention, make_ring_attention,
                             make_ring_flash_attention,
                             ring_attention_local)
from .sync_dp import make_sync_dp_step, shard_batch
from .tensor import slot_views, tp_spec_for_path

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "RankGroup",
    "make_mesh",
    "mesh_from_shape",
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
    "tp_spec_for_path",
    "slot_views",
    "EXPERT_AXIS",
    "STAGE_AXIS",
    "make_pipeline_apply",
    "stack_stage_params",
    "make_moe_ffn",
    "init_moe_params",
]
