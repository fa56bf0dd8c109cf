"""Parallelism over device meshes: the meshes (``mesh``), the collectives
and parameter placement of the sharded forwards and train steps (``comm``,
``placement``), the sharded vector index (``sharded_index``), the
sequence-parallel (ring attention, tensor parallelism inside) and
pipeline-parallel encoders; the MoE encoder and its expert-parallel forms
(``expert_parallel``) are imported by their path."""

from .mesh import Mesh, get_hybrid_mesh, get_mesh, init_distributed, local_device_count
from .pipeline_parallel import make_pp_encoder, shard_params_pp
from .sequence_parallel import make_sp_encoder, pad_to_multiple
from .sharded_index import ShardedVectorIndex, make_sharded_topk

__all__ = [
    "Mesh",
    "ShardedVectorIndex",
    "get_hybrid_mesh",
    "get_mesh",
    "init_distributed",
    "local_device_count",
    "make_pp_encoder",
    "make_sharded_topk",
    "make_sp_encoder",
    "pad_to_multiple",
    "shard_params_pp",
]
