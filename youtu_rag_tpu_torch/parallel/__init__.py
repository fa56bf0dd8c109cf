"""Parallel serving: device meshes (``mesh``), the sharded vector index
(``sharded_index``) and the sequence-parallel (ring attention) encoder; the
MoE encoder of ``expert_parallel`` (its single-device half) is imported by
its path, as it pulls in the training stack."""

from .mesh import Mesh, get_hybrid_mesh, get_mesh, init_distributed, local_device_count
from .sequence_parallel import make_sp_encoder, pad_to_multiple
from .sharded_index import ShardedVectorIndex, make_sharded_topk

__all__ = [
    "Mesh",
    "ShardedVectorIndex",
    "get_hybrid_mesh",
    "get_mesh",
    "init_distributed",
    "local_device_count",
    "make_sharded_topk",
    "make_sp_encoder",
    "pad_to_multiple",
]
