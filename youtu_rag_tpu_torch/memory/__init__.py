"""Long-term agent memory on the port's device index (a copy of
``youtu_rag_tpu/memory``)."""

from .store import MEMORY_TYPES, MemoryNode, MemoryVectorStore
from .toolkit import VectorMemoryToolkit

__all__ = ["MEMORY_TYPES", "MemoryNode", "MemoryVectorStore", "VectorMemoryToolkit"]
