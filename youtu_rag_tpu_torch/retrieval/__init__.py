from .store import TorchVectorStore, VectorStoreFactory
from .retriever import VectorRetriever, HybridRetriever
from .context import ContextAssembler

__all__ = [
    "ContextAssembler",
    "HybridRetriever",
    "TorchVectorStore",
    "VectorRetriever",
    "VectorStoreFactory",
]
