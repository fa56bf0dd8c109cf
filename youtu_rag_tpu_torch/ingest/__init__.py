from .chunker import HierarchicalMarkdownSplitter, RecursiveTextSplitter, get_splitter
from .loaders import DocumentLoaderRegistry, load_document
from .builder import KnowledgeBuilder

__all__ = [
    "DocumentLoaderRegistry",
    "HierarchicalMarkdownSplitter",
    "KnowledgeBuilder",
    "RecursiveTextSplitter",
    "get_splitter",
    "load_document",
]
