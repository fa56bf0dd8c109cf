from .embedder import CoalescingEmbedder, EmbedderFactory, HashEmbedder
from .reranker import LexicalReranker, RerankerFactory
from .tokenizer import HashTokenizer

__all__ = [
    "CoalescingEmbedder",
    "EmbedderFactory",
    "HashEmbedder",
    "HashTokenizer",
    "LexicalReranker",
    "RerankerFactory",
]
