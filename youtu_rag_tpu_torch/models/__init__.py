from .embedder import (
    CoalescingEmbedder,
    EmbedderFactory,
    HashEmbedder,
    RemoteEmbedder,
    TorchEmbedder,
)
from .reranker import LexicalReranker, RemoteReranker, RerankerFactory, TorchReranker
from .tokenizer import HashTokenizer
from .wordpiece import WordPieceTokenizer

__all__ = [
    "CoalescingEmbedder",
    "EmbedderFactory",
    "HashEmbedder",
    "HashTokenizer",
    "LexicalReranker",
    "RemoteEmbedder",
    "RemoteReranker",
    "RerankerFactory",
    "TorchEmbedder",
    "TorchReranker",
    "WordPieceTokenizer",
]
