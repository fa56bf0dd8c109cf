"""A port-style test module for ``tests/test_torch_tracer_restore.py``: it
drives the JAX package beside the port, as the port's parity tests do, and
leaves more than 1,000 spans in the JAX tracer's ring. Not collected by
itself (its name does not start with ``test_``); the ordering test names it
on pytest's command line, with ``TRACER_FILLER_RESTORE=0`` to run it
without ``jax_tracer_restored``."""

import asyncio
import os

import pytest

from torch_native_helpers import jax_tracer_restored  # noqa: F401
from youtu_rag_tpu.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from youtu_rag_tpu.core.types import Document
from youtu_rag_tpu.retrieval.kb import KnowledgeBase
from youtu_rag_tpu.tracing.tracer import get_tracer

if os.environ.get("TRACER_FILLER_RESTORE", "1") != "0":
    pytestmark = pytest.mark.usefixtures("jax_tracer_restored")


def test_fill_jax_tracer():
    kb = KnowledgeBase("filler", RAGConfig(vector_store=VectorStoreConfig(
        index=IndexConfig(min_capacity=256, block_rows=64))))
    asyncio.run(kb.build_documents([Document("d1", "a document to search")]))

    async def searches():
        while len(get_tracer().spans) < get_tracer().max_kept:
            await kb.retriever.retrieve("document", top_k=1, similarity_threshold=0.0)

    asyncio.run(searches())
    assert len(get_tracer().spans) == get_tracer().max_kept
