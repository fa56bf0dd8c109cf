"""youtu_rag_tpu_torch — the PyTorch and CUDA port of youtu_rag_tpu for one
NVIDIA H100 (Hopper, sm_90a).

It keeps the JAX package's module layout and public names, so each module
has a counterpart under ``youtu_rag_tpu/``. Plain tensor code is PyTorch;
each Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper under ``csrc/``, built at first use (``ops/_build.py``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version.

Subpackages
-----------
core        data model + config tree
ops         kernel wrappers, their plain versions, the CUDA builder
index       device vector index, metadata columns, filter compiler
models      embedders (hash, encoder, pretrained BERT, remote), rerankers
            (cross-encoder, lexical, remote), tokenizers (hashing, WordPiece),
            the encoder trunk and the checkpoint loader
ingest      loaders, chunkers, knowledge builder, the staged builder agent
            (processors, table store, QA files, cleanup), metadata, HiChunk, OCR
native      the host C kernels of the hash tokenizer and embedder (cc, ctypes)
retrieval   vector store, retrievers, context assembly, knowledge base
tracing     in-process span tracer
"""

__version__ = "0.1.0"
