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
core         data model + config tree
ops          kernel wrappers, their plain versions, the CUDA builder
index        device vector index, metadata columns, filter compiler
models       embedders (hash, encoder, pretrained BERT, remote), rerankers
             (cross-encoder, lexical, remote), tokenizers (hashing, WordPiece,
             BPE), the encoder trunk, the decoder, the checkpoint loader, the
             trainers and their synthetic data
ingest       loaders, chunkers, knowledge builder, the staged builder agent
             (processors, table store, QA files, cleanup), metadata, HiChunk, OCR
native       the host C kernels of the hash tokenizer and embedder (cc, ctypes)
retrieval    vector store, retrievers, context assembly, knowledge base,
             storage monitoring
tracing      in-process span tracer, OTLP export, the torch profiler's split
agents       LLM clients (remote, local decoder), simple agent, orchestrators,
             environments, the agent factory
api          the HTTP/SSE service's state and routes (tornado)
bench        the DTR bench and the kernel A/B and tracing tools
db           sqlite trajectory/trace store, SQL adapters, migrations
eval         benchmark harness
integrations the DTR Excel agent
memory       vector memory store + memory toolkit
meta         agent and tool generators
parallel     meshes, the sharded index, sequence, tensor, pipeline and
             expert parallelism
tools        toolkit base/registry + builtin toolkits, the MCP client
utils        device selection, hashing, logging, HTTP, caches
analysis     reports over the trajectory store (tool_usage)

Entry modules (``python -m youtu_rag_tpu_torch.<name>``): cli_chat,
serve_api, replay_server, run_eval, train_embedder, train_chat_lm,
gen_simple_agent, gen_tool, dryrun, start_tools_mcp, db_dump, trace_search,
analysis.tool_usage.
"""

from .version import __version__

__all__ = ["__version__"]
