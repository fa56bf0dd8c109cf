"""Retrieval-only chat REPL over a knowledge base, on the port.

Builds a KB from files/directories, then prints the assembled context for
each query read from standard input:

    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ --provider hash
    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ --hybrid --device cpu
    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ --provider tpu \
        --weights-dir benchmarks/models/yrt_tiny_lex

The KB runs on the CUDA card unless ``--device`` names another device.
Agentic mode (an LLM answering through KB-search tools) and the LLM flags
wait for the local-LLM and agents slices (ROADMAP Queue A 5 and 6)."""

from __future__ import annotations

import argparse
import asyncio
import glob
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.cli_chat")
    p.add_argument("--paths", nargs="+", required=True, help="files/dirs/globs to index")
    p.add_argument("--provider", default="hash", choices=["hash", "tpu", "openai", "service"],
                   help="embedding provider: 'hash'; 'tpu' for the repo's encoder on the "
                   "KB's device; 'openai' or 'service' for a remote endpoint "
                   "(YRT_EMBEDDING_URL / YRT_EMBEDDING_API_KEY)")
    p.add_argument("--weights-dir", default=None,
                   help="provider tpu: train_embedder output dir (e.g. the committed "
                   "benchmarks/models/yrt_tiny_lex lexical-residual encoder)")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--hybrid", action="store_true", help="dense+BM25 RRF fusion retrieval")
    p.add_argument("--device", default=None,
                   help="torch device for the index (default: the CUDA card)")
    return p.parse_args(argv)


def collect_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in files)
        else:
            out.extend(glob.glob(p) or [p])
    return sorted(set(out))


async def main(argv=None) -> None:
    args = parse_args(argv)

    from .core.config import EmbeddingConfig, RAGConfig
    from .retrieval.kb import GLOBAL_KB_REGISTRY, KnowledgeBase

    cfg = RAGConfig(name="cli")
    cfg.knowledge_builder.embedding = EmbeddingConfig(provider=args.provider,
                                                      weights_dir=args.weights_dir)
    kb = KnowledgeBase("cli", cfg, device=args.device)
    GLOBAL_KB_REGISTRY.register(kb)

    files = [f for f in collect_files(args.paths) if os.path.isfile(f)]
    if not files:
        print(f"error: no files found under {args.paths}", file=sys.stderr)
        sys.exit(2)
    print(f"indexing {len(files)} files on {kb.device} ...")
    status = await kb.build_files(files)
    print(f"built: {status.total_chunks} chunks from {status.processed_documents} docs "
          f"({len(status.errors)} errors)")
    print("retrieval-only mode. Ctrl-D to exit.")

    retriever = kb.hybrid_retriever if args.hybrid else kb.retriever
    while True:
        try:
            query = input("\n> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not query:
            continue
        results = await retriever.retrieve(query, top_k=args.top_k, similarity_threshold=0.0)
        print(kb.assembler.assemble(results, format_style="markdown") or "(no hits)")


if __name__ == "__main__":
    asyncio.run(main())
