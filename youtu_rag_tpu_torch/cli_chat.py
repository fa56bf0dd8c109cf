"""Chat REPL over a knowledge base, on the port.

Builds a KB from files/directories and reads queries from standard input.
With an LLM it runs agentic mode: a ``SimpleAgent`` answers each query,
calling the KB-search tool (``kb_embedding_search``) as it decides; the
local causal LM of ``--llm-weights-dir`` runs in-process on the KB's
device, a remote one comes from ``--llm-model`` / ``--llm-base-url`` /
``--llm-api-key`` (or YRT_LLM_* / UTU_LLM_*). Without one it runs
retrieval-only and prints the assembled context:

    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ --provider hash
    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ --hybrid --device cpu
    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ --provider tpu \
        --weights-dir benchmarks/models/yrt_tiny_lex
    python -m youtu_rag_tpu_torch.cli_chat --paths docs/ \
        --llm-weights-dir benchmarks/models/yrt_tiny_chat

The KB and the local LLM run on the CUDA card unless ``--device`` names
another device."""

from __future__ import annotations

import argparse
import asyncio
import glob
import os
import sys

# the system prompt the chat LM trains against (models/lm_synth.py)
from .models.lm_synth import DEFAULT_KB_INSTRUCTIONS


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
    p.add_argument("--llm-model", default=None)
    p.add_argument("--llm-base-url", default=None)
    p.add_argument("--llm-api-key", default=None)
    p.add_argument("--llm-weights-dir", default=None,
                   help="serve a local causal-LM checkpoint dir (the repo's native "
                   "decoder_params.npz, or config.json + model.safetensors + tokenizer.json "
                   "of a gpt2/llama/mistral/qwen2 model) on the KB's device instead of a "
                   "remote LLM service")
    p.add_argument("--hybrid", action="store_true", help="dense+BM25 RRF fusion retrieval")
    p.add_argument("--device", default=None,
                   help="torch device for the index and the local LLM (default: the CUDA card)")
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

    from .agents.config import AgentConfig, ModelConfig
    from .agents.llm import get_chat_client
    from .agents.simple_agent import SimpleAgent
    from .core.config import EmbeddingConfig, RAGConfig
    from .retrieval.kb import GLOBAL_KB_REGISTRY, KnowledgeBase
    from .tools.base import ToolkitConfig
    from .tools.kb_search import KBSearchToolkit

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

    if args.llm_weights_dir:
        model = ModelConfig(provider="local", weights_dir=args.llm_weights_dir)
        has_llm = True
    else:
        model = ModelConfig(model=args.llm_model, base_url=args.llm_base_url,
                            api_key=args.llm_api_key).resolved()
        has_llm = bool(model.model and model.base_url)

    agent = None
    if has_llm:
        toolkit = KBSearchToolkit(ToolkitConfig(config={"kb": kb}))
        acfg = AgentConfig(model=model)
        # the committed tiny chat LM was trained against this system prompt
        acfg.agent.instructions = DEFAULT_KB_INSTRUCTIONS
        agent = SimpleAgent(acfg, client=get_chat_client(model, device=kb.device),
                            toolkits=[toolkit])
        await agent.build()
        where = f"local decoder on {kb.device}" if args.llm_weights_dir else "remote LLM"
        print(f"LLM connected ({where}): agentic mode. Ctrl-D to exit.")
    else:
        print("no LLM configured: retrieval-only mode. Ctrl-D to exit.")

    retriever = kb.hybrid_retriever if args.hybrid else kb.retriever
    while True:
        try:
            query = input("\n> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not query:
            continue
        if agent is not None:
            rec = agent.run_streamed(query)
            async for ev in rec.stream_events():
                if ev.type == "text_delta":
                    print(ev.text, end="", flush=True)
                elif ev.type == "tool_call":
                    print(f"\n[tool {ev.name}({ev.arguments})]", flush=True)
                elif ev.type == "error":
                    print(f"\n[error {ev.text}]", flush=True)
            print()
        else:
            results = await retriever.retrieve(query, top_k=args.top_k, similarity_threshold=0.0)
            print(kb.assembler.assemble(results, format_style="markdown") or "(no hits)")


if __name__ == "__main__":
    asyncio.run(main())
