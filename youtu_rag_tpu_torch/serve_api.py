"""Serve the RAG API (ref: start.sh → uvicorn utu.rag.api.main:app), on the port.

    python -m youtu_rag_tpu_torch.serve_api --port 8080 --data-dir ./data/api
    python -m youtu_rag_tpu_torch.serve_api --device cpu --data-dir /tmp/yrt
    python -m youtu_rag_tpu_torch.serve_api --llm-weights-dir benchmarks/models/yrt_tiny_chat

Every knowledge base, memory toolkit and local model the API builds lives
on the CUDA card unless ``--device`` names another device. ``--shards N``
shards every KB's index N ways on that device (``parallel.sharded_index``'s
local mesh). Serving across cards takes one process per card, joined by
``parallel.mesh.init_distributed`` into a group mesh, which this command
does not start."""

from __future__ import annotations

import argparse
import asyncio


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.serve_api")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--data-dir", default="./data/api")
    p.add_argument("--agent-config", default=None, help="configs/agents/<name> to load")
    p.add_argument(
        "--shards", type=int, default=0,
        help="shard every KB index N ways on the serving device (0 = unsharded); "
        "serving across cards takes one process per card",
    )
    p.add_argument(
        "--search-coalesce-ms", type=float, default=0.0,
        help="merge concurrent KB searches inside this window into one "
        "fused kernel launch (serving hot path; 2-5 ms is typical)",
    )
    p.add_argument(
        "--embedding-provider", default=None,
        choices=["hash", "tpu", "openai", "service"],
        help="default embedding provider for new knowledge bases ('tpu' is the "
        "repo's encoder on the device)",
    )
    p.add_argument(
        "--weights-dir", default=None,
        help="provider tpu: serve a train_embedder output dir (e.g. the "
        "committed benchmarks/models/yrt_tiny_lex lexical-residual encoder)",
    )
    p.add_argument(
        "--llm-weights-dir", default=None,
        help="serve a LOCAL causal-LM checkpoint dir through the chat "
        "routes (e.g. the committed benchmarks/models/yrt_tiny_chat) on the "
        "device — the whole product runs in-process, no external LLM service",
    )
    p.add_argument("--device", default=None,
                   help="torch device for the indexes, memory and the local LLM "
                   "(default: the CUDA card)")
    return p.parse_args(argv)


def build_state(args):
    """The ``ApiState`` the command line describes."""
    from .api.state import ApiState

    mesh = None
    if args.shards:
        from .parallel.mesh import get_mesh
        from .utils.device import resolve_device

        device = resolve_device(args.device)  # the card unless --device names another
        mesh = get_mesh({"db": args.shards}, devices=[device] * args.shards)
        print(f"serving with a {args.shards}-way sharded index on {device}")

    agent_config = None
    if args.agent_config:
        from .core.loader import ConfigLoader

        agent_config = ConfigLoader().load_agent_config(args.agent_config)
    if args.llm_weights_dir:
        from .agents.config import AgentConfig
        from .cli_chat import DEFAULT_KB_INSTRUCTIONS
        from .tools.base import ToolkitConfig

        agent_config = agent_config or AgentConfig()
        # keep YAML-configured generation params (temperature, max_tokens,
        # chat_template) — only the provider/weights change
        agent_config.model = agent_config.model.model_copy(
            update={"provider": "local", "weights_dir": args.llm_weights_dir}
        )
        # the committed tiny chat LM is trained against exactly this
        # system prompt — and it WILL emit kb_embedding_search calls, so
        # make sure the toolkit is wired (mirrors configs/agents/kb_search.yaml)
        # even without --agent-config
        agent_config.toolkits.setdefault(
            "kb_search", ToolkitConfig(name="kb_search")
        )
        agent_config.agent.instructions = DEFAULT_KB_INSTRUCTIONS

    rag_config = None
    if args.search_coalesce_ms > 0 or args.embedding_provider or args.weights_dir:
        from .core.config import RAGConfig

        rag_config = RAGConfig()
        if args.search_coalesce_ms > 0:
            rag_config.vector_store.coalesce_window_ms = args.search_coalesce_ms
        if args.embedding_provider or args.weights_dir:
            emb = rag_config.knowledge_builder.embedding
            rag_config.knowledge_builder.embedding = emb.model_copy(update={
                "provider": args.embedding_provider or ("tpu" if args.weights_dir else emb.provider),
                "weights_dir": args.weights_dir,
            })

    return ApiState(
        data_dir=args.data_dir, agent_config=agent_config,
        rag_config=rag_config, device=args.device, mesh=mesh,
    )


async def main(argv=None) -> None:
    args = parse_args(argv)
    state = build_state(args)
    from .api.app import create_app

    app = create_app(state)
    app.listen(args.port)
    print(f"youtu_rag_tpu_torch API listening on :{args.port} (device {state.device})")
    await asyncio.Event().wait()


if __name__ == "__main__":
    asyncio.run(main())
