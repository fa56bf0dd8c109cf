"""Generate an agent config from a natural-language requirement, on the
port (ref: scripts/gen_simple_agent.py):

    python -m youtu_rag_tpu_torch.gen_simple_agent "an agent that searches the KB and
        summarizes findings" --out configs/agents/generated/my_agent.yaml

The drafting LLM is the remote one of YRT_LLM_* (``LLMAgent``'s default),
or the local checkpoint of ``--llm-weights-dir`` on the CUDA card unless
``--device`` names another device; a host without CUDA refuses the
default."""

from __future__ import annotations

import argparse
import asyncio


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.gen_simple_agent")
    p.add_argument("requirement")
    p.add_argument("--out", default="configs/agents/generated/agent.yaml")
    p.add_argument("--llm-weights-dir", default=None,
                   help="a local causal-LM checkpoint dir to draft with instead of the "
                   "remote LLM")
    p.add_argument("--device", default=None,
                   help="torch device for a local LLM (default: the CUDA card)")
    return p.parse_args(argv)


def drafting_agent(args):
    """The ``LLMAgent`` that drafts: the local checkpoint on the resolved
    device, else the remote endpoint the environment names."""
    from .agents.config import ModelConfig
    from .agents.llm_agent import LLMAgent
    from .utils.device import resolve_device

    device = str(resolve_device(args.device))
    if args.llm_weights_dir:
        return LLMAgent(model=ModelConfig(provider="local", weights_dir=args.llm_weights_dir),
                        device=device)
    return LLMAgent(device=device)


async def main(argv=None, llm_agent=None):
    """Write the config the command line asks for and return it;
    ``llm_agent`` replaces the drafting LLM."""
    args = parse_args(argv)
    from .meta.generators import SimpleAgentGenerator

    gen = SimpleAgentGenerator(llm_agent or drafting_agent(args))
    cfg = await gen.generate_to_file(args.requirement, args.out)
    print(f"wrote {args.out}: agent {cfg.agent.name!r} with toolkits {list(cfg.toolkits)}")
    return cfg


if __name__ == "__main__":
    asyncio.run(main())
