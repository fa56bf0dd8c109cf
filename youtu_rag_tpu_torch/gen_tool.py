"""Generate a toolkit module from a natural-language requirement, on the
port (ref: scripts/gen_tool.py → ToolGenerator/ToolGeneratorDebugger; the
generator import-validates and retries internally, meta/generators.py):

    python -m youtu_rag_tpu_torch.gen_tool "a toolkit that fetches RSS feeds" \\
        --out youtu_rag_tpu_torch/tools/generated/rss.py

The generated class subclasses ``youtu_rag_tpu_torch.tools.base``'s
``AsyncBaseToolkit``. The drafting LLM is chosen as in ``gen_simple_agent``
(``--llm-weights-dir`` on the CUDA card unless ``--device`` names another
device)."""

from __future__ import annotations

import argparse
import asyncio

from .gen_simple_agent import drafting_agent


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m youtu_rag_tpu_torch.gen_tool")
    p.add_argument("requirement")
    p.add_argument("--out", default="generated_toolkit.py")
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--llm-weights-dir", default=None,
                   help="a local causal-LM checkpoint dir to draft with instead of the "
                   "remote LLM")
    p.add_argument("--device", default=None,
                   help="torch device for a local LLM (default: the CUDA card)")
    return p.parse_args(argv)


async def main(argv=None, llm_agent=None):
    """Write the toolkit the command line asks for and return its class;
    ``llm_agent`` replaces the drafting LLM."""
    args = parse_args(argv)
    from .meta.generators import ToolGenerator

    gen = ToolGenerator(llm_agent or drafting_agent(args), max_retries=args.retries)
    cls = await gen.generate_to_file(args.requirement, args.out)
    tools = list(cls().tools_map)
    print(f"wrote {args.out}: toolkit {cls.__name__} with tools {tools}")
    return cls


if __name__ == "__main__":
    asyncio.run(main())
