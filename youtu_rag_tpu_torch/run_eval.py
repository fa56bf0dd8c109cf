"""Run a benchmark evaluation (ref: scripts/run_eval.py:25-40): the port's
copy of ``scripts/run_eval.py``.

    python -m youtu_rag_tpu_torch.run_eval --config_name default
    python -m youtu_rag_tpu_torch.run_eval --data path/to/data.jsonl --exp-id exp1 --device cpu

The agent the config names (its local model, memory store or KB) runs on
the CUDA card unless ``--device`` names another device; a host without
CUDA refuses the default."""

from __future__ import annotations

import argparse
import asyncio
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_name", default=None, help="configs/eval/<name> to load")
    p.add_argument("--data", default=None, help="jsonl dataset with question/answer fields")
    p.add_argument("--exp-id", default="default")
    p.add_argument(
        "--processor",
        default="exact_match",
        choices=["exact_match", "llm_judge", "gaia", "webwalker", "xbench", "browsecomp"],
    )
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device for the agent's local model, memory and KB "
                   "(default: the CUDA card)")
    return p.parse_args(argv)


async def main(argv=None, **bench_kwargs) -> dict:
    """Run the evaluation the command line describes and print its stats.
    ``bench_kwargs`` reach ``BaseBenchmark`` (``agent=``, ``judge_agent=``,
    ``db=``)."""
    args = parse_args(argv)

    from .eval.benchmark import BaseBenchmark
    from .eval.config import EvalConfig, EvalDataConfig
    from .utils.device import resolve_device

    device = str(resolve_device(args.device))
    if args.config_name:
        from .core.loader import ConfigLoader

        config = ConfigLoader().load_eval_config(args.config_name)
    else:
        config = EvalConfig(
            exp_id=args.exp_id,
            processor=args.processor,
            concurrency=args.concurrency,
            data=EvalDataConfig(dataset="cli", source=args.data or ""),
        )

    bench = BaseBenchmark(config, device=device, **bench_kwargs)
    stats = await bench.main()
    print(json.dumps(stats, ensure_ascii=False))
    return stats


if __name__ == "__main__":
    asyncio.run(main())
