"""Readings that set a cell's correctness limits, on the card at the
cell's own size: for each seed, one run of the cell (its compared numbers,
the program's readings) and the control on the same sample, the plain
reference one precision below the configuration's (fp8 for the bf16
models, int4 rows for int8, fp8 rows for bf16) put in the program's place:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: the seed, both sets of readings and the
run's end-to-end metrics."""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    import argparse
    import gc
    import json

    import torch

    from portbench.bench import harness, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        sys.exit("calibrate.py runs on a CUDA card")
    for seed in args.seeds:
        out = harness.run(cell, seed, args.seconds, False, "cuda", control=True)
        program = {k: c["value"] for k, c in out["checks"].items()}
        print(json.dumps({"seed": seed, "program": program, "control": out["control"],
                          "metrics": out["e2e"], "check_s": out["check_s"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
