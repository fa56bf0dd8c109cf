"""One run of one cell of the port's benchmark (``BENCHMARK.json``):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and the numbers the check compared, each beside its limit, as the last
lines of standard error. Runs on CUDA cards only; exits non-zero without
them, or when JAX or the JAX package was loaded by the end."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
# every cache of the run inside the checkout, at fixed paths: the program's
# kernels build into youtu_rag_tpu_torch/_build/ beside it
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.bench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
