"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
judged by each module's whole top-level name (the port's name begins with
the JAX package's): a scan of the harness's own imports, and the modules a
run of a cell leaves loaded in its process."""

import ast
import json
import os
import subprocess
import sys

from portbench.bench.harness import FORBIDDEN

from .conftest import ROOT


def top_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_harness_sources_import_no_jax():
    bench = os.path.join(ROOT, "portbench")
    seen = set()
    for d, _, files in os.walk(bench):
        for f in files:
            if f.endswith(".py"):
                seen |= set(top_names(os.path.join(d, f)))
    assert not seen & set(FORBIDDEN), seen & set(FORBIDDEN)
    assert "youtu_rag_tpu_torch" in seen


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert set(top_names(os.path.join(ref, f))) <= {
                "__future__", "collections", "hashlib", "math", "re", "torch", "unicodedata"}, f


def test_a_run_loads_no_jax(tiny_tree):
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench.bench import spec, harness\n"
            "cell = spec.load('tiny.rerank', %r)\n"
            "harness.run(cell, 3, 6.0, True, 'cpu')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))") % (ROOT, tiny_tree)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "youtu_rag_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
