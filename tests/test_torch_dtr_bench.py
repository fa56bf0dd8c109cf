"""The cases of ``tests/test_dtr_bench.py`` on the port's copy of the DTR
benchmark's analyst and judge, ``youtu_rag_tpu_torch/bench/dtr.py``
(``tests/torch_port_cases.py``), in place of ``scripts/bench_dtr.py``."""

from torch_port_cases import port_cases

SCRIPT = '''    spec = importlib.util.spec_from_file_location(
        "bench_dtr", ROOT / "scripts" / "bench_dtr.py"
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m'''
PORT = '''    return importlib.import_module("youtu_rag_tpu.bench.dtr")'''

globals().update(port_cases("test_dtr_bench.py", edits=(
    ("import importlib.util\n", "import importlib\n"), (SCRIPT, PORT))))
