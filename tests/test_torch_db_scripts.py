"""The port's DB commands (``db_dump``, ``trace_search``,
``analysis.tool_usage``) against the JAX package's scripts
(``scripts/db_dump.py``, ``scripts/trace_search.py``,
``scripts/analysis/tool_usage.py``): the same flags on the same sqlite DB
print the same bytes, on a DB the port's ``DBService`` wrote and on one the
JAX package's wrote; ``--clear`` removes the same rows from copies; an
unavailable DB exits the same way."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from youtu_rag_tpu_torch import db_dump, trace_search
from youtu_rag_tpu_torch.analysis import tool_usage

REPO = Path(__file__).resolve().parent.parent
TOOLS = ("kb_embedding_search", "run_snippet", "rag_retrieve", "execute_python_code")
TRACES = ("tr-a", "tr-b")


def load_script(rel: str):
    """A JAX script as a module of its own (its ``main`` reads sys.argv)."""
    name = "jax_script_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = {"db_dump": "scripts/db_dump.py", "trace_search": "scripts/trace_search.py",
       "tool_usage": "scripts/analysis/tool_usage.py"}
PORT = {"db_dump": db_dump, "trace_search": trace_search, "tool_usage": tool_usage}


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: load_script(rel) for name, rel in JAX.items()}


def seeded_records(models, seed: int = 0) -> list:
    """Every table filled: runs with and without errors and tool calls (one
    call without a name), tool spans of several names over two trace ids
    with arguments and outputs past the 120-character cut, generation spans
    with and without output, evaluation samples of every ``correct``."""
    rng = np.random.default_rng(seed)
    t0 = 1_760_000_000.0
    out = []
    for i in range(14):
        calls = [{"name": TOOLS[int(j)], "arguments": {"q": f"q{i}"}}
                 for j in rng.integers(0, len(TOOLS), size=int(rng.integers(0, 5)))]
        if i == 5:
            calls.append({"arguments": {}})
        out.append(models.TrajectoryRecord(
            trace_id=TRACES[i % 2], input=f"question {i} — naïve",
            output=None if i % 4 == 3 else f"answer {i}",
            trajectory=[{"role": "user", "content": f"m{k}"}
                        for k in range(int(rng.integers(1, 6)))],
            tool_calls=calls, usage_input_tokens=int(rng.integers(0, 500)),
            usage_output_tokens=int(rng.integers(0, 100)),
            error="boom" if i % 5 == 2 else None, agent_type=("simple", "orchestra")[i % 2],
            created_at=t0 + i))
    for i in range(40):
        name = TOOLS[int(rng.integers(0, len(TOOLS)))]
        out.append(models.ToolTraceRecord(
            trace_id=TRACES[int(rng.integers(0, 2))], span_id=f"s{i}", name=name,
            arguments='{"query": "' + "ü" * int(rng.integers(0, 200)) + '"}',
            output="x" * int(rng.integers(0, 300)),
            duration_ms=float(rng.uniform(0.01, 50.0)), created_at=t0 + 100 + i))
    for i in range(9):
        out.append(models.GenerationTraceRecord(
            trace_id=TRACES[i % 2], span_id=f"g{i}", model=("tiny", "remote")[i % 2],
            input_messages=[{"role": "user", "content": "hi"}],
            output=None if i % 3 == 0 else "y" * (50 * i), input_tokens=10 * i,
            output_tokens=i, duration_ms=float(rng.uniform(1.0, 900.0)),
            created_at=t0 + 200 + i))
    for i in range(7):
        out.append(models.EvaluationSample(
            dataset="facts", index=i, raw_question=f"q{i}", correct_answer=str(i),
            response=None if i == 0 else str(i), correct=(None, True, False)[i % 3],
            reward=None if i % 2 else 0.5, stage=("init", "judged")[i % 2],
            created_at=t0 + 300 + i))
    return out


@pytest.fixture(scope="module", params=["port", "jax"])
def db_path(request, tmp_path_factory):
    """A sqlite file written by the port's or the JAX package's DBService."""
    if request.param == "port":
        from youtu_rag_tpu_torch.db import models, service
    else:
        from youtu_rag_tpu.db import models, service
    path = tmp_path_factory.mktemp(f"db_{request.param}") / "yrt.db"
    db = service.DBService(f"sqlite:///{path}")
    for rec in seeded_records(models):
        assert db.add(rec)
    db.close()
    return path


def run(main, argv: list[str], capsys, monkeypatch):
    """(exit code, stdout, stderr) of ``main`` with ``argv`` as sys.argv."""
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    code = 0
    try:
        main()
    except SystemExit as e:
        code = e.code
    got = capsys.readouterr()
    return code, got.out, got.err


def both(name: str, argv: list[str], jax_scripts, capsys, monkeypatch):
    want = run(jax_scripts[name].main, argv, capsys, monkeypatch)
    got = run(PORT[name].main, argv, capsys, monkeypatch)
    return got, want


DUMP_CASES = [[], ["--limit", "3"], ["--table", "tool_traces", "--limit", "0"],
              *[["--table", t] for t in db_dump.TABLES]]
SEARCH_CASES = [[], ["--name", "kb_embedding_search"], ["--trace-id", "tr-b"],
                ["--name", "run_snippet", "--trace-id", "tr-a"], ["--kind", "tool"],
                ["--kind", "generation"], ["--kind", "generation", "--trace-id", "tr-a"],
                ["--kind", "generation", "--name", "rag_retrieve"], ["--limit", "5"],
                ["--name", "no_such_tool"]]
USAGE_CASES = [[], ["--json"], ["--limit", "3"], ["--json", "--limit", "2"]]


@pytest.mark.parametrize("argv", DUMP_CASES, ids=lambda a: " ".join(a) or "all")
def test_db_dump_matches_jax(db_path, argv, jax_scripts, capsys, monkeypatch):
    got, want = both("db_dump", ["--db", f"sqlite:///{db_path}", *argv], jax_scripts, capsys,
                     monkeypatch)
    assert got == want
    assert got[0] == 0 and got[1].count("== ") == (1 if "--table" in argv else 4)


@pytest.mark.parametrize("argv", SEARCH_CASES, ids=lambda a: " ".join(a) or "all")
def test_trace_search_matches_jax(db_path, argv, jax_scripts, capsys, monkeypatch):
    got, want = both("trace_search", ["--db", f"sqlite:///{db_path}", *argv], jax_scripts,
                     capsys, monkeypatch)
    assert got == want and got[0] == 0
    if argv in ([], ["--kind", "tool"], ["--name", "kb_embedding_search"]):
        assert '"kind": "tool"' in got[1]


@pytest.mark.parametrize("argv", USAGE_CASES, ids=lambda a: " ".join(a) or "text")
def test_tool_usage_matches_jax(db_path, argv, jax_scripts, capsys, monkeypatch):
    got, want = both("tool_usage", ["--db", f"sqlite:///{db_path}", *argv], jax_scripts,
                     capsys, monkeypatch)
    assert got == want and got[0] == 0
    assert "runs" in got[1]


@pytest.mark.parametrize("table", list(db_dump.TABLES))
def test_clear_matches_jax(db_path, table, jax_scripts, capsys, monkeypatch, tmp_path):
    """``--clear`` on two copies: the same message, that table empty and the
    others as they were (the dump of each copy afterwards is the same)."""
    copies = {side: tmp_path / f"{side}.db" for side in ("jax", "port")}
    for path in copies.values():
        shutil.copy(db_path, path)
    want = run(jax_scripts["db_dump"].main, ["--db", f"sqlite:///{copies['jax']}",
                                            "--clear", table], capsys, monkeypatch)
    got = run(db_dump.main, ["--db", f"sqlite:///{copies['port']}", "--clear", table], capsys,
              monkeypatch)
    assert got == want and got[1].startswith("cleared ") and not got[1].startswith("cleared 0 ")
    before = run(db_dump.main, ["--db", f"sqlite:///{db_path}", "--limit", "1000"], capsys,
                 monkeypatch)[1]
    after = [run(db_dump.main, ["--db", f"sqlite:///{copies[s]}", "--limit", "1000"], capsys,
                 monkeypatch)[1] for s in ("jax", "port")]
    assert after[0] == after[1]
    sections = dict(zip(db_dump.TABLES, before.split("== ")[1:]))
    for name, text in zip(db_dump.TABLES, after[0].split("== ")[1:]):
        if name == table:
            assert text.startswith(f"{name} (0 total, showing 0) ==")
        else:
            assert text == sections[name]


@pytest.mark.parametrize("name", list(JAX))
def test_unavailable_db_exits_as_jax(name, jax_scripts, capsys, monkeypatch):
    """No DB: db_dump and trace_search with an empty ``--db``, tool_usage
    with no ``--db`` and no YRT_DB_URL / UTU_DB_URL."""
    monkeypatch.delenv("YRT_DB_URL", raising=False)
    monkeypatch.delenv("UTU_DB_URL", raising=False)
    argv = [] if name == "tool_usage" else ["--db", ""]
    got, want = both(name, argv, jax_scripts, capsys, monkeypatch)
    assert got == want and got[0] not in (0, None) and not got[1]


def test_tool_usage_reads_yrt_db_url(db_path, jax_scripts, capsys, monkeypatch):
    monkeypatch.setenv("YRT_DB_URL", f"sqlite:///{db_path}")
    got, want = both("tool_usage", ["--json"], jax_scripts, capsys, monkeypatch)
    assert got == want and '"runs": 14' in got[1]


def test_modules_run_as_commands(db_path, jax_scripts, capsys, monkeypatch):
    """``python -m`` runs each command and prints what the JAX script
    prints; none of them imports torch (they are host-only)."""
    cases = {"db_dump": ["--limit", "4"], "trace_search": ["--trace-id", "tr-a"],
             "tool_usage": []}
    probe = ("import runpy, sys; sys.argv = sys.argv[1:]; "
             "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True); "
             "print('torch' in sys.modules, file=sys.stderr)")
    for name, argv in cases.items():
        args = ["--db", f"sqlite:///{db_path}", *argv]
        want = run(jax_scripts[name].main, args, capsys, monkeypatch)[1]
        module = PORT[name].__name__
        out = subprocess.run([sys.executable, "-c", probe, module, *args], capture_output=True,
                             text=True, cwd=REPO, timeout=60,
                             env={**os.environ, "PYTHONPATH": str(REPO)})
        assert out.returncode == 0, out.stderr
        assert out.stdout == want
        assert out.stderr.strip().splitlines()[-1] == "False"
