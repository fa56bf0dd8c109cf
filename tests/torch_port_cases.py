"""The JAX package's test cases, run on the port.

``port_cases(path)`` reads a test module of the JAX package (a path under
``tests/``), renames every ``youtu_rag_tpu`` module path in it to
``youtu_rag_tpu_torch``, applies the listed text edits (the port's own
arguments, such as ``device="cpu"`` where the port defaults to the card),
and runs it as a module of its own, its asserts rewritten as pytest
rewrites a test module's. It returns that module's names: a port test
module puts them in its globals, so pytest collects the same tests and
fixtures, by the same names, over the port. The JAX file itself is read,
never written, and still runs on the JAX package under its own name."""

import ast
import re
import types
from pathlib import Path

from _pytest.assertion.rewrite import rewrite_asserts

TESTS = Path(__file__).resolve().parent
JAX_PACKAGE = re.compile(r"\byoutu_rag_tpu\b")


def port_cases(relpath: str, edits: tuple[tuple[str, str], ...] = ()) -> dict:
    path = TESTS / relpath
    src = path.read_text()
    for old, new in edits:
        assert old in src, f"{relpath} no longer holds {old!r}"
        src = src.replace(old, new)
    src = JAX_PACKAGE.sub("youtu_rag_tpu_torch", src)
    tree = ast.parse(src, str(path))
    rewrite_asserts(tree, src.encode(), str(path))
    module = types.ModuleType(f"port_{path.stem}")
    module.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), module.__dict__)
    return {k: v for k, v in vars(module).items() if not k.startswith("__")}
