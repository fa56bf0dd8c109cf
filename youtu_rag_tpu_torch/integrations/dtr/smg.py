"""SMG — sheet-state machine for deep table reasoning.

Capability counterpart of the reference's Structured Memory Graph
(``integrations/DTR/src/modules/smg_module.py:37-2030`` + ``TableState``/
``SMGNode`` in ``src/core/dtr_structures.py``): the ONE component that
generates + executes step code, tracks how every sheet and derived frame
evolves (schema/shape before → after), and feeds that live state back into
code generation so later steps can build on earlier steps' frames — the
thing that makes cross-sheet joins work at all.

Execution model (sandbox-safe equivalent of the reference's in-process
namespace): each step's script = sheet loader + the accumulated code of all
previously *successful* steps + the current step's code. Derived frames
(merges, pivots, intermediate aggregates) therefore persist across steps;
a state-snapshot epilogue reports every live DataFrame back to the state
machine after each step. Steps are deterministic pure pandas, so prefix
re-execution is cheap and cacheable (plan-prefix cache, used by the MCTS
planner to avoid re-running unchanged prefixes across iterations).

The port's copy of ``youtu_rag_tpu/integrations/dtr/smg.py``, with three
sandbox repairs that change no step's output: the fork-server's output files
are made with ``mkstemp`` (``O_EXCL``) and unlinked on a timeout too; a
step runs in a session of its own, so a timeout kills its process group
(the subprocesses it started with it); and ``_run_script`` returns an
explicit timeout flag, so a step killed by SIGKILL from outside (rc -9)
reads as the crash it is, not as a timeout.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any

from ...utils.log import get_logger

logger = get_logger("dtr.smg")

_STATE_MARK = "__SMG_STATE__"

# appended to every step script: snapshot all live DataFrames
_STATE_EPILOGUE = f"""
import json as _json
import pandas as _pd
_state = {{}}
for _name, _val in list(globals().items()):
    if isinstance(_val, _pd.DataFrame) and not _name.startswith('_'):
        _state[_name] = {{
            "shape": list(_val.shape),
            "columns": [str(c) for c in _val.columns][:60],
            "dtypes": {{str(c): str(t) for c, t in list(_val.dtypes.items())[:60]}},
        }}
    elif isinstance(_val, dict) and _name == 'dfs':
        for _k, _v in _val.items():
            if isinstance(_v, _pd.DataFrame):
                _state[f"dfs[{{_k!r}}]"] = {{
                    "shape": list(_v.shape),
                    "columns": [str(c) for c in _v.columns][:60],
                    "dtypes": {{str(c): str(t) for c, t in list(_v.dtypes.items())[:60]}},
                }}
print({_STATE_MARK!r} + _json.dumps(_state))
"""


# --------------------------------------------------------------- forkserver
#
# Cold-starting `python step.py` costs ~1-2 s of interpreter + pandas import
# PER STEP; an MCTS benchmark run is thousands of steps, which turns into
# hours on a single core. The fork-server keeps ONE warm worker process
# (pandas imported once) and runs each step script in a forked child — the
# same per-step process isolation (crashes, leaked globals, os._exit, memory
# all die with the child) at ~10 ms instead of ~1.5 s. Disable with
# YRT_DTR_FORKSERVER=0 to fall back to the cold-subprocess path.

_FORKSERVER_SRC = r"""
import json, os, sys, tempfile, time
import pandas  # noqa: F401  - pre-import: the expensive part of each step

inp, outp = sys.stdin.buffer, sys.stdout.buffer

def unlink(p):
    try: os.unlink(p)
    except OSError: pass

def run(script, timeout):
    so, out_path = tempfile.mkstemp(suffix=".out")
    se, err_path = tempfile.mkstemp(suffix=".err")
    pid = os.fork()
    if pid == 0:  # child: fresh __main__-style namespace, stdio to files
        try:
            os.setsid()  # its own process group: a timeout kills what it started
            os.dup2(so, 1); os.dup2(se, 2)
            exec(compile(script, "<step>", "exec"), {"__name__": "__main__"})
            sys.stdout.flush(); sys.stderr.flush()
            os._exit(0)
        except SystemExit as e:
            sys.stdout.flush(); sys.stderr.flush()
            os._exit(int(e.code or 0) if not isinstance(e.code, str) else 1)
        except BaseException as e:
            import traceback
            # skip the forkserver's own exec frame: the reported traceback
            # starts at <step>, matching the cold-subprocess path
            traceback.print_exception(type(e), e, e.__traceback__.tb_next)
            sys.stdout.flush(); sys.stderr.flush()
            os._exit(1)
    os.close(so); os.close(se)
    deadline = time.time() + timeout
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.time() > deadline:
            try: os.killpg(pid, 9)
            except OSError: os.kill(pid, 9)
            os.waitpid(pid, 0)
            unlink(out_path); unlink(err_path)
            return {"timeout": True, "out": "", "err": "", "rc": -9}
        time.sleep(0.003)
    rc = os.waitstatus_to_exitcode(status)
    def rd(p):
        try:
            with open(p, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""
        finally:
            unlink(p)
    return {"timeout": False, "out": rd(out_path), "err": rd(err_path), "rc": rc}

while True:
    header = inp.readline()
    if not header:
        break
    req = json.loads(header)
    script = inp.read(req["n"]).decode()
    res = run(script, req["timeout"])
    blob = json.dumps(res).encode()
    outp.write(str(len(blob)).encode() + b"\n" + blob)
    outp.flush()
"""


class _ForkServer:
    """Singleton warm worker. A plain ``subprocess.Popen`` (NOT an asyncio
    transport) so the process survives across asyncio.run() loops without
    leaking loop-bound transports; the blocking pipe round-trip runs in the
    default thread-pool executor. One in-flight request at a time (the pipe
    protocol is serial) — step execution is serial anyway."""

    _proc = None
    _io_lock = None  # created lazily (threading.Lock)
    _atexit_registered = False

    @classmethod
    def _shutdown(cls) -> None:
        if cls._proc is not None and cls._proc.poll() is None:
            cls._proc.kill()

    @classmethod
    def _roundtrip(cls, script: str, timeout: float) -> dict:
        import subprocess

        with cls._io_lock:
            if cls._proc is None or cls._proc.poll() is not None:
                cls._proc = subprocess.Popen(
                    [sys.executable, "-c", _FORKSERVER_SRC],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL,
                )
                if not cls._atexit_registered:
                    import atexit

                    atexit.register(cls._shutdown)
                    cls._atexit_registered = True
            p = cls._proc
            data = script.encode()
            p.stdin.write(
                json.dumps({"n": len(data), "timeout": timeout}).encode()
                + b"\n" + data
            )
            p.stdin.flush()
            header = p.stdout.readline()
            if not header:
                raise RuntimeError("forkserver died")
            blob = p.stdout.read(int(header))
            return json.loads(blob)

    @classmethod
    async def execute(cls, script: str, timeout: float) -> dict:
        if cls._io_lock is None:
            import threading

            cls._io_lock = threading.Lock()
        loop = asyncio.get_running_loop()
        try:
            # worker enforces `timeout` itself (kills the forked child);
            # the outer margin only catches a wedged worker
            return await asyncio.wait_for(
                loop.run_in_executor(None, cls._roundtrip, script, timeout),
                timeout + 20,
            )
        except (Exception, asyncio.TimeoutError):
            cls._shutdown()
            cls._proc = None
            raise


@dataclass
class TableState:
    """Schema/shape snapshot of one frame (ref: dtr_structures.TableState)."""

    shape: tuple[int, int] = (0, 0)
    columns: list[str] = field(default_factory=list)
    dtypes: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_snapshot(cls, d: dict[str, Any]) -> "TableState":
        return cls(tuple(d.get("shape", (0, 0))), list(d.get("columns", [])), dict(d.get("dtypes", {})))

    def summary(self) -> str:
        cols = ", ".join(self.columns[:12]) + ("…" if len(self.columns) > 12 else "")
        return f"{self.shape[0]}x{self.shape[1]} [{cols}]"


@dataclass
class SMGNode:
    """One executed step in the memory graph (ref: dtr_structures.SMGNode)."""

    description: str
    code: str = ""
    output: str = ""
    success: bool = False
    attempts: int = 0
    state_before: dict[str, TableState] = field(default_factory=dict)
    state_after: dict[str, TableState] = field(default_factory=dict)
    reward: float = 0.0

    @property
    def new_frames(self) -> list[str]:
        return [k for k in self.state_after if k not in self.state_before]

    @property
    def changed_frames(self) -> list[str]:
        return [
            k
            for k, st in self.state_after.items()
            if k in self.state_before
            and (st.shape != self.state_before[k].shape or st.columns != self.state_before[k].columns)
        ]


_FORBIDDEN_CODE = re.compile(
    r"\b(os\.system|subprocess|shutil\.rmtree|__import__|eval\s*\(|exec\s*\()"
)


def validate_code_structure(code: str) -> tuple[bool, str]:
    """Pre-execution gate (ref ``smg_module._validate_code_structure``
    :1611): reject empty, syntactically broken, or obviously dangerous
    step code before paying a sandbox subprocess round-trip. The sandbox
    remains the real isolation boundary — this is a fast-fail that turns
    a ~100ms subprocess error into an immediate, precise message the
    code-repair loop can act on."""
    if not code.strip():
        return False, "empty code"
    try:
        compile(code, "<step>", "exec")
    except SyntaxError as e:
        return False, f"syntax error at line {e.lineno}: {e.msg}"
    m = _FORBIDDEN_CODE.search(code)
    if m:
        return False, f"forbidden construct: {m.group(1)}"
    return True, ""


class SheetStateMachine:
    """Tracks every sheet + derived frame through the analysis and executes
    step code with accumulated state."""

    def __init__(
        self,
        path: str,
        exec_timeout: float = 30.0,
        prefix_cache: dict | None = None,
    ):
        self.path = path
        self.exec_timeout = exec_timeout
        self.nodes: list[SMGNode] = []
        self.state: dict[str, TableState] = {}
        # (step-description prefix) → executed nodes; lets the MCTS planner
        # reuse unchanged plan prefixes instead of re-running every step
        # (r1 weak #7: rollouts re-executed full plans each iteration).
        # Pass a shared dict so PARALLEL rollouts (one machine each)
        # still pool their executed prefixes.
        self._prefix_cache: dict[tuple[str, ...], list[SMGNode]] = (
            prefix_cache if prefix_cache is not None else {}
        )
        # operator-outcome stats keyed by step signature, both global
        # ("merge") and context-conditioned ("merge@f2:region,revenue")
        self.op_stats: dict[str, dict[str, int]] = {}
        # successful step phrasings per (op @ context) — code-gen hints
        self._suggestions: dict[str, list[str]] = {}

    # -- execution ----------------------------------------------------------

    def _loader(self) -> str:
        # keep the accepted formats in lockstep with loader.load_sheets:
        # csv/tsv files, csv/tsv directories, else excel
        p = self.path
        return (
            "import os as _os\n"
            "import pandas as pd\n"
            f"_p = {p!r}\n"
            "def _sep(_f):\n"
            "    return '\\t' if _f.endswith('.tsv') else ','\n"
            "if _os.path.isdir(_p):\n"
            "    dfs = {_os.path.splitext(_f)[0]:\n"
            "           pd.read_csv(_os.path.join(_p, _f), sep=_sep(_f))\n"
            "           for _f in sorted(_os.listdir(_p))\n"
            "           if _f.endswith(('.csv', '.tsv'))}\n"
            "elif _p.endswith(('.csv', '.tsv')):\n"
            "    dfs = {'Sheet1': pd.read_csv(_p, sep=_sep(_p))}\n"
            "else:\n"
            "    dfs = pd.read_excel(_p, sheet_name=None)\n"
        )

    def _successful_prefix_code(self) -> str:
        return "\n".join(n.code for n in self.nodes if n.success)

    async def execute_step(self, code: str) -> tuple[str, dict[str, TableState]]:
        """Run loader + successful-prefix + step code; returns (step output,
        post-state). Prefix prints are suppressed so the output belongs to
        this step alone."""
        ok, reason = validate_code_structure(code)
        if not ok:
            return f"Error: rejected before execution — {reason}", {}
        prefix = self._successful_prefix_code()
        script = self._loader()
        if prefix:
            # silence prior steps' prints: they already reported
            script += (
                "import io as _io, contextlib as _ctx\n"
                "with _ctx.redirect_stdout(_io.StringIO()):\n"
                + "".join(f"    {line}\n" for line in prefix.split("\n"))
            )
        script += code + "\n" + _STATE_EPILOGUE
        text, err, rc, timed_out = await self._run_script(script)
        if timed_out:
            return "Error: execution timed out", {}
        state: dict[str, TableState] = {}
        lines = []
        for line in text.split("\n"):
            if line.startswith(_STATE_MARK):
                try:
                    state = {
                        k: TableState.from_snapshot(v)
                        for k, v in json.loads(line[len(_STATE_MARK):]).items()
                    }
                except json.JSONDecodeError:
                    pass
            else:
                lines.append(line)
        text = "\n".join(lines).strip()
        if rc != 0:
            text += f"\nError: {err.strip()[-800:]}"
        return text or "(no output)", state

    async def _run_script(self, script: str) -> tuple[str, str, int, bool]:
        """(stdout, stderr, rc, timed out). Warm fork-server first, cold
        subprocess as the fallback isolation path."""
        if os.environ.get("YRT_DTR_FORKSERVER", "1") != "0":
            try:
                res = await _ForkServer.execute(script, self.exec_timeout)
                if res.get("timeout"):
                    return "", "", -9, True
                return res["out"], res["err"], res["rc"], False
            except Exception as e:  # noqa: BLE001 - degrade to cold path
                logger.warning("forkserver failed (%s); cold subprocess", e)
        with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
            f.write(script)
            name = f.name
        proc = await asyncio.create_subprocess_exec(
            "python", name,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
            start_new_session=True,
        )
        try:
            out, err = await asyncio.wait_for(
                proc.communicate(), timeout=self.exec_timeout
            )
        except asyncio.TimeoutError:
            try:
                os.killpg(proc.pid, 9)
            except OSError:
                proc.kill()
            await proc.wait()
            return "", "", -9, True
        finally:
            os.unlink(name)
        return (
            out.decode(errors="replace"),
            err.decode(errors="replace"),
            proc.returncode or 0,
            False,
        )

    def record(self, node: SMGNode, state_after: dict[str, TableState]) -> None:
        node.state_before = dict(self.state)
        ctx = self.context_signature()  # BEFORE adopting the new state
        node.state_after = state_after or dict(self.state)
        self.nodes.append(node)
        if node.success and state_after:
            self.state = state_after
        sig = _op_signature(node.description)
        for key in (sig, f"{sig}@{ctx}"):
            st = self.op_stats.setdefault(key, {"uses": 0, "successes": 0})
            st["uses"] += 1
            st["successes"] += int(node.success)
        if node.success:
            sugg = self._suggestions.setdefault(f"{sig}@{ctx}", [])
            if node.description not in sugg:
                sugg.append(node.description)
                del sugg[:-5]  # keep the 5 most recent per context

    # -- context-conditioned experience (ref smg_module._get_table_
    # signature:1771, get_context_suggestions:1806, get_success_rate:1820,
    # save/load_memory_to_persistent:1672-1679) ---------------------------

    def context_signature(self) -> str:
        """Coarse signature of the live frame state: frame count bucket +
        the most common column-name tokens. Two analyses over similarly
        shaped data share a signature, so operator success rates learned
        on one transfer to the other."""
        tokens: dict[str, int] = {}
        for st in self.state.values():
            for c in st.columns[:20]:
                for t in _OP_WORDS.findall(str(c).lower()):
                    tokens[t] = tokens.get(t, 0) + 1
        top = sorted(tokens, key=lambda t: (-tokens[t], t))[:4]
        return f"f{min(len(self.state), 4)}:" + ",".join(top)

    # -- prefix cache (MCTS reuse) -------------------------------------------

    def cached_prefix(self, plan: list[str]) -> list[SMGNode]:
        """Longest cached prefix of successfully executed plan steps."""
        for i in range(len(plan), 0, -1):
            hit = self._prefix_cache.get(tuple(plan[:i]))
            if hit is not None and all(n.success for n in hit):
                return list(hit)
        return []

    def cache_prefix(self, plan_prefix: list[str], nodes: list[SMGNode]) -> None:
        self._prefix_cache[tuple(plan_prefix)] = list(nodes)

    def reset_to(self, nodes: list[SMGNode]) -> None:
        """Rewind the machine to a cached execution prefix."""
        self.nodes = list(nodes)
        self.state = dict(nodes[-1].state_after) if nodes else {}

    # -- state feedback for code generation -----------------------------------

    def state_summary(self) -> str:
        """Live frame inventory for the code-gen prompt (the reference's
        get_code_generation_hints / _build_step_context role)."""
        if not self.state:
            return "(no frames executed yet — only `dfs` sheet dict is loaded)"
        lines = ["Live frames from previous steps (reusable by name):"]
        for name, st in self.state.items():
            lines.append(f"- {name}: {st.summary()}")
        return "\n".join(lines)

    def success_rate(self, description: str, use_context: bool = True) -> float | None:
        """Success rate for this operator — context-conditioned when the
        current frame signature has history, global otherwise."""
        sig = _op_signature(description)
        if use_context:
            st = self.op_stats.get(f"{sig}@{self.context_signature()}")
            if st and st["uses"]:
                return st["successes"] / st["uses"]
        st = self.op_stats.get(sig)
        if not st or not st["uses"]:
            return None
        return st["successes"] / st["uses"]

    def context_hints(self, description: str) -> str:
        """Past successful step phrasings for this operator in a similar
        frame context — prepended to code-gen prompts (ref
        get_code_generation_hints)."""
        sig = _op_signature(description)
        sugg = self._suggestions.get(f"{sig}@{self.context_signature()}", [])
        rate = self.success_rate(description)
        parts = []
        if sugg:
            parts.append("similar past steps that worked: " + "; ".join(sugg[-3:]))
        if rate is not None:
            parts.append(f"operator '{sig}' success rate here: {rate:.0%}")
        return " | ".join(parts)

    def save_memory(self, path) -> None:
        """Persist operator experience across sessions (ref
        save_memory_to_persistent)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"op_stats": self.op_stats, "suggestions": self._suggestions}, f
            )

    def load_memory(self, path) -> bool:
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        self.op_stats.update(data.get("op_stats", {}))
        for k, v in data.get("suggestions", {}).items():
            cur = self._suggestions.setdefault(k, [])
            for s in v:
                if s not in cur:
                    cur.append(s)
            del cur[:-5]
        return True

    def memory_summary(self) -> dict[str, Any]:
        return {
            "steps": len(self.nodes),
            "succeeded": sum(n.success for n in self.nodes),
            "frames": {k: v.summary() for k, v in self.state.items()},
            "op_stats": self.op_stats,
        }


_OP_WORDS = re.compile(r"[a-z]+")
_OP_KINDS = (
    "merge", "join", "group", "aggregate", "sum", "mean", "count", "filter",
    "sort", "pivot", "clean", "rank", "top", "compare", "compute",
)


def _op_signature(description: str) -> str:
    """Coarse operator category of a step (ref OperatorType buckets)."""
    words = set(_OP_WORDS.findall(description.lower()))
    for kind in _OP_KINDS:
        if kind in words:
            return kind
    return "other"


# ---------------------------------------------------------------------------
# schema linking (ref: integrations/DTR schema linking, 542 LoC): rank sheets
# and columns by relevance to the question so many-sheet workbooks prompt
# with the few that matter.
# ---------------------------------------------------------------------------


def link_sheets(question: str, sheets: dict[str, Any], top_n: int = 4) -> list[tuple[str, float, list[str]]]:
    """Score (sheet, relevance, matched_columns) by lexical overlap between
    the question and sheet/column/sample tokens. Deterministic — the element
    -index embedding variant rides the KB toolkit when one is attached."""
    q_tokens = set(_OP_WORDS.findall(question.lower()))
    out = []
    for name, df in sheets.items():
        cols = [str(c) for c in df.columns]
        col_tokens = {t for c in cols for t in _OP_WORDS.findall(c.lower())}
        name_tokens = set(_OP_WORDS.findall(str(name).lower()))
        sample_tokens: set[str] = set()
        for c in cols[:10]:
            try:
                vals = df[c].astype(str).head(8)
                sample_tokens |= {t for v in vals for t in _OP_WORDS.findall(v.lower())}
            except Exception:  # noqa: BLE001
                continue
        score = (
            2.0 * len(q_tokens & col_tokens)
            + 1.5 * len(q_tokens & name_tokens)
            + 1.0 * len(q_tokens & sample_tokens)
        )
        matched = [c for c in cols if set(_OP_WORDS.findall(c.lower())) & q_tokens]
        out.append((name, score, matched))
    out.sort(key=lambda t: -t[1])
    return out[:top_n]
