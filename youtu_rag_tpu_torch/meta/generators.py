"""Meta generators: agents that generate agent configs and toolkits.

Parity with ``utu/meta`` (``SimpleAgentGenerator`` writing YAML configs,
``simple_agent_generator.py:30-237``; ``ToolGenerator(MCP)``,
``tool_generator_mcp.py:150``): an LLM drafts the artifact, the generator
validates it against the real loaders (AgentConfig validation / toolkit
import + schema generation) and retries with the error appended — the
debugger loop of ``tool_generator_mcp_debugger.py``.

A copy of ``youtu_rag_tpu/meta/generators.py`` on the port: a generated
toolkit subclasses the port's ``youtu_rag_tpu_torch.tools.base``
``AsyncBaseToolkit`` (``TOOL_GEN_PROMPT`` names it), and ``yaml`` is
imported only by the functions that read or write YAML."""

from __future__ import annotations

import re
from pathlib import Path

from ..agents.config import AgentConfig
from ..utils.log import get_logger

logger = get_logger("meta.generators")

AGENT_GEN_PROMPT = """Design a simple agent config for this request.

Request: {requirement}

Available toolkits: {toolkits}

Reply YAML only (no fences) with keys: type (simple), agent (name,
instructions), toolkits (mapping of toolkit-name -> {{mode: builtin,
activated_tools: [...] or null}}), max_turns.
{error_context}"""

TOOL_GEN_PROMPT = """Write a Python toolkit class for this requirement.

Requirement: {requirement}

Rules:
- subclass AsyncBaseToolkit from youtu_rag_tpu_torch.tools.base
- decorate async tool methods with @register_tool
- every tool method has a Google-style docstring with an Args: section
- return strings from tools
- no imports beyond the Python standard library and httpx

Reply with the Python source only (no fences).
{error_context}"""


class SimpleAgentGenerator:
    def __init__(self, llm_agent, max_retries: int = 2):
        self.llm = llm_agent
        self.max_retries = max_retries

    async def generate(self, requirement: str) -> AgentConfig:
        import yaml

        from ..tools import TOOLKIT_MAP
        from ..tools import builtin  # noqa: F401 - populate registry

        toolkits = ", ".join(sorted(TOOLKIT_MAP))
        error_context = ""
        last_err: Exception | None = None
        for _ in range(self.max_retries + 1):
            raw = await self.llm.run(
                AGENT_GEN_PROMPT.format(
                    requirement=requirement, toolkits=toolkits, error_context=error_context
                )
            )
            raw = re.sub(r"^```[a-z]*\n|\n```$", "", raw.strip())
            try:
                data = yaml.safe_load(raw)
                return AgentConfig.model_validate(data)
            except Exception as e:  # noqa: BLE001 - feed error back to LLM
                last_err = e
                error_context = f"Your previous output failed validation: {e}. Fix it."
        raise ValueError(f"agent generation failed: {last_err}")

    async def generate_to_file(self, requirement: str, path: str | Path) -> AgentConfig:
        import yaml

        cfg = await self.generate(requirement)
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(yaml.safe_dump(cfg.model_dump(), allow_unicode=True, sort_keys=False))
        logger.info("wrote agent config to %s", p)
        return cfg


class ToolGenerator:
    def __init__(self, llm_agent, max_retries: int = 2):
        self.llm = llm_agent
        self.max_retries = max_retries

    async def generate(self, requirement: str) -> tuple[str, type]:
        """Returns (source, toolkit_class); the class is import-validated
        and its schemas generated as the debug check."""
        error_context = ""
        last_err: Exception | None = None
        for _ in range(self.max_retries + 1):
            raw = await self.llm.run(
                TOOL_GEN_PROMPT.format(requirement=requirement, error_context=error_context)
            )
            source = re.sub(r"^```[a-z]*\n|\n```$", "", raw.strip())
            try:
                cls = self._validate(source)
                return source, cls
            except Exception as e:  # noqa: BLE001
                last_err = e
                error_context = f"Your previous code failed: {e}. Fix it."
        raise ValueError(f"tool generation failed: {last_err}")

    @staticmethod
    def _validate(source: str) -> type:
        from ..tools.base import AsyncBaseToolkit

        namespace: dict = {}
        exec(compile(source, "<generated_toolkit>", "exec"), namespace)  # noqa: S102
        classes = [
            v
            for v in namespace.values()
            if isinstance(v, type) and issubclass(v, AsyncBaseToolkit) and v is not AsyncBaseToolkit
        ]
        if not classes:
            raise ValueError("no AsyncBaseToolkit subclass defined")
        cls = classes[0]
        inst = cls()
        if not inst.tools_map:
            raise ValueError("toolkit defines no @register_tool methods")
        schemas = inst.get_tools_in_openai()
        for s in schemas:
            if not s["function"]["description"]:
                raise ValueError(f"tool {s['function']['name']} lacks a docstring summary")
        return cls

    async def generate_to_file(self, requirement: str, path: str | Path) -> type:
        source, cls = await self.generate(requirement)
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(source)
        logger.info("wrote toolkit to %s", p)
        return cls


SAMPLE_ARGS_PROMPT = """Propose realistic sample arguments to smoke-test this tool.

Tool: {name}
Description: {description}
Parameters (JSON schema): {schema}

Reply JSON only: an object mapping every required parameter to a sample value."""

TOOL_FIX_PROMPT = """Your generated toolkit imports cleanly but CRASHES when \
its tools are called. Fix the code.

Requirement: {requirement}

Current source:
{source}

Runtime failures (tool name, sample arguments, traceback):
{failures}

Rules unchanged: subclass AsyncBaseToolkit, @register_tool methods with
Args: docstrings, return strings, stdlib+httpx only.
Reply with the FULL corrected Python source only (no fences)."""


class ToolDebugger:
    """Iterative generate → import → **call-with-sample-args** → feed the
    traceback back loop (ref: ``tool_generator_mcp_debugger.py`` — the
    reference drives a bash/file-edit agent over a workspace; here the
    loop is explicit and hermetic: every @register_tool method is invoked
    through ``call_tool`` with sample arguments, and runtime tracebacks —
    not just import errors — go back to the LLM for repair)."""

    def __init__(self, llm_agent, max_rounds: int = 2, generator: ToolGenerator | None = None):
        self.llm = llm_agent
        self.max_rounds = max_rounds
        self.generator = generator or ToolGenerator(llm_agent)

    @staticmethod
    def _sample_from_schema(schema: dict) -> dict:
        """Deterministic schema-derived sample args (the LLM proposal's
        fallback): required params filled by JSON type."""
        fill = {"string": "sample", "integer": 1, "number": 1.0,
                "boolean": False, "array": [], "object": {}}
        params = schema.get("parameters") or {}
        props = params.get("properties") or {}
        out = {}
        for name in params.get("required") or list(props):
            p = props.get(name) or {}
            if "enum" in p and p["enum"]:
                out[name] = p["enum"][0]
            else:
                out[name] = fill.get(p.get("type", "string"), "sample")
        return out

    async def _sample_args(self, fn_schema: dict) -> dict:
        import json as _json

        try:
            raw = await self.llm.run(
                SAMPLE_ARGS_PROMPT.format(
                    name=fn_schema["name"],
                    description=fn_schema.get("description", ""),
                    schema=_json.dumps(fn_schema.get("parameters") or {}),
                )
            )
            m = re.search(r"\{.*\}", raw, re.DOTALL)
            args = _json.loads(m.group(0)) if m else {}
            if isinstance(args, dict) and args:
                return args
        except Exception:  # noqa: BLE001 - deterministic fallback below
            pass
        return self._sample_from_schema(fn_schema)

    async def _smoke(self, cls: type) -> list[str]:
        """Call every tool with sample args; return traceback summaries."""
        import traceback

        inst = cls()
        failures: list[str] = []
        for schema in inst.get_tools_in_openai():
            fn = schema["function"]
            args = await self._sample_args(fn)
            try:
                out = await inst.call_tool(fn["name"], args)
                if not isinstance(out, str):
                    failures.append(
                        f"tool {fn['name']}({args}): returned "
                        f"{type(out).__name__}, tools must return str"
                    )
            except Exception:  # noqa: BLE001 - the traceback IS the signal
                tb = traceback.format_exc(limit=4)
                failures.append(f"tool {fn['name']}({args}):\n{tb}")
        return failures

    async def debug(self, requirement: str) -> tuple[str, type, dict]:
        """Generate a toolkit, smoke every tool, repair on tracebacks.

        Returns (source, cls, report) where report records the rounds and
        residual failures (empty = every tool executed)."""
        source, cls = await self.generator.generate(requirement)
        report: dict = {"rounds": 0, "failures": []}
        for round_no in range(self.max_rounds + 1):
            failures = await self._smoke(cls)
            report["rounds"] = round_no
            report["failures"] = failures
            if not failures:
                return source, cls, report
            if round_no == self.max_rounds:
                break
            raw = await self.llm.run(
                TOOL_FIX_PROMPT.format(
                    requirement=requirement,
                    source=source,
                    failures="\n\n".join(failures)[:4000],
                )
            )
            candidate = re.sub(r"^```[a-z]*\n|\n```$", "", raw.strip())
            try:
                cls = ToolGenerator._validate(candidate)
                source = candidate
            except Exception as e:  # noqa: BLE001 - keep the old source
                report["failures"].append(f"repair attempt invalid: {e}")
        raise ValueError(
            f"toolkit still failing after {self.max_rounds} repair rounds: "
            f"{report['failures'][:2]}"
        )

    async def debug_to_file(self, requirement: str, path: str | Path) -> type:
        source, cls, report = await self.debug(requirement)
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(source)
        logger.info("wrote debugged toolkit to %s (%s rounds)", p, report["rounds"])
        return cls
