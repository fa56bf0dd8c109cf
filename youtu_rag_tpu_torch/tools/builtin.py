"""Builtin toolkit registry population + small utility toolkits.

Importing this module fills TOOLKIT_MAP (ref: utu/tools/__init__.py:25-46).
Heavier toolkits live in their own modules; the executors here mirror
``python_executor_toolkit.py`` / ``bash_toolkit.py`` with subprocess
sandboxes (no IPython/pexpect dependency).

The port's copy of ``youtu_rag_tpu/tools/builtin.py``.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import uuid
from pathlib import Path

from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

# import-for-registration
from .kb_search import KBSearchToolkit  # noqa: F401
from .meta_retrieval import MetaRetrievalToolkit  # noqa: F401
from .text2sql import Text2SQLToolkit  # noqa: F401
from .web import (  # noqa: F401
    ArxivToolkit,
    DocumentToolkit,
    GitHubToolkit,
    SearchToolkit,
    WikipediaToolkit,
)
from .misc import (  # noqa: F401
    AudioToolkit,
    CodesnipToolkit,
    ImageToolkit,
    SimpleMemoryToolkit,
    TabularToolkit,
    UserInteractionToolkit,
    VideoToolkit,
)
from .file_edit import FileEditToolkit  # noqa: F401
from .rag_toolkit import RAGToolkit  # noqa: F401
from .html_toolkit import HTMLToolkit  # noqa: F401
from .mcp_client import MCPToolkit  # noqa: F401
from ..memory.toolkit import VectorMemoryToolkit  # noqa: F401


@register_toolkit("python_executor")
class PythonExecutorToolkit(AsyncBaseToolkit):
    """Run python snippets in a subprocess workspace
    (ref: utu/tools/python_executor_toolkit.py, /tmp workspaces)."""

    def __init__(self, config=None):
        super().__init__(config)
        self.workspace = self.config.config.get("workspace") or tempfile.mkdtemp(prefix="yrt-py-")
        self.timeout = float(self.config.config.get("timeout", 30.0))

    @register_tool
    async def execute_python_code(self, code: str) -> str:
        """Execute Python code and return stdout/stderr.

        Args:
            code: The Python source to execute.
        """
        os.makedirs(self.workspace, exist_ok=True)
        # unique filename per call: concurrent executions share the
        # workspace (eval rollout runs agents under a semaphore of 4), and
        # a fixed name lets call B overwrite A's script before A's
        # subprocess starts
        script = Path(self.workspace) / f"snippet_{uuid.uuid4().hex[:12]}.py"
        script.write_text(code, encoding="utf-8")
        proc = await asyncio.create_subprocess_exec(
            "python",
            str(script),
            cwd=self.workspace,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        try:
            out, err = await asyncio.wait_for(proc.communicate(), timeout=self.timeout)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()  # reap: kill() alone leaves a zombie when the loop closes
            return f"Error: execution timed out after {self.timeout}s"
        finally:
            script.unlink(missing_ok=True)
        text = out.decode(errors="replace")
        if err:
            text += ("\n[stderr]\n" if text else "[stderr]\n") + err.decode(errors="replace")
        return text.strip() or "(no output)"


@register_toolkit("bash")
class BashToolkit(AsyncBaseToolkit):
    """Run shell commands in a persistent working directory
    (ref: utu/tools/bash_toolkit.py)."""

    def __init__(self, config=None):
        super().__init__(config)
        self.workspace = self.config.config.get("workspace") or tempfile.mkdtemp(prefix="yrt-sh-")
        self.timeout = float(self.config.config.get("timeout", 30.0))

    @register_tool
    async def run_bash(self, command: str) -> str:
        """Run a bash command and return its output.

        Args:
            command: The shell command line to execute.
        """
        os.makedirs(self.workspace, exist_ok=True)
        proc = await asyncio.create_subprocess_shell(
            command,
            cwd=self.workspace,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
        )
        try:
            out, _ = await asyncio.wait_for(proc.communicate(), timeout=self.timeout)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()  # reap: kill() alone leaves a zombie when the loop closes
            return f"Error: command timed out after {self.timeout}s"
        return out.decode(errors="replace").strip() or "(no output)"


@register_toolkit("file")
class FileToolkit(AsyncBaseToolkit):
    """Read/write/list files in a workspace (ref: utu/rag/rag_tools/
    file_toolkit.py downloads KB files into the python workspace; here the
    workspace is local)."""

    def __init__(self, config=None):
        super().__init__(config)
        self.workspace = self.config.config.get("workspace") or tempfile.mkdtemp(prefix="yrt-fs-")

    def _resolve(self, path: str) -> Path:
        # is_relative_to, not a string-prefix check: '/srv/agent-secrets'
        # shares the prefix of workspace '/srv/agent' but is outside it
        base = Path(self.workspace).resolve()
        p = (base / path).resolve()
        if not p.is_relative_to(base):
            raise ValueError("path escapes workspace")
        return p

    @register_tool
    async def read_file(self, path: str, max_chars: int = 8000) -> str:
        """Read a text file from the workspace.

        Args:
            path: Relative path inside the workspace.
            max_chars: Truncate the content to this many characters.
        """
        p = self._resolve(path)
        if not p.exists():
            return f"Error: {path} does not exist"
        return p.read_text(encoding="utf-8", errors="replace")[:max_chars]

    @register_tool
    async def write_file(self, path: str, content: str) -> str:
        """Write a text file into the workspace.

        Args:
            path: Relative path inside the workspace.
            content: File content to write.
        """
        p = self._resolve(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content, encoding="utf-8")
        return f"Wrote {len(content)} chars to {path}"

    @register_tool
    async def list_files(self, path: str = ".") -> str:
        """List files under a workspace directory.

        Args:
            path: Relative directory inside the workspace.
        """
        p = self._resolve(path)
        if not p.exists():
            return f"Error: {path} does not exist"
        entries = sorted(x.name + ("/" if x.is_dir() else "") for x in p.iterdir())
        return "\n".join(entries) or "(empty)"
