"""File editing toolkit: sandboxed read / write / search-replace edits.

Parity surface: ``utu/tools/file_edit_toolkit.py:21-124`` — a workspace-rooted
toolkit exposing ``read_file`` / ``write_file`` / ``edit_file`` where edits
arrive as ``<<<<<<< SEARCH / ======= / >>>>>>> REPLACE`` blocks (the format
agent prompts already know). Differences from the reference: path escapes
raise (``is_relative_to`` after resolve, same guard as LocalFileStore),
edit results report how many blocks applied vs missed instead of logging
silently, and backups are timestamp+counter-unique.

The port's copy of ``youtu_rag_tpu/tools/file_edit.py``.
"""

from __future__ import annotations

import re
import shutil
import time
from pathlib import Path

from ..utils.log import get_logger
from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

logger = get_logger("tools.file_edit")

_BLOCK_RE = re.compile(
    r"<<<<<<< SEARCH\n(.*?)\n=======\n(.*?)\n>>>>>>> REPLACE", re.DOTALL
)


@register_toolkit("file_edit")
class FileEditToolkit(AsyncBaseToolkit):
    """Edit files inside a workspace directory.

    Config keys: ``workspace_root`` (default ``/tmp/yrt_workspace``),
    ``default_encoding`` (utf-8), ``backup_enabled`` (False)."""

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config.config
        self.work_dir = Path(cfg.get("workspace_root", "/tmp/yrt_workspace")).resolve()
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.encoding = cfg.get("default_encoding", "utf-8")
        self.backup_enabled = bool(cfg.get("backup_enabled", False))
        self._backup_seq = 0

    def _resolve(self, file_path: str) -> Path:
        p = Path(file_path)
        if not p.is_absolute():
            p = self.work_dir / p
        # sanitize only the filename; parent dirs are validated by the
        # workspace containment check below
        safe_name = re.sub(r"[^\w\-.]", "_", p.name)
        resolved = (p.parent / safe_name).resolve()
        if resolved == self.work_dir or not resolved.is_relative_to(self.work_dir):
            raise ValueError(
                f"path {file_path!r} resolves outside the workspace {self.work_dir}"
            )
        return resolved

    def _backup(self, path: Path) -> None:
        if not self.backup_enabled or not path.exists():
            return
        self._backup_seq += 1
        stamp = time.strftime("%Y%m%d_%H%M%S")
        dst = path.parent / f"{path.name}.{stamp}_{self._backup_seq}.bak"
        shutil.copy2(path, dst)
        logger.info("backup written: %s", dst)

    @register_tool
    async def read_file(self, path: str) -> str:
        """Read and return the contents of a file in the workspace.

        Args:
            path: File path (relative paths resolve under the workspace).
        """
        return self._resolve(path).read_text(encoding=self.encoding)

    @register_tool
    async def write_file(self, path: str, file_text: str) -> str:
        """Write (create or overwrite) a file in the workspace.

        Args:
            path: File path (relative paths resolve under the workspace).
            file_text: Full text content to write.
        """
        p = self._resolve(path)
        self._backup(p)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(file_text, encoding=self.encoding)
        return f"Successfully wrote file: {p}"

    @register_tool
    async def edit_file(self, path: str, diff: str) -> str:
        """Apply SEARCH/REPLACE edit blocks to an existing file.

        Args:
            path: File path (relative paths resolve under the workspace).
            diff: One or more blocks in this exact format::

                <<<<<<< SEARCH
                [exact content to find]
                =======
                [new content to replace with]
                >>>>>>> REPLACE
        """
        p = self._resolve(path)
        blocks = _BLOCK_RE.findall(diff)
        if not blocks:
            return "Error: no valid SEARCH/REPLACE blocks found in the provided diff"
        if not p.exists():
            return f"Error: file not found: {p}"
        self._backup(p)
        content = p.read_text(encoding=self.encoding)
        applied, missed = 0, []
        for search, replace in blocks:
            if search in content:
                # one occurrence per block: SEARCH/REPLACE targets a single
                # site; replace-all silently rewrote every match (and later
                # blocks could match text just produced by earlier ones)
                content = content.replace(search, replace, 1)
                applied += 1
            else:
                missed.append(search[:60])
        p.write_text(content, encoding=self.encoding)
        msg = f"Edited {p}: {applied}/{len(blocks)} block(s) applied"
        if missed:
            msg += "; SEARCH text not found for: " + "; ".join(repr(m) for m in missed)
        return msg

    @register_tool
    async def list_files(self, subdir: str = ".") -> str:
        """List files under the workspace (or a subdirectory of it).

        Args:
            subdir: Directory relative to the workspace root.
        """
        base = (self.work_dir / subdir).resolve()
        if not base.is_relative_to(self.work_dir):
            raise ValueError(f"subdir {subdir!r} escapes the workspace")
        if not base.exists():
            return f"(empty — {base} does not exist)"
        entries = sorted(
            str(q.relative_to(self.work_dir)) + ("/" if q.is_dir() else "")
            for q in base.iterdir()
        )
        return "\n".join(entries) or "(empty)"
