"""Remaining builtin toolkits: tabular, user interaction, codesnip,
simple file-backed memory, and gated audio/video/image adapters.

Parity surface with ``utu/tools`` registry entries the other modules don't
cover (``utu/tools/__init__.py:25-46``): tabular (pandas inspection),
user_interaction (ask-the-human tool), codesnip (snippet execution),
memory_simple (file-backed notes, ``memory_toolkit.py:58-167``), and
image/audio/video QA which delegate to multimodal model endpoints exactly
like the reference (clean config errors when absent).

The port's copy of ``youtu_rag_tpu/tools/misc.py``.
"""

from __future__ import annotations

import asyncio
import json
import os
from pathlib import Path

from ..utils.log import get_logger
from . import register_toolkit
from .base import AsyncBaseToolkit, register_tool

logger = get_logger("tools.misc")


@register_toolkit("tabular")
class TabularToolkit(AsyncBaseToolkit):
    """Inspect tabular files with pandas (ref: tabular toolkit)."""

    @register_tool
    async def tabular_overview(self, path: str) -> str:
        """Describe a CSV/Excel file: shape, columns, dtypes, head.

        Args:
            path: Path to the tabular file.
        """
        import pandas as pd

        try:
            sheets = (
                {"Sheet1": pd.read_csv(path)}
                if path.endswith(".csv")
                else pd.read_excel(path, sheet_name=None)
            )
        except Exception as e:  # noqa: BLE001
            return f"Error reading {path}: {e}"
        parts = []
        for name, df in sheets.items():
            parts.append(
                f"sheet {name}: {df.shape[0]} rows x {df.shape[1]} cols\n"
                f"dtypes: {dict(df.dtypes.astype(str))}\n"
                f"head:\n{df.head(5).to_markdown(index=False)}"
            )
        return "\n\n".join(parts)

    @register_tool
    async def tabular_column_stats(self, path: str, column: str) -> str:
        """Summary statistics for one column of a tabular file.

        Args:
            path: Path to the tabular file.
            column: Column name.
        """
        import pandas as pd

        try:
            df = pd.read_csv(path) if path.endswith(".csv") else pd.read_excel(path)
        except Exception as e:  # noqa: BLE001
            return f"Error reading {path}: {e}"
        if column not in df.columns:
            return f"Error: column {column!r} not in {list(df.columns)}"
        s = df[column]
        if s.dtype.kind in "ifu":
            return json.dumps(
                {
                    "count": int(s.count()),
                    "mean": float(s.mean()),
                    "std": float(s.std() or 0),
                    "min": float(s.min()),
                    "max": float(s.max()),
                }
            )
        return json.dumps({"count": int(s.count()), "top_values": s.value_counts().head(10).to_dict()}, ensure_ascii=False, default=str)


@register_toolkit("user_interaction")
class UserInteractionToolkit(AsyncBaseToolkit):
    """Ask the human a question (ref: user_interaction toolkit).
    config: ask_fn — async/sync callable(str) -> str; defaults to stdin."""

    @register_tool
    async def ask_user(self, question: str) -> str:
        """Ask the human user a clarifying question and return their answer.

        Args:
            question: The question to present to the user.
        """
        ask_fn = self.config.config.get("ask_fn")
        if ask_fn is not None:
            out = ask_fn(question)
            if asyncio.iscoroutine(out):
                out = await out
            return str(out)
        return await asyncio.to_thread(input, f"\n[agent asks] {question}\n> ")


@register_toolkit("codesnip")
class CodesnipToolkit(AsyncBaseToolkit):
    """Run short python snippets inline (ref: codesnip toolkit)."""

    @register_tool
    async def run_snippet(self, code: str, timeout: float = 10.0) -> str:
        """Execute a short Python snippet and return printed output.

        Args:
            code: Python source to run.
            timeout: Seconds before the snippet is killed.
        """
        proc = await asyncio.create_subprocess_exec(
            "python",
            "-c",
            code,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
        )
        try:
            out, _ = await asyncio.wait_for(proc.communicate(), timeout=timeout)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()  # reap: kill() alone leaves a zombie when the loop closes
            return "Error: snippet timed out"
        return out.decode(errors="replace").strip() or "(no output)"


@register_toolkit("memory_simple")
class SimpleMemoryToolkit(AsyncBaseToolkit):
    """File-backed note memory (ref: SimpleMemoryToolkit,
    memory_toolkit.py:58-167)."""

    def __init__(self, config=None):
        super().__init__(config)
        import tempfile

        self.path = Path(
            self.config.config.get("path") or Path(tempfile.gettempdir()) / "yrt_simple_memory.jsonl"
        )

    @register_tool
    async def remember(self, note: str) -> str:
        """Append a note to persistent memory.

        Args:
            note: The note text to store.
        """
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"note": note}, ensure_ascii=False) + "\n")
        return "noted."

    @register_tool
    async def recall(self, keyword: str = "", limit: int = 10) -> str:
        """Recall stored notes, optionally filtered by keyword.

        Args:
            keyword: Substring filter; empty returns the most recent notes.
            limit: Maximum notes to return.
        """
        if not self.path.exists():
            return "(no notes)"
        notes = [json.loads(l)["note"] for l in self.path.read_text().strip().split("\n") if l]
        if keyword:
            notes = [n for n in notes if keyword.lower() in n.lower()]
        return "\n".join(f"- {n}" for n in notes[-limit:]) or "(no matching notes)"


def _media_qa(kind: str, env_key: str):
    async def qa(self, path: str, question: str) -> str:
        url = self.config.config.get("base_url") or os.environ.get(env_key)
        if not url:
            return (
                f"Error: {kind} understanding needs a multimodal model endpoint "
                f"(set {env_key})."
            )
        import base64

        import httpx

        data = base64.b64encode(Path(path).read_bytes()).decode()
        async with httpx.AsyncClient(timeout=120.0) as client:
            r = await client.post(url, json={"kind": kind, "data": data, "question": question})
            r.raise_for_status()
            return r.json().get("answer", r.text)

    return qa


@register_toolkit("image")
class ImageToolkit(AsyncBaseToolkit):
    """Image QA via a vision endpoint (ref: image_toolkit.py:89)."""

    @register_tool
    async def image_qa(self, path: str, question: str) -> str:
        """Answer a question about an image using the vision model endpoint.

        Args:
            path: Path to the image file.
            question: The question about the image.
        """
        return await _media_qa("image", "YRT_VISION_URL")(self, path, question)


@register_toolkit("audio")
class AudioToolkit(AsyncBaseToolkit):
    """Audio QA/transcription via an audio endpoint (ref: audio toolkit)."""

    @register_tool
    async def audio_qa(self, path: str, question: str) -> str:
        """Answer a question about an audio file using the audio endpoint.

        Args:
            path: Path to the audio file.
            question: The question about the audio.
        """
        return await _media_qa("audio", "YRT_AUDIO_URL")(self, path, question)


@register_toolkit("video")
class VideoToolkit(AsyncBaseToolkit):
    """Video QA via a video endpoint (ref: video toolkit)."""

    @register_tool
    async def video_qa(self, path: str, question: str) -> str:
        """Answer a question about a video file using the video endpoint.

        Args:
            path: Path to the video file.
            question: The question about the video.
        """
        return await _media_qa("video", "YRT_VIDEO_URL")(self, path, question)
