"""In-process span tracing with pluggable processors.

A copy of ``youtu_rag_tpu/tracing/tracer.py`` without its DB and OTLP
sinks, which belong to slices not ported yet. The retriever opens an
``embedding`` span around query embedding and a ``retrieval`` span around
the device search; each span records its duration and attributes."""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Protocol

from ..utils.log import get_logger

logger = get_logger("tracing")

_current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "yrt_trace_id", default=None
)
_current_span: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "yrt_span_id", default=None
)


@dataclass
class Span:
    trace_id: str
    span_id: str
    kind: str  # agent | tool | generation | retrieval | custom
    name: str
    start_time: float
    end_time: float | None = None
    attributes: dict[str, Any] = field(default_factory=dict)
    error: str | None = None
    parent_span_id: str | None = None  # nesting (agent -> tool -> gen)

    @property
    def duration_ms(self) -> float:
        return ((self.end_time or time.time()) - self.start_time) * 1e3


class SpanProcessor(Protocol):
    def on_span_end(self, span: Span) -> None: ...


class Tracer:
    def __init__(self):
        self.processors: list[SpanProcessor] = []
        self.spans: list[Span] = []  # ring buffer of recent spans
        self.max_kept = 1000

    def add_processor(self, p: SpanProcessor) -> None:
        self.processors.append(p)

    @contextlib.contextmanager
    def span(self, kind: str, name: str, **attributes):
        trace_id = _current_trace.get() or f"tr-{uuid.uuid4().hex[:16]}"
        token = _current_trace.set(trace_id)
        s = Span(
            trace_id=trace_id,
            span_id=f"sp-{uuid.uuid4().hex[:12]}",
            kind=kind,
            name=name,
            start_time=time.time(),
            attributes=dict(attributes),
            parent_span_id=_current_span.get(),
        )
        span_token = _current_span.set(s.span_id)
        try:
            yield s
        except Exception as e:
            s.error = str(e)
            raise
        finally:
            s.end_time = time.time()
            _current_span.reset(span_token)
            _current_trace.reset(token)
            self.spans.append(s)
            if len(self.spans) > self.max_kept:
                del self.spans[: len(self.spans) - self.max_kept]
            for p in self.processors:
                try:
                    p.on_span_end(s)
                except Exception:  # noqa: BLE001
                    logger.exception("span processor failed")

    @contextlib.contextmanager
    def trace(self, trace_id: str | None = None):
        """Bind a trace id for all spans in this context."""
        token = _current_trace.set(trace_id or f"tr-{uuid.uuid4().hex[:16]}")
        try:
            yield _current_trace.get()
        finally:
            _current_trace.reset(token)


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL
