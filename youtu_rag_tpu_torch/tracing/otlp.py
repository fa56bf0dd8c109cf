"""Vendored OTLP/HTTP JSON exporter + OpenInference span mapping: a copy of
``youtu_rag_tpu/tracing/otlp.py``.

The reference exports agent-SDK spans to Arize Phoenix through the
opentelemetry packages (``utu/tracing/setup.py:30-91``) with OpenInference
semantic-convention attributes (``utu/tracing/otel_agents_processor.py:
72-660``). This module needs none of those packages: it speaks
the OTLP/HTTP JSON protocol directly (opentelemetry-proto
``trace_service.proto`` rendered as protobuf-JSON) — no otel dependency,
config-gated, degrades with a clear warning when the collector is
unreachable. Any OTLP collector (Phoenix, Jaeger, otel-collector) accepts
the payload at ``POST {endpoint}/v1/traces``.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any

from ..utils.log import get_logger
from .tracer import Span

logger = get_logger("tracing.otlp")

# OpenInference semantic conventions (subset the reference emits)
SPAN_KIND = "openinference.span.kind"
INPUT_VALUE = "input.value"
INPUT_MIME = "input.mime_type"
OUTPUT_VALUE = "output.value"
OUTPUT_MIME = "output.mime_type"
LLM_MODEL = "llm.model_name"
LLM_TOKENS_PROMPT = "llm.token_count.prompt"
LLM_TOKENS_COMPLETION = "llm.token_count.completion"
TOOL_NAME = "tool.name"
TOOL_PARAMETERS = "tool.parameters"
GRAPH_NODE_ID = "graph.node.id"
GRAPH_NODE_PARENT_ID = "graph.node.parent_id"
RETRIEVAL_DOCUMENTS = "retrieval.documents"

# our span kinds → OpenInference kinds (otel_agents_processor _get_span_kind)
_KIND_MAP = {
    "agent": "AGENT",
    "tool": "TOOL",
    "generation": "LLM",
    "retrieval": "RETRIEVER",
    "custom": "CHAIN",
}


def openinference_attributes(span: Span) -> dict[str, Any]:
    """Map a tracer Span onto OpenInference attribute keys."""
    attrs: dict[str, Any] = {SPAN_KIND: _KIND_MAP.get(span.kind, "CHAIN")}
    a = span.attributes
    if span.kind == "generation":
        if a.get("model"):
            attrs[LLM_MODEL] = str(a["model"])
        if "input_tokens" in a:
            attrs[LLM_TOKENS_PROMPT] = int(a["input_tokens"])
        if "output_tokens" in a:
            attrs[LLM_TOKENS_COMPLETION] = int(a["output_tokens"])
        if a.get("input_messages") is not None:
            attrs[INPUT_VALUE] = json.dumps(a["input_messages"], ensure_ascii=False, default=str)
            attrs[INPUT_MIME] = "application/json"
        if a.get("output") is not None:
            attrs[OUTPUT_VALUE] = str(a["output"])
    elif span.kind == "tool":
        attrs[TOOL_NAME] = span.name
        if a.get("arguments") is not None:
            attrs[TOOL_PARAMETERS] = json.dumps(a["arguments"], ensure_ascii=False, default=str)
            attrs[INPUT_VALUE] = attrs[TOOL_PARAMETERS]
        if a.get("output") is not None:
            attrs[OUTPUT_VALUE] = str(a["output"])
    elif span.kind == "agent":
        # Phoenix agent-graph node metadata (ref: GRAPH_NODE_ID on agent spans)
        attrs[GRAPH_NODE_ID] = span.name
        if a.get("parent_agent"):
            attrs[GRAPH_NODE_PARENT_ID] = str(a["parent_agent"])
        if a.get("input") is not None:
            attrs[INPUT_VALUE] = str(a["input"])
        if a.get("output") is not None:
            attrs[OUTPUT_VALUE] = str(a["output"])
    elif span.kind == "retrieval":
        if a.get("query") is not None:
            attrs[INPUT_VALUE] = str(a["query"])
        if a.get("documents") is not None:
            attrs[RETRIEVAL_DOCUMENTS] = json.dumps(a["documents"], ensure_ascii=False, default=str)
    # pass through remaining simple attributes under a metadata prefix
    for k, v in a.items():
        if k in ("model", "input_tokens", "output_tokens", "input_messages", "output",
                 "arguments", "input", "query", "documents", "parent_agent"):
            continue
        if isinstance(v, (str, int, float, bool)):
            attrs[f"metadata.{k}"] = v
    return attrs


def _hex_id(raw: str, nbytes: int) -> str:
    """Stable OTLP id (16-byte trace / 8-byte span) from our string ids."""
    return hashlib.sha1(raw.encode()).hexdigest()[: nbytes * 2]


def _otlp_value(v: Any) -> dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # protobuf-JSON renders int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def span_to_otlp(span: Span) -> dict[str, Any]:
    """One tracer Span → OTLP JSON span object."""
    attrs = openinference_attributes(span)
    out = {
        "traceId": _hex_id(span.trace_id, 16),
        "spanId": _hex_id(span.span_id, 8),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start_time * 1e9)),
        "endTimeUnixNano": str(int((span.end_time or span.start_time) * 1e9)),
        "attributes": [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()],
        "status": {"code": 2, "message": span.error} if span.error else {"code": 1},
    }
    # nesting: without parentSpanId every span renders as a root and the
    # agent → tool → generation hierarchy is lost in Phoenix/Jaeger
    if getattr(span, "parent_span_id", None):
        out["parentSpanId"] = _hex_id(span.parent_span_id, 8)
    return out


class OTLPJsonExporter:
    """Serializes spans to an OTLP/HTTP JSON request body and POSTs it."""

    def __init__(
        self,
        endpoint: str,
        project_name: str = "youtu-rag-tpu",
        headers: dict[str, str] | None = None,
        timeout: float = 5.0,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.project_name = project_name
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self.timeout = timeout
        self._warned = False

    def to_payload(self, spans: list[Span]) -> dict[str, Any]:
        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            # Phoenix routes by this resource attribute
                            {"key": "openinference.project.name",
                             "value": {"stringValue": self.project_name}},
                            {"key": "service.name",
                             "value": {"stringValue": self.project_name}},
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "youtu_rag_tpu_torch.tracing"},
                            "spans": [span_to_otlp(s) for s in spans],
                        }
                    ],
                }
            ]
        }

    def export(self, spans: list[Span]) -> bool:
        if not spans:
            return True
        body = json.dumps(self.to_payload(spans)).encode()
        try:
            return self._post(f"{self.endpoint}/v1/traces", body)
        except Exception as e:  # noqa: BLE001 - tracing must never break the run
            if not self._warned:
                logger.warning("OTLP export to %s failed (%s); further failures silenced", self.endpoint, e)
                self._warned = True
            return False

    def _post(self, url: str, body: bytes) -> bool:
        import httpx

        resp = httpx.post(url, content=body, headers=self.headers, timeout=self.timeout)
        ok = resp.status_code // 100 == 2
        if not ok and not self._warned:
            # a live collector with a wrong path/auth must warn like an
            # unreachable one — silent drops are undiagnosable
            logger.warning(
                "OTLP collector %s answered HTTP %d; spans are being dropped "
                "(further failures silenced)", self.endpoint, resp.status_code,
            )
            self._warned = True
        return ok


class OTLPProcessor:
    """SpanProcessor that batches completed spans to an OTLP collector."""

    def __init__(self, endpoint: str, project_name: str = "youtu-rag-tpu",
                 headers: dict[str, str] | None = None, batch_size: int = 32):
        self.exporter = OTLPJsonExporter(endpoint, project_name, headers)
        self.batch_size = batch_size
        self._buf: list[Span] = []
        self._lock = threading.Lock()
        # short runs (< batch_size spans) previously exported NOTHING:
        # flush had no callers, so the trailing partial batch was lost
        import atexit

        atexit.register(self.flush)

    def on_span_end(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span)
            if len(self._buf) < self.batch_size:
                return
            batch, self._buf = self._buf, []
        self.exporter.export(batch)

    def flush(self) -> bool:
        with self._lock:
            batch, self._buf = self._buf, []
        return self.exporter.export(batch)
