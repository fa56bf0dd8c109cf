"""The cases of ``tests/api/test_spa.py`` that reach the port's app (its
``ApiState`` on the CPU): static assets serve, every API path the JS
calls matches a route of the port's app, the catalog ships the KB gate,
and the create modal's fields land in the KB. The port's static files
equal the JAX package's byte for byte (``test_torch_api_entry.py``), so
the cases that read only those files stay with the JAX package."""

import json
import re
from pathlib import Path

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")

STATIC = Path(__file__).parents[1] / "youtu_rag_tpu_torch" / "api" / "static"
JS_FILES = sorted(STATIC.rglob("*.js"))


def _routes():
    import tempfile

    rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
    app = create_app(ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-spa-"), rag_config=rag))
    pats = []
    for rule in app.default_router.rules[0].target.rules:
        pats.append(rule.matcher.regex.pattern)
    return pats


def test_js_api_paths_match_routes():
    """Every fetch/api() URL literal in the SPA resolves to a real route —
    catches frontend/backend drift."""
    pats = _routes()
    called = set()
    for f in JS_FILES:
        text = f.read_text()
        for m in re.findall(r"""[`"'](/(?:api|health|static|ws)[^`"']*)[`"']""", text):
            # template params → a concrete placeholder; strip query strings
            url = re.sub(r"\$\{[^}]*\}", "X", m).split("?")[0]
            called.add(url)
    assert called, "no API calls found in the SPA?"
    misses = []
    for url in sorted(called):
        if not any(re.fullmatch(p.rstrip("$"), url) for p in pats):
            misses.append(url)
    assert not misses, f"SPA calls unrouted paths: {misses}"


class SpaServeTest(AsyncHTTPTestCase):
    def get_app(self):
        import tempfile

        rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
        self.state = ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-spa2-"), rag_config=rag)
        return create_app(self.state)

    def test_index_and_assets_serve(self):
        r = self.fetch("/")
        assert r.code == 200 and b"/static/app.js" in r.body and b"/static/style.css" in r.body
        for path in ("/static/app.js", "/static/style.css",
                     "/static/views/chat.js", "/static/views/kb.js",
                     "/static/views/files.js", "/static/views/monitor.js"):
            rr = self.fetch(path)
            assert rr.code == 200 and len(rr.body) > 500, path

    def test_metadata_csv_roundtrip_shape(self):
        # the Metadata tab's export link returns CSV with the header row
        self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({"name": "spa"}))
        self.fetch("/api/knowledge-bases/spa/build",
                   method="POST", body=json.dumps({"documents": [{"id": "d", "content": "hello spa"}]}))
        r = self.fetch("/api/knowledge-bases/spa/metadata")
        assert r.code == 200 and r.body.startswith(b"chunk_id,document_id")


def test_agent_kb_gate_contract():
    """Agents whose catalog entry declares requires_kb gate the send button
    until a KB is picked (ref chat.js AGENT_KB_REQUIREMENTS:11-72), and the
    catalog route actually ships the flag."""
    from youtu_rag_tpu_torch.api.app import agent_catalog

    cat = {a["name"]: a for a in agent_catalog()}
    assert cat["kb_search"]["requires_kb"] is True
    assert cat["text2sql"]["requires_kb"] is True
    chat = (STATIC / "views" / "chat.js").read_text()
    assert "requires_kb" in chat and "updateSendGate" in chat
    # IME guard: Enter mid-composition must not submit
    assert "compositionstart" in chat and "isComposing" in chat


class KbCreateOptionsTest(AsyncHTTPTestCase):
    """The create modal's fields land in the KB: description (top-level
    sugar) and storage tier (config override) round-trip through stats."""

    def get_app(self):
        import tempfile

        rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
        self.state = ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-spa3-"), rag_config=rag)
        return create_app(self.state)

    def test_description_and_tier_roundtrip(self):
        r = self.fetch("/api/knowledge-bases", method="POST", body=json.dumps({
            "name": "opts", "description": "contract corpus",
            "config": {"vector_store": {"index": {
                "storage_dtype": "int8", "min_capacity": 256, "block_rows": 128}}},
        }))
        assert r.code == 201, r.body
        out = json.loads(self.fetch("/api/knowledge-bases/opts").body)
        assert out["description"] == "contract corpus"
        assert out["storage_dtype"] == "int8"
