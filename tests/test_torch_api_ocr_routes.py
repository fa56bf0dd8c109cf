"""The cases of ``tests/api/test_ocr_routes.py`` on the port (its ``ApiState`` on the CPU).

OCR result viewing/editing + layout overlay routes (VERDICT r1 #4;
ref: utu/rag/api/routes/minio_files.py:182-280, 1500-1811)."""

import asyncio
import base64
import json

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.ingest.ocr import RemoteOCRClient, process_ocr_to_store

import tempfile

from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


def _state(tmp_suffix="ocr"):
    rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
    state = ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix=f"yrt-api-{tmp_suffix}-"), rag_config=rag)
    state.agent = SimpleAgent(
        AgentConfig(),
        client=FakeChatClient(rule_fn=lambda m, t: FakeChatClient.text_response("agent answer")),
    )
    return state

PNG_1PX = base64.b64decode(
    "iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAYAAAAfFcSJAAAADUlEQVR42mP8z8BQDwAEhQGA"
    "hKmMIQAAAABJRU5ErkJggg=="
)


class FakeOCR(RemoteOCRClient):
    def __init__(self):
        super().__init__(base_url="http://fake-ocr")

    async def ocr(self, data: bytes, filename: str) -> dict:
        return {
            "pages": [
                {
                    "markdown": "page one text",
                    "structured": [{"bbox": [0, 0, 1, 1], "text": "page one text"}],
                    "layout_image": base64.b64encode(PNG_1PX).decode(),
                },
                {"markdown": "page two text"},
            ]
        }


class OcrRoutesTest(AsyncHTTPTestCase):
    def get_app(self):
        self.state = _state("ocr")
        return create_app(self.state)

    def _json(self, r):
        return json.loads(r.body)

    def _seed(self, name="scan.pdf"):
        self.state.files.upload("uploads", name, b"%PDF-1.4 fake")
        asyncio.get_event_loop().run_until_complete(
            process_ocr_to_store(self.state.files, "uploads", name, client=FakeOCR())
        )
        return name

    def test_view_multipage_ocr(self):
        name = self._seed()
        r = self.fetch(f"/api/files/{name}/ocr")
        assert r.code == 200
        d = self._json(r)
        assert d["is_multi_page"] and d["total_pages"] == 2
        assert d["pages"][0]["markdown_text"] == "page one text"
        assert d["pages"][0]["structured_data"][0]["text"] == "page one text"
        assert d["pages"][0]["layout_image_url"].endswith("/ocr/layout/1")
        assert d["pages"][1]["markdown_text"] == "page two text"
        assert "layout_image_url" not in d["pages"][1]
        assert "# Page 1" in d["markdown_text"] and "page two text" in d["markdown_text"]
        assert not d["pages"][0]["is_manual_edited"]

    def test_layout_image_served(self):
        name = self._seed()
        r = self.fetch(f"/api/files/{name}/ocr/layout/1")
        assert r.code == 200
        assert r.headers["Content-Type"] == "image/png"
        assert r.body == PNG_1PX
        assert self.fetch(f"/api/files/{name}/ocr/layout/2").code == 404

    def test_edit_save_and_rebuild_picks_up(self):
        name = self._seed()
        # edit page 2
        r = self.fetch(
            f"/api/files/{name}/ocr",
            method="PUT",
            body=json.dumps({"page_num": 2, "markdown_text": "CORRECTED page two"}),
        )
        assert r.code == 200
        d = self._json(self.fetch(f"/api/files/{name}/ocr"))
        assert d["pages"][1]["markdown_text"] == "CORRECTED page two"
        assert d["pages"][1]["is_manual_edited"]
        # combined file regenerated → loaders/build see the edit
        assert "CORRECTED page two" in d["markdown_text"]

        # rebuild picks up the edit through the changed derived content
        from pathlib import Path

        from youtu_rag_tpu_torch.ingest.agent import BuildRequest, KnowledgeBuilderAgent
        from youtu_rag_tpu_torch.ingest.processors import SourceTask
        from youtu_rag_tpu_torch.models.embedder import HashEmbedder
        from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
        from youtu_rag_tpu_torch.core.config import IndexConfig, VectorStoreConfig

        path = str(self.state.files.local_path("uploads", name))
        store = TorchVectorStore(
            VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)), device="cpu"
        )
        agent = KnowledgeBuilderAgent("ocr-kb", store, HashEmbedder(dim=64))
        task = SourceTask(name, "text", path=path)
        r1 = asyncio.get_event_loop().run_until_complete(agent.build(BuildRequest(tasks=[task])))
        assert r1.processed == 1
        # unchanged → skip
        r2 = asyncio.get_event_loop().run_until_complete(agent.build(BuildRequest(tasks=[task])))
        assert r2.skipped == 1
        # edit the OCR again through the API; original bytes unchanged,
        # only the derived file moves → derived_files_changed
        self.fetch(
            f"/api/files/{name}/ocr",
            method="PUT",
            body=json.dumps({"page_num": 1, "markdown_text": "page one v2"}),
        )
        r3 = asyncio.get_event_loop().run_until_complete(agent.build(BuildRequest(tasks=[task])))
        assert r3.processed == 1 and r3.skipped == 0
        assert r3.analysis["plans"][0]["reason"] == "derived_files_changed"
        hits = asyncio.get_event_loop().run_until_complete(
            store.get_by_filter({"source": name}, limit=50)
        )
        assert any("page one v2" in c.content for c in hits)

    def test_singlepage_combined_only(self):
        # combined-only OCR (older derivation): still viewable/editable
        self.state.files.upload("uploads", "img.png", b"fakepng")
        self.state.files.upload("uploads", "img_ocr.md", b"single page md", {"kind": "ocr"})
        d = self._json(self.fetch("/api/files/img.png/ocr"))
        assert not d["is_multi_page"] and d["pages"][0]["markdown_text"] == "single page md"
        r = self.fetch(
            "/api/files/img.png/ocr",
            method="PUT",
            body=json.dumps({"markdown_text": "edited md"}),
        )
        assert r.code == 200
        d = self._json(self.fetch("/api/files/img.png/ocr"))
        assert d["markdown_text"] == "edited md" and d["pages"][0]["is_manual_edited"]

    def test_no_ocr_404(self):
        self.state.files.upload("uploads", "plain.txt", b"hello")
        assert self.fetch("/api/files/plain.txt/ocr").code == 404
