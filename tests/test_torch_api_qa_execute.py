"""The cases of ``tests/api/test_qa_execute.py`` on the port (its ``ApiState`` on the CPU).

QA execute with agent selection (VERDICT r2 item 6; ref
utu/rag/api/routes/knowledge_base.py:759-818): a stored QA pair routes to
an LLM-selected agent, executes, and persists the executed answer."""

import json
import tempfile

import pytest
from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


def _rule(messages, tools):
    content = messages[-1].content or ""
    if content.startswith("Select the best agent"):
        return FakeChatClient.text_response('I pick ["kb_search"] for this.')
    return FakeChatClient.text_response("Executed answer: the capital is Paris.")


class QAExecuteTest(AsyncHTTPTestCase):
    def get_app(self):
        import tempfile

        rag = RAGConfig(
            vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128))
        )
        self.state = ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-qa-"), rag_config=rag)
        self.state.agent = SimpleAgent(AgentConfig(), client=FakeChatClient(rule_fn=_rule))
        return create_app(self.state)

    def _json(self, r):
        return json.loads(r.body)

    def _setup_kb_with_qa(self):
        r = self.fetch(
            "/api/knowledge-bases", method="POST", body=json.dumps({"name": "qkb"})
        )
        assert r.code in (200, 201)
        r = self.fetch(
            "/api/knowledge-bases/qkb/qa-pairs",
            method="POST",
            body=json.dumps(
                {
                    "pairs": [
                        {"question": "What is the capital of France?", "answer": "Paris"},
                        {"question": "What is 2+2?", "answer": "4"},
                    ]
                }
            ),
        )
        assert r.code == 201
        pairs = self._json(self.fetch("/api/knowledge-bases/qkb/qa-pairs"))["qa_pairs"]
        assert len(pairs) == 2
        return pairs

    def test_execute_selects_agent_and_persists(self):
        pairs = self._setup_kb_with_qa()
        r = self.fetch(
            "/api/knowledge-bases/qkb/qa/execute",
            method="POST",
            body=json.dumps({"id": pairs[0]["id"]}),
        )
        assert r.code == 200, r.body
        data = self._json(r)
        assert data["selected_agents"] == ["kb_search"]
        assert data["final_status"] == "completed"
        assert data["execution_results"][0]["success"]
        assert "Paris" in data["execution_results"][0]["answer"]

        # persisted on the chunk: visible from the chunk browser
        chunks = self._json(
            self.fetch("/api/knowledge-bases/qkb/chunks?index_type=")
        )["chunks"]
        meta = next(c for c in chunks if c["id"] == pairs[0]["id"])["metadata"]
        assert meta["learning_status"] == "completed"
        assert meta["executed_agents"] == "kb_search"
        assert "Paris" in meta["executed_results"]

    def test_batch_execute(self):
        pairs = self._setup_kb_with_qa()
        r = self.fetch(
            "/api/knowledge-bases/qkb/qa/batch-execute",
            method="POST",
            body=json.dumps({"ids": [p["id"] for p in pairs] + ["missing-id"]}),
        )
        assert r.code == 200
        data = self._json(r)
        assert data["total"] == 3
        assert data["success"] == 2 and data["failed"] == 1
        bad = [x for x in data["results"] if not x["success"]]
        assert bad[0]["qa_id"] == "missing-id"

    def test_execute_missing_pair_404(self):
        self._setup_kb_with_qa()
        r = self.fetch(
            "/api/knowledge-bases/qkb/qa/execute",
            method="POST",
            body=json.dumps({"id": "nope"}),
        )
        assert r.code == 404

    def test_execute_unknown_kb_404(self):
        r = self.fetch(
            "/api/knowledge-bases/ghost/qa/execute",
            method="POST",
            body=json.dumps({"id": "x"}),
        )
        assert r.code == 404


def test_catalog_agents_are_built_on_the_state_device(monkeypatch):
    """QA execute and auto-select chat build each selected catalog agent
    whose type differs from the live one; the port builds it on the
    state's device."""
    import asyncio

    from torch_api_helpers import Served

    from youtu_rag_tpu_torch.agents import factory
    from youtu_rag_tpu_torch.agents.events import TaskRecorder

    built = []

    class Runner:
        def run_streamed(self, query):
            rec = TaskRecorder(query)
            rec.set_final_output("planned answer")
            rec.finish()
            return rec

        async def run(self, query):
            return self.run_streamed(query)

    def fake_get_agent(cfg, **kwargs):
        built.append((cfg.type, kwargs.get("device")))
        return Runner()

    monkeypatch.setattr(factory, "get_agent", fake_get_agent)

    def rule(messages, tools):
        return FakeChatClient.text_response('["orchestra"]')

    rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
    state = ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-qa-dev-"), rag_config=rag)
    state.agent = SimpleAgent(AgentConfig(), client=FakeChatClient(rule_fn=rule), device="cpu")

    async def go():
        app = Served(create_app(state))
        try:
            kb = "/api/knowledge-bases/devkb"
            await app.fetch(f"{kb}/qa-pairs", "POST",
                            {"pairs": [{"question": "What is 2+2?", "answer": "4"}]})
            pairs = json.loads((await app.fetch(f"{kb}/qa-pairs")).body)["qa_pairs"]
            executed = json.loads((await app.fetch(f"{kb}/qa/execute", "POST",
                                                   {"id": pairs[0]["id"]})).body)
            chat = (await app.fetch("/api/chat", "POST", {"query": "q", "auto_select": True})).body
            return executed, chat
        finally:
            await app.close()

    executed, chat = asyncio.run(go())
    assert executed["selected_agents"] == ["orchestra"] and executed["final_status"] == "completed"
    assert b"planned answer" in chat
    assert built == [("orchestra", state.device)] * 2
