"""The port's chat routes: file_ids injection and spreadsheet routing
(ref: ChatService.modify_query, chat_service.py:486-623), the cases of
``tests/api/test_chat_files.py``.

The deep-table-reasoning Excel agent is not ported yet (``get_agent``
raises for ``excel``), so the spreadsheet route is held with a stand-in
agent of the same surface (``load_schema`` and ``run(query, table_path)``)."""

import json
import tempfile

from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
import pytest


def _state():
    rag = RAGConfig(vector_store=VectorStoreConfig(index=IndexConfig(min_capacity=256, block_rows=128)))
    return ApiState(device="cpu", data_dir=tempfile.mkdtemp(prefix="yrt-chatf-"), rag_config=rag)


class ChatFileTest(AsyncHTTPTestCase):
    def get_app(self):
        self.state = _state()
        self.seen = {}

        def rule(messages, tools):
            self.seen["prompt"] = messages[-1].content
            return FakeChatClient.text_response("noted")

        self.state.agent = SimpleAgent(AgentConfig(), client=FakeChatClient(rule_fn=rule))
        return create_app(self.state)

    def test_text_file_inlined_into_query(self):
        self.state.files.upload("uploads", "notes.md", b"HBM runs at 820 GB/s")
        r = self.fetch("/api/chat", method="POST", body=json.dumps(
            {"query": "summarize the attachment", "file_ids": ["notes.md"], "stream": False}))
        assert r.code == 200
        assert "820 GB/s" in self.seen["prompt"]          # content inlined
        assert "[attached file:" in self.seen["prompt"]   # path visible to file tools

    def test_missing_file_400(self):
        r = self.fetch("/api/chat", method="POST", body=json.dumps(
            {"query": "q", "file_ids": ["nope.md"], "stream": False}))
        assert r.code == 400


class TableAgent:
    """The surface the chat routes use to route a spreadsheet to an
    Excel-capable agent."""

    def __init__(self):
        self.runs = []

    def load_schema(self, path):  # marks the agent Excel-capable
        raise AssertionError("the route passes the path to run()")

    async def run(self, query, table_path=None):
        import pandas as pd

        from youtu_rag_tpu_torch.agents.events import TaskRecorder

        self.runs.append((query, table_path))
        rec = TaskRecorder(query)
        rec.set_final_output(f"The total amount is {int(pd.read_csv(table_path)['amount'].sum())}.")
        return rec


class ChatExcelRouteTest(AsyncHTTPTestCase):
    def get_app(self):
        self.state = _state()
        self.state.agent = TableAgent()
        return create_app(self.state)

    def test_spreadsheet_routes_to_excel_agent(self):
        self.state.files.upload("uploads", "sales.csv", b"amount\n10\n20\n30\n")
        r = self.fetch("/api/chat", method="POST", body=json.dumps(
            {"query": "total amount?", "file_ids": ["sales.csv"], "stream": False}),
            request_timeout=60)
        assert r.code == 200
        assert "60" in json.loads(r.body)["answer"]
        (query, path), = self.state.agent.runs
        assert path == str(self.state.files.local_path("uploads", "sales.csv"))
        assert "[attached file:" in query and query.endswith("total amount?")


def test_factory_excel_agent_not_ported():
    from youtu_rag_tpu_torch.agents.factory import get_agent

    with pytest.raises(NotImplementedError, match="excel"):
        get_agent({"type": "excel"}, client=FakeChatClient(), trajectory_sink=None)
