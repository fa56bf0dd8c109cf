"""The port's chat routes: file_ids injection and spreadsheet routing
(ref: ChatService.modify_query, chat_service.py:486-623), the cases of
``tests/api/test_chat_files.py``.

The spreadsheet route is held twice: with a stand-in agent of the Excel
agent's surface (``load_schema`` and ``run(query, table_path)``), and
with the real ``ExcelAgent`` and a scripted model on both packages' apps,
whose answers and SSE cards (the default and the auto-select stream) are
equal, trace ids and data-dir paths aside."""

import asyncio
import json
import tempfile

from tornado.testing import AsyncHTTPTestCase

from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.api.app import create_app
from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig
from youtu_rag_tpu_torch.integrations.dtr.excel_agent import ExcelAgent
import pytest

from torch_api_helpers import Served, make_state, package, sse_cards
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture
from youtu_rag_tpu.integrations.dtr.excel_agent import ExcelAgent as JaxExcelAgent

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")


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


def excel_rule(F):
    """A scripted analyst for the route: a one-step plan, its pandas, a
    verdict and an answer."""

    def rule(messages, tools):
        content = messages[-1].content or ""
        if content.startswith("You are a data analyst planning"):
            return F.text_response('["total the amount column"]')
        if content.startswith("Write pandas code"):
            return F.text_response("print(dfs['Sheet1']['amount'].sum())")
        if content.startswith("Did this step execution succeed"):
            return F.text_response('{"success": true, "reason": ""}')
        if content.startswith("Answer the question"):
            return F.text_response("The total amount is 60.")
        return F.text_response("?")

    return rule


def excel_route(name: str) -> list:
    """The spreadsheet route of ``name``'s app with the real Excel agent:
    the plain answer, the SSE cards and the auto-select stream's cards."""

    async def go():
        pkg = package(name)
        state = make_state(pkg, "yrt-chatx")
        excel = ExcelAgent if name == "port" else JaxExcelAgent
        state.agent = excel(client=pkg.FakeChatClient(rule_fn=excel_rule(pkg.FakeChatClient)))
        state.files.upload("uploads", "sales.csv", b"amount\n10\n20\n30\n")
        app = Served(pkg.app.create_app(state))
        out = []
        try:
            for body in ({"query": "total amount?", "file_ids": ["sales.csv"], "stream": False},
                         {"query": "total amount?", "file_ids": ["sales.csv"]},
                         {"query": "total amount?", "file_ids": ["sales.csv"],
                          "auto_select": True}):
                r = await app.fetch("/api/chat", "POST", body)
                text = r.body.decode().replace(str(state.data_dir), "<data>")
                payload = sse_cards(text.encode()) if "stream" not in body else json.loads(text)
                for card in payload if isinstance(payload, list) else [payload]:
                    card.pop("trace_id", None)
                out.append((r.code, payload))
        finally:
            await app.close()
        return out

    return asyncio.run(go())


def test_spreadsheet_route_real_excel_agent_matches_jax():
    got, want = excel_route("port"), excel_route("jax")
    assert got == want
    (code, answer), (_, cards), (_, auto) = got
    assert code == 200 and "60" in answer["answer"]
    assert [c["type"] for c in cards][-2:] == ["final", "done"] and "60" in cards[-2]["content"]
    assert any(c["type"] == "tool_call" and "amount" in c["arguments"] for c in cards)
    assert auto[0]["type"] == "agent_switch" and auto[-1]["auto_selected"] == ["excel"]
