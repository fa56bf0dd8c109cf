"""The port's DTR Excel agent as a whole against the JAX package's, on the
CPU.

- The committed DTR fixture (``benchmarks/data/dtr/``): the first four
  questions of each kind in file order (chart has three: 23 questions)
  through the linear and ``autonomous`` planners of both packages
  (``mcts``: ``tests/test_torch_dtr_slice_mcts.py``), each with the same
  scripted analyst (JAX: the rule function of ``scripts/bench_dtr.py``;
  the port: its copy, ``youtu_rag_tpu_torch/bench/dtr.py``) and a memory
  toolkit for experience priming. Per question the final answer, the LLM calls,
  ``evaluate_plan``'s depth reward, the plans, the step code and the event
  sequence are equal; so is each planner's accuracy.
- ``ElementIndex`` (schema linking) vectors are bit-equal on the C hash
  path and on the Python one.
- ``get_agent`` serves ``type: excel`` with the port's ``ExcelAgent``, and
  its ``device`` behaves as in the port's other agent types.

Tolerance: none; every compared value is text, a count, a float as
computed or an array bit for bit. Chart answers name a temporary
directory of their own (``dtr_chart_*``), which the comparison masks."""

import asyncio
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import youtu_rag_tpu.integrations.dtr.schema_link as jax_schema_link
import youtu_rag_tpu_torch.integrations.dtr.schema_link as schema_link
from youtu_rag_tpu.agents.llm import FakeChatClient as JaxFake
from youtu_rag_tpu.integrations.dtr.excel_agent import ExcelAgent as JaxExcelAgent
from youtu_rag_tpu.integrations.dtr.loader import load_sheets as jax_load_sheets
from youtu_rag_tpu.integrations.dtr.reward import evaluate_plan as jax_evaluate_plan
from youtu_rag_tpu.memory.toolkit import VectorMemoryToolkit as JaxMemoryToolkit
from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.factory import get_agent
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.bench import dtr
from youtu_rag_tpu_torch.integrations.dtr.excel_agent import ExcelAgent
from youtu_rag_tpu_torch.integrations.dtr.loader import load_sheets
from youtu_rag_tpu_torch.memory.toolkit import VectorMemoryToolkit
from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401 - fixtures

# both packages' schema linking and memory run the C hash embedder
pytestmark = pytest.mark.usefixtures("jax_lib", "jax_tracer_restored")

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "benchmarks" / "data" / "dtr"
WORKBOOKS = {wb: str(DATA / wb) for wb in ("wb_sales", "wb_ops")}
CHAT_MODEL = REPO / "benchmarks" / "models" / "yrt_tiny_chat"


@pytest.fixture(scope="module")
def questions():
    return dtr.first_of_each_kind(json.loads((DATA / "questions.json").read_text()))


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("bench_dtr", REPO / "scripts" / "bench_dtr.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_fixture_selection(questions):
    kinds = [q["kind"] for q in questions]
    assert len(questions) == 23
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "lookup": 4, "aggregate": 4, "superlative": 4, "join": 4, "chart": 3, "hard": 4}


async def run_jax(jax_bench, q, planner, memory):
    state = {"question": q["question"]}
    client = JaxFake(rule_fn=jax_bench.make_rule_fn(jax_bench.ScriptedAnalyst(), state))
    agent = JaxExcelAgent(client=client, memory_toolkit=memory,
                          **{**dtr.AGENT_SETTINGS, "planner": planner})
    return await dtr.drive(agent, q, WORKBOOKS[q["workbook"]], jax_evaluate_plan)


# mcts, the longest, has a file of its own (test_torch_dtr_slice_mcts.py),
# so the suite's workers share the planners
@pytest.mark.parametrize("planner", ["linear", "autonomous"])
def test_fixture_questions_match_jax(planner, questions, jax_bench):
    async def both():
        mem = VectorMemoryToolkit({"user_id": "dtr", "device": "cpu"})
        jax_mem = JaxMemoryToolkit({"user_id": "dtr"})
        rows = []
        for q in questions:
            got = await dtr.run_question(q, WORKBOOKS[q["workbook"]], planner, device="cpu",
                                         memory_toolkit=mem)
            want = await run_jax(jax_bench, q, planner, jax_mem)
            rows.append((got, want))
        return rows

    rows = asyncio.run(both())
    for got, want in rows:
        assert dtr.twin_view(got) == dtr.twin_view(want), got["question"]
        assert got["answer"] and got["llm_calls"] > 0
    assert dtr.accuracy([g for g, _ in rows]) == dtr.accuracy([w for _, w in rows])
    # the benchmark's story: multi-hop questions need a planner that refines
    if planner != "linear":
        assert dtr.accuracy([g for g, _ in rows]) == 1.0
    # what chip_smoke.py's phase 4j (a) holds the card's run to
    for got, _ in rows:
        assert not got["answer"].startswith("error:"), got["question"]
        assert bool(got["hit"]) == dtr.expected_hit(planner, got["kind"]), got["question"]


@pytest.mark.parametrize("native", [True, False], ids=["c", "python"])
def test_element_index_bit_equal(native, monkeypatch):
    if not native:
        for mod in (schema_link, jax_schema_link):
            monkeypatch.setattr(mod, "HashEmbedder", functools.partial(mod.HashEmbedder,
                                                                       use_native=False))
    for wb in WORKBOOKS.values():
        got = schema_link.ElementIndex(load_sheets(wb))
        want = jax_schema_link.ElementIndex(jax_load_sheets(wb))
        assert got.elements == want.elements
        np.testing.assert_array_equal(got._idf, want._idf)
        np.testing.assert_array_equal(got._vecs, want._vecs)
        question = "Which country has the highest total hours_lost per unit of headcount?"
        assert got.link(question) == want.link(question)
        assert [(e, s) for e, s in got.search(question)] == want.search(question)


def test_get_agent_serves_excel():
    agent = get_agent({"type": "excel"}, client=FakeChatClient(), trajectory_sink=None)
    assert isinstance(agent, ExcelAgent) and agent.device is None


def local_config():
    return AgentConfig.from_dict({"type": "excel", "model": {
        "provider": "local", "weights_dir": str(CHAT_MODEL), "max_tokens": 8}})


def test_excel_device_defaults_to_cuda(monkeypatch):
    """``device=None`` is the card: on a host without CUDA a local model
    or a memory toolkit made for the agent raises, as for the port's other
    agent types; ``device="cpu"`` runs the question to an end."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_agent(local_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExcelAgent(local_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExcelAgent(client=FakeChatClient(), memory_toolkit=VectorMemoryToolkit({"user_id": "x"}))
    agent = get_agent(local_config(), device="cpu")
    assert agent.device == "cpu"
    rec = asyncio.run(agent.run("What is the total revenue in region 'north'?",
                                WORKBOOKS["wb_sales"]))
    assert rec.final_output and agent.llm_calls > 0
