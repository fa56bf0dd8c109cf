"""The port's agent layer (``youtu_rag_tpu_torch/agents``, ``tools``) and the
CLI's agentic mode, against the JAX package's on the CPU.

- ``SimpleAgent`` + ``KBSearchToolkit`` over the port's KB and over the JAX
  package's KB on the same corpus, each driven by the same scripted
  ``FakeChatClient`` turns (native tool calls, and text through
  ``ReactChatClient``): the tool calls, the observations and the final text
  are equal, and so is every message the scripted model was shown;
- the KB toolkit's other tools (hybrid search, rerank, file search) answer
  as JAX's;
- the JAX package's ``tests/agents/test_simple_agent.py`` and
  ``test_react.py`` loop cases on the port; the registry builds the
  environments and the orchestrator agent types, and the part not ported
  yet (the excel agent) refuses clearly;
- ``python -m youtu_rag_tpu_torch.cli_chat --llm-weights-dir
  benchmarks/models/yrt_tiny_chat --device cpu``: the agentic loop calls
  ``kb_embedding_search`` and prints the same transcript as the same loop
  on the JAX package (``scripts/cli_chat.py``'s agent: its KB, its
  ``LocalChatClient``, the same instructions).

Tolerance: none; scores print with three decimals on both sides (the hash
embedder's Python path agrees bit for bit, tests/test_torch_kb.py)."""

import asyncio
import io
import json

import pytest
import torch

from youtu_rag_tpu.agents.config import AgentConfig as JaxAgentConfig
from youtu_rag_tpu.agents.llm import FakeChatClient as JaxFake
from youtu_rag_tpu.agents.react import ReactChatClient as JaxReact
from youtu_rag_tpu.agents.simple_agent import SimpleAgent as JaxAgent
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu.tools.base import ToolkitConfig as JaxToolkitConfig
from youtu_rag_tpu.tools.kb_search import KBSearchToolkit as JaxKBSearch
from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import (
    BaseChatClient,
    ChatMessage,
    ChatResponse,
    FakeChatClient,
    StreamDelta,
    ToolCall,
)
from youtu_rag_tpu_torch.agents.react import ReactChatClient, parse_react, render_tools
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.core.config import RAGConfig
from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
from youtu_rag_tpu_torch.tools import get_toolkit
from youtu_rag_tpu_torch.tools.base import AsyncBaseToolkit, ToolkitConfig, register_tool
from youtu_rag_tpu_torch.tools.kb_search import KBSearchToolkit

INSTRUCTIONS = ("You are a helpful assistant. Use the kb_embedding_search tool to look up "
                "facts from the knowledge base before answering.")
# fact documents in the chat model's training format (models/lm_synth.py)
FACTS = {
    "facts_01.md": "The color of Zoka is teal. Zoka has a mass of 230 kg.",
    "facts_02.md": "For Bifu, the status is active. The code of Bifu is KT-4410.",
    "facts_03.md": "Lemo has a owner of Dasi. The price of Lemo is 45 credits.",
    "facts_04.md": "The voltage of Rupa-7 is 12 volts. Rupa-7 has a rank of third.",
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("facts")
    for name, text in FACTS.items():
        (root / name).write_text(text)
    return root


@pytest.fixture(scope="module")
def kbs(corpus):
    files = sorted(str(p) for p in corpus.iterdir())
    port = KnowledgeBase("facts", RAGConfig(name="facts"), device="cpu")
    jax_kb = JaxKB("facts", JaxRAGConfig(name="facts"))
    port.embedder._use_native = jax_kb.embedder._use_native = False  # the Python hash path
    asyncio.run(port.build_files(files))
    asyncio.run(jax_kb.build_files(files))
    return port, jax_kb


def scripted(fake_cls, react: bool):
    """Two turns: a kb_embedding_search call, then an answer (native tool
    calls, or ReAct text for ReactChatClient)."""
    query = {"query": "What is the color of Zoka?", "top_k": 2}
    if react:
        return [fake_cls.text_response("Thought: look it up\nAction: kb_embedding_search\n"
                                       f"Action Input: {json.dumps(query)}"),
                fake_cls.text_response("Thought: found\nFinal Answer: teal")]
    return [fake_cls.tool_response("kb_embedding_search", query), fake_cls.text_response("teal")]


def run_agent(agent_cls, cfg_cls, fake_cls, react_cls, toolkit, react):
    inner = fake_cls(scripted=scripted(fake_cls, react))
    cfg = cfg_cls()
    cfg.agent.instructions = INSTRUCTIONS
    agent = agent_cls(cfg, client=react_cls(inner) if react else inner, toolkits=[toolkit])
    rec = asyncio.run(agent.run("What is the color of Zoka?"))
    shown = [[(m.role, m.content) for m in call["messages"]] for call in inner.calls]
    return rec, shown


@pytest.mark.parametrize("react", [False, True], ids=["tool_calls", "react"])
def test_agent_transcript_matches_jax(kbs, react):
    port_kb, jax_kb = kbs
    rec, shown = run_agent(SimpleAgent, AgentConfig, FakeChatClient, ReactChatClient,
                           KBSearchToolkit(ToolkitConfig(config={"kb": port_kb})), react)
    jrec, jshown = run_agent(JaxAgent, JaxAgentConfig, JaxFake, JaxReact,
                             JaxKBSearch(JaxToolkitConfig(config={"kb": jax_kb})), react)
    assert [(t.name, t.arguments, t.output) for t in rec.tool_calls] == \
        [(t.name, t.arguments, t.output) for t in jrec.tool_calls]
    assert rec.tool_calls[0].name == "kb_embedding_search"
    assert "The color of Zoka is teal." in rec.tool_calls[0].output
    assert rec.final_output == jrec.final_output == "teal"
    assert rec.trajectory == jrec.trajectory
    assert shown == jshown


@pytest.mark.parametrize("tool, args", [
    ("kb_hybrid_search", {"query": "Bifu status", "top_k": 3}),
    ("kb_embedding_search", {"query": "Rupa-7 voltage", "top_k": 2,
                             "filters": '{"source": "facts_04.md"}'}),
    ("kb_embedding_search", {"query": "x", "filters": "{not json"}),
    ("kb_rerank", {"query": "teal color", "candidates": ["a teal car", "a red car"], "top_k": 1}),
    ("kb_file_search", {"query": "Lemo price", "top_k": 2}),
])
def test_kb_tools_answer_as_jax(kbs, tool, args):
    port_kb, jax_kb = kbs
    got = asyncio.run(KBSearchToolkit(ToolkitConfig(config={"kb": port_kb})).call_tool(tool, args))
    want = asyncio.run(JaxKBSearch(JaxToolkitConfig(config={"kb": jax_kb})).call_tool(tool, args))
    assert got == want


def test_toolkit_schemas_match_jax(kbs):
    port_kb, jax_kb = kbs
    got = KBSearchToolkit(ToolkitConfig(config={"kb": port_kb})).get_tools_in_openai()
    want = JaxKBSearch(JaxToolkitConfig(config={"kb": jax_kb})).get_tools_in_openai()
    assert got == want
    from youtu_rag_tpu.agents.react import render_tools as jax_render_tools

    assert render_tools(got) == jax_render_tools(want)


def test_registry_and_unported_parts(kbs):
    """The registry builds the ported toolkits, agent environments and the
    orchestrator agent types; what is still not ported raises naming its
    integration: the excel agent (DTR)."""
    from youtu_rag_tpu_torch.agents.env import ShellLocalEnv
    from youtu_rag_tpu_torch.agents.factory import ORCHESTRATOR_TYPES, get_agent
    from youtu_rag_tpu_torch.agents.orchestra import OrchestraAgent
    from youtu_rag_tpu_torch.agents.orchestrator import (OrchestratorAgent,
                                                         ParallelOrchestratorAgent)
    from youtu_rag_tpu_torch.agents.workforce import WorkforceAgent
    from youtu_rag_tpu_torch.memory import VectorMemoryToolkit

    port_kb, _ = kbs
    tk = get_toolkit("kb_search", ToolkitConfig(name="kb_search", config={"kb": port_kb}))
    assert isinstance(tk, KBSearchToolkit)
    assert get_toolkit("bash").get_tools_in_openai()[0]["function"]["name"] == "run_bash"
    with pytest.raises(KeyError):
        get_toolkit("no_such_toolkit")
    cfg = AgentConfig()
    cfg.memory.enabled = True
    agent = asyncio.run(SimpleAgent(cfg, client=FakeChatClient(), device="cpu").build())
    assert isinstance(agent.memory_toolkit, VectorMemoryToolkit)
    assert agent.memory_toolkit.store.store.device.type == "cpu"
    cfg = AgentConfig.from_dict({"env": {"name": "shell_local"}})
    agent = asyncio.run(SimpleAgent(cfg, client=FakeChatClient()).build())
    assert isinstance(agent.env, ShellLocalEnv)
    assert any(schema["function"]["name"] == "run_bash" for schema in agent.router.schemas())
    asyncio.run(agent.cleanup())
    assert set(ORCHESTRATOR_TYPES) == {"orchestra", "orchestra_react_sql", "orchestrator",
                                       "parallel_orchestrator", "workforce"}
    built = {agent_type: type(get_agent({"type": agent_type}, client=FakeChatClient()))
             for agent_type in ORCHESTRATOR_TYPES}
    assert built == {"orchestra": OrchestraAgent, "orchestra_react_sql": OrchestraAgent,
                     "orchestrator": OrchestratorAgent,
                     "parallel_orchestrator": ParallelOrchestratorAgent,
                     "workforce": WorkforceAgent}
    with pytest.raises(NotImplementedError, match="integrations/dtr"):
        get_agent({"type": "excel"}, client=FakeChatClient())
    with pytest.raises(ValueError, match="unknown agent type"):
        get_agent(AgentConfig.model_construct(type="nope"), client=FakeChatClient())


# ---------------------------------------------------------------------------
# the JAX package's loop cases, on the port
# ---------------------------------------------------------------------------


class CalcToolkit(AsyncBaseToolkit):
    @register_tool
    async def add(self, a: int, b: int) -> str:
        """Add two numbers.

        Args:
            a: First number.
            b: Second number.
        """
        return str(a + b)


def test_tool_loop_and_stream_events():
    client = FakeChatClient(scripted=[FakeChatClient.tool_response("add", {"a": 2, "b": 40}),
                                      FakeChatClient.text_response("The sum is 42.")])
    agent = SimpleAgent(AgentConfig(), client=client, toolkits=[CalcToolkit()])

    async def collect():
        rec = agent.run_streamed("what is 2+40?")
        events = [e async for e in rec.stream_events()]
        return events, await rec.wait()

    events, rec = asyncio.run(collect())
    types = [e.type for e in events]
    assert "tool_call" in types and "tool_output" in types and types[-1] == "final"
    assert rec.final_output == "The sum is 42." and rec.tool_calls[0].output == "42"
    assert [m.content for m in client.calls[-1]["messages"] if m.role == "tool"] == ["42"]
    assert client.calls[0]["tools"][0]["function"]["name"] == "add"


def test_max_turns_history_and_errors():
    client = FakeChatClient(rule_fn=lambda m, t: FakeChatClient.tool_response("add", {"a": 1,
                                                                                     "b": 1}))
    rec = asyncio.run(SimpleAgent(AgentConfig(max_turns=3), client=client,
                                  toolkits=[CalcToolkit()]).run("loop forever"))
    assert "max turns" in rec.final_output and len(rec.tool_calls) == 3

    client = FakeChatClient(scripted=[FakeChatClient.text_response("first"),
                                      FakeChatClient.text_response("second")])
    agent = SimpleAgent(AgentConfig(), client=client)
    asyncio.run(agent.chat("hello"))
    asyncio.run(agent.chat("again"))
    assert [m.content for m in client.calls[-1]["messages"] if m.role in ("user", "assistant")] \
        == ["hello", "first", "again"]

    class Boom(FakeChatClient):
        async def chat(self, messages, tools=None, **kw):
            raise RuntimeError("llm down")

    with pytest.raises(RuntimeError, match="llm down"):
        asyncio.run(SimpleAgent(AgentConfig(), client=Boom()).run("hi"))


def test_incremental_deltas_hooks_and_sink():
    from youtu_rag_tpu_torch.agents.hooks import BaseRunHooks
    from youtu_rag_tpu_torch.agents.llm_agent import LLMAgent

    class Chunky(BaseChatClient):
        async def chat(self, messages, tools=None, **kw):
            return ChatResponse(ChatMessage("assistant", "hello world"))

        async def stream_chat(self, messages, tools=None, **kw):
            for word in ("hello", " world"):
                yield StreamDelta("text_delta", text=word)
            yield StreamDelta("done", response=ChatResponse(ChatMessage("assistant",
                                                                        "hello world")))

    events, sunk = [], []

    class Recording(BaseRunHooks):
        async def on_agent_start(self, agent, task):
            events.append("start")

        async def on_agent_end(self, agent, output):
            events.append("end")
            raise RuntimeError("a hook bug must not break the run")

    async def sink(record):
        sunk.append(record)

    agent = SimpleAgent(AgentConfig(), client=Chunky(), hooks=Recording(), trajectory_sink=sink)

    async def collect():
        rec = agent.run_streamed("hi")
        deltas = [e.text async for e in rec.stream_events() if e.type == "text_delta"]
        return deltas, await rec.wait()

    deltas, rec = asyncio.run(collect())
    assert deltas == ["hello", " world"] and rec.final_output == "hello world"
    assert events == ["start", "end"] and sunk[0]["output"] == "hello world"
    assert asyncio.run(LLMAgent(instructions="judge", client=FakeChatClient()).run("x")) == "echo: x"


def test_sequential_tool_calls_knob():
    order = []

    class Ordered(AsyncBaseToolkit):
        @register_tool
        async def slow(self, tag: str) -> str:
            """Record the order.

            Args:
                tag: The call's name.
            """
            order.append(f"start-{tag}")
            await asyncio.sleep(0.01)
            order.append(f"end-{tag}")
            return tag

    resp = ChatResponse(ChatMessage("assistant", tool_calls=[ToolCall("c1", "slow", '{"tag": "a"}'),
                                                             ToolCall("c2", "slow", '{"tag": "b"}')]))
    cfg = AgentConfig.from_dict({"model": {"parallel_tool_calls": False}})
    client = FakeChatClient(scripted=[resp, FakeChatClient.text_response("ok")])
    asyncio.run(SimpleAgent(cfg, client=client, toolkits=[Ordered()]).run("go"))
    assert order == ["start-a", "end-a", "start-b", "end-b"]


@pytest.mark.parametrize("text, want", [
    ('Thought: t\nAction: add\nAction Input: {"a": 1, "b": {"c": 2}}\nmore', ("add", 1)),
    ("Thought: t\nFinal Answer: 42", (None, 0)),
    ("Action: add\nAction Input: {bad json}", (None, 0)),
    ("no format at all", (None, 0)),
])
def test_parse_react_matches_jax(text, want):
    from youtu_rag_tpu.agents.react import parse_react as jax_parse

    thought, calls, final = parse_react(text)
    jthought, jcalls, jfinal = jax_parse(text)
    assert (thought, final) == (jthought, jfinal)
    assert [(c.name, c.arguments) for c in calls] == [(c.name, c.arguments) for c in jcalls]
    assert (calls[0].name if calls else None, len(calls)) == want


# ---------------------------------------------------------------------------
# the CLI's agentic mode on the committed chat model
# ---------------------------------------------------------------------------

QUESTIONS = ["What is the color of Zoka?", "Tell me the code of Bifu."]


def run_port_cli(corpus, monkeypatch, capsys, device="cpu"):
    from youtu_rag_tpu_torch import cli_chat

    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(QUESTIONS) + "\n"))
    argv = ["--paths", str(corpus), "--llm-weights-dir", str(cli_chat_weights())]
    if device:
        argv += ["--device", device]
    asyncio.run(cli_chat.main(argv))
    return capsys.readouterr().out


def cli_chat_weights():
    from pathlib import Path

    return Path(__file__).resolve().parent.parent / "benchmarks" / "models" / "yrt_tiny_chat"


def jax_transcript(corpus) -> list[str]:
    """scripts/cli_chat.py's agentic loop on the JAX package, printed the
    same way: per question, its text deltas and [tool name(arguments)]
    lines."""
    from youtu_rag_tpu.agents.config import ModelConfig as JaxModelConfig
    from youtu_rag_tpu.models.lm_synth import DEFAULT_KB_INSTRUCTIONS

    kb = JaxKB("cli", JaxRAGConfig(name="cli"))
    kb.embedder._use_native = True  # the hash provider's default path, as the port's CLI runs it
    asyncio.run(kb.build_files(sorted(str(p) for p in corpus.iterdir())))
    acfg = JaxAgentConfig(model=JaxModelConfig(provider="local",
                                               weights_dir=str(cli_chat_weights())))
    acfg.agent.instructions = DEFAULT_KB_INSTRUCTIONS
    agent = JaxAgent(acfg, toolkits=[JaxKBSearch(JaxToolkitConfig(config={"kb": kb}))])

    async def ask(q):
        out = []
        rec = agent.run_streamed(q)
        async for ev in rec.stream_events():
            if ev.type == "text_delta":
                out.append(ev.text)
            elif ev.type == "tool_call":
                out.append(f"\n[tool {ev.name}({ev.arguments})]\n")
        return "".join(out).strip()

    return [asyncio.run(ask(q)) for q in QUESTIONS]


def test_cli_agentic_mode_matches_jax(corpus, monkeypatch, capsys):
    out = run_port_cli(corpus, monkeypatch, capsys)
    assert "agentic mode" in out
    assert "[tool kb_embedding_search(" in out
    answers = [block.strip() for block in out.split("\n> ")[1:-1]]  # one per question
    assert answers == jax_transcript(corpus)
    print("\n".join(answers))


def test_cli_default_device_needs_cuda(corpus, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_port_cli(corpus, monkeypatch, capsys, device=None)


def test_openai_client_matches_jax(monkeypatch):
    """The remote client on a canned ``/chat/completions`` reply (no
    network: ``post_json_with_retry`` is replaced in both packages): the
    same request payload and headers, and the same parsed message, tool
    calls and usage as JAX's."""
    import youtu_rag_tpu.agents.llm as jax_llm
    import youtu_rag_tpu_torch.agents.llm as port_llm

    reply = {"choices": [{"finish_reason": "tool_calls", "message": {
        "role": "assistant", "content": "let me look", "reasoning_content": "think",
        "tool_calls": [{"id": "c7", "function": {"name": "kb_embedding_search",
                                                 "arguments": '{"query": "q"}'}}]}}],
        "usage": {"prompt_tokens": 12, "completion_tokens": 5}}
    seen = {}

    def fake(package):
        async def post(url, payload, **kw):
            seen[package] = (url, payload, kw["headers"])
            return reply
        return post

    monkeypatch.setattr(port_llm, "post_json_with_retry", fake("port"))
    monkeypatch.setattr(jax_llm, "post_json_with_retry", fake("jax"))
    kw = dict(model="m", base_url="http://llm.invalid/v1", api_key="k", temperature=0.2)
    tools = KBSearchToolkit(ToolkitConfig(config={"kb": None})).get_tools_in_openai()
    got = asyncio.run(port_llm.OpenAIChatClient(**kw).chat(
        [ChatMessage("system", "s"), ChatMessage("user", "u")], tools))
    want = asyncio.run(jax_llm.OpenAIChatClient(**kw).chat(
        [jax_llm.ChatMessage("system", "s"), jax_llm.ChatMessage("user", "u")], tools))
    assert seen["port"] == seen["jax"]
    assert got.message.to_openai() == want.message.to_openai()
    assert (got.message.reasoning, got.finish_reason) == (want.message.reasoning,
                                                          want.finish_reason)
    assert (got.usage.input_tokens, got.usage.output_tokens) == (12, 5)
