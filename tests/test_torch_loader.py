"""The port's config loader and agent factory against the JAX package's, on
the CPU.

- every ``configs/{agents,tools,rag,eval}/**/*.yaml`` loads through
  ``ConfigLoader``'s typed loaders to the same ``model_dump()`` in both
  packages (the vector store's ``backend`` names each package's device
  engine: "torch" in the port, where JAX's configs say "tpu");
- ``defaults:`` composition, ``_self_``, ``${oc.env:…}`` / ``${env:…}``
  interpolation and the circular-defaults error, on a config tree of the
  test's own;
- the dicts ``chip_smoke.py`` builds its agents from where the card's host
  has no ``yaml`` equal what the loader makes of the YAML files;
- ``memory_chat`` through ``get_agent`` with a scripted client, both
  packages on the same turns: the same messages shown to the model, the
  same answers and the same stored memories (ids from one seeded stream,
  one frozen clock, the hash embedder's Python path on both), and a
  surfaced skill's outcome moves its stats;
- ``get_agent`` serves ``simple`` and ``llm`` as JAX does.

Tolerance: none; every compared value is text or a config."""

import asyncio
import importlib.util
import random
import time
import types
import uuid
from pathlib import Path

import pytest

import youtu_rag_tpu.memory.store as jax_store_mod
import youtu_rag_tpu.memory.toolkit as jax_toolkit_mod
import youtu_rag_tpu_torch.memory.store as store_mod
import youtu_rag_tpu_torch.memory.toolkit as toolkit_mod
from youtu_rag_tpu.agents.factory import get_agent as jax_get_agent
from youtu_rag_tpu.agents.llm import FakeChatClient as JaxFake
from youtu_rag_tpu.core.loader import ConfigLoader as JaxLoader
from youtu_rag_tpu_torch.agents import get_agent
from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.llm_agent import LLMAgent
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.core.loader import ConfigLoader
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
GROUPS = {"agents": "load_agent_config", "tools": "load_toolkit_config",
          "rag": "load_rag_config", "eval": "load_eval_config"}
ENV = ("YRT_LLM_MODEL", "YRT_LLM_BASE_URL", "YRT_LLM_API_KEY", "YRT_MEMORY_USER",
       "YRT_KB_NAME", "YRT_TEXT2SQL_DB")
CONFIG_FILES = sorted(
    (group, p.relative_to(CONFIGS / group).with_suffix("").as_posix())
    for group in GROUPS for p in (CONFIGS / group).rglob("*.yaml"))


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def engine_neutral(dump):
    """A model_dump with every vector store's backend left out."""
    if isinstance(dump, dict):
        return {k: engine_neutral(v) for k, v in dump.items()
                if not (k == "backend" and v in ("torch", "tpu"))}
    if isinstance(dump, list):
        return [engine_neutral(v) for v in dump]
    return dump


@pytest.mark.parametrize("group, name", CONFIG_FILES, ids=[f"{g}/{n}" for g, n in CONFIG_FILES])
def test_config_loads_match_jax(group, name, clean_env):
    port_loader, jax_loader = ConfigLoader(), JaxLoader()
    assert port_loader.root == jax_loader.root == CONFIGS
    assert port_loader.load_raw(name, group) == jax_loader.load_raw(name, group)
    got = getattr(port_loader, GROUPS[group])(name).model_dump()
    want = getattr(jax_loader, GROUPS[group])(name).model_dump()
    assert engine_neutral(got) == engine_neutral(want)
    if group == "rag":
        assert got["vector_store"]["backend"] == "torch"


def write_tree(root: Path) -> None:
    (root / "agents" / "base").mkdir(parents=True)
    (root / "agents" / "base" / "one.yaml").write_text(
        "type: simple\nmax_turns: 7\nagent:\n  name: one\n  instructions: base text\n"
        "model:\n  model: ${oc.env:T_MODEL,fallback-model}\n")
    (root / "agents" / "child.yaml").write_text(
        "defaults:\n  - _self_\n  - base/one\nagent:\n  name: child\nmax_turns: 3\n"
        "memory:\n  enabled: ${oc.env:T_ENABLED,false}\n  user_id: ${oc.env:T_USER,u-default}\n"
        "  max_context_items: ${oc.env:T_ITEMS,4}\n")
    (root / "agents" / "later.yaml").write_text(
        "defaults:\n  - base/one\nagent:\n  name: later\n  instructions: 'x ${env:T_USER} z'\n")
    (root / "agents" / "loop_a.yaml").write_text("defaults:\n  - loop_b\n")
    (root / "agents" / "loop_b.yaml").write_text("defaults:\n  - loop_a\n")
    (root / "tools").mkdir()
    (root / "tools" / "t.yaml").write_text("mode: builtin\nconfig:\n  db: ${oc.env:T_DB,}\n")


@pytest.mark.parametrize("env", [{}, {"T_MODEL": "m1", "T_ENABLED": "true", "T_USER": "ann",
                                      "T_ITEMS": "12", "T_DB": "sqlite:///x.db"}],
                         ids=["defaults", "set"])
def test_composition_and_interpolation_match_jax(tmp_path, monkeypatch, env):
    write_tree(tmp_path)
    for var in ("T_MODEL", "T_ENABLED", "T_USER", "T_ITEMS", "T_DB"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    port_loader, jax_loader = ConfigLoader(tmp_path), JaxLoader(tmp_path)
    for name in ("child", "later"):
        assert port_loader.load_raw(name, "agents") == jax_loader.load_raw(name, "agents")
        assert (port_loader.load_agent_config(name).model_dump()
                == jax_loader.load_agent_config(name).model_dump())
    tk = port_loader.load_toolkit_config("t")
    assert tk.model_dump() == jax_loader.load_toolkit_config("t").model_dump()
    assert tk.name == "t"
    child = port_loader.load_agent_config("child")
    # _self_ first: the base's keys win over the file's own
    assert child.max_turns == 7 and child.agent.name == "one"
    assert child.memory.max_context_items == (12 if env else 4)
    for loader in (port_loader, jax_loader):
        with pytest.raises(ValueError, match="circular defaults"):
            loader.load_raw("loop_a", "agents")
        with pytest.raises(FileNotFoundError):
            loader.load_raw("missing", "agents")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_config_dicts_equal_the_loader(clean_env):
    """chip_smoke.py phases 4g and 4j build their agents from CONFIG_DICTS
    where the card's host has no yaml: the same configs as the loader's."""
    loader = ConfigLoader()
    dicts = chip_smoke().CONFIG_DICTS
    assert sorted(dicts) == [("agents", "examples/excel_qa"), ("agents", "memory_chat"),
                             ("agents", "meta_retrieval"), ("tools", "text2sql")]
    for (group, name), raw in dicts.items():
        assert loader.load_raw(name, group) == raw
    assert (AgentConfig.model_validate(dicts["agents", "memory_chat"]).model_dump()
            == loader.load_agent_config("memory_chat").model_dump())


# ---------------------------------------------------------------------------
# memory_chat through get_agent, on both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def frozen(monkeypatch):
    """One frozen clock and one seeded id stream per package's memory modules."""
    now = time.time()
    clock = types.SimpleNamespace(
        time=lambda: now, strftime=lambda fmt, *_: time.strftime(fmt, time.localtime(now)))
    for mods in ((store_mod, toolkit_mod), (jax_store_mod, jax_toolkit_mod)):
        ids = random.Random(0)
        stream = types.SimpleNamespace(uuid4=lambda ids=ids: uuid.UUID(int=ids.getrandbits(128)))
        for mod in mods:
            monkeypatch.setattr(mod, "time", clock)
            monkeypatch.setattr(mod, "uuid", stream)


def memory_toolkits(agent):
    """The agent's memory toolkit (memory.enabled) and the config's one."""
    return [agent.memory_toolkit] + [tk for tk in agent.router.toolkits if hasattr(tk, "store")]


def memories(agent):
    return [[(m.id, m.user_id, m.memory_type, m.content, m.importance, m.session_id,
              m.use_count, m.success_count) for m in tk.store._nodes.values()]
            for tk in memory_toolkits(agent)]


async def drive_memory_chat(agent, fake_cls):
    await agent.build()
    for tk in memory_toolkits(agent):
        tk.store.embedder._use_native = False  # the Python hash path on both sides
    out = []
    rec = await agent.run("Please remember: my favourite colour is teal.")
    out.append((rec.final_output, [(t.name, t.arguments, t.output) for t in rec.tool_calls]))
    skill = await agent.memory_toolkit.store_skill(
        "colour-recall", "For questions about the user's favourite colour", ["search_memory"])
    rec = await agent.run("What is my favourite colour?")
    out.append((rec.final_output, [(t.name, t.arguments, t.output) for t in rec.tool_calls]))
    out.append(skill)
    shown = [[(m.role, m.content) for m in call["messages"]] for call in agent.client.calls]
    return out, shown, memories(agent)


def scripted_memory_turns(fake):
    return [fake.tool_response("add_memory", {"content": "The user's favourite colour is teal.",
                                              "memory_type": "semantic", "importance": 0.9}),
            fake.text_response("Noted: teal."),
            fake.text_response("Your favourite colour is teal.")]


def test_memory_chat_through_get_agent_matches_jax(clean_env, frozen):
    cfg = ConfigLoader().load_agent_config("memory_chat")
    agent = get_agent(cfg, client=FakeChatClient(scripted=scripted_memory_turns(FakeChatClient)),
                      device="cpu")
    assert isinstance(agent, SimpleAgent)
    got = asyncio.run(drive_memory_chat(agent, FakeChatClient))
    jcfg = JaxLoader().load_agent_config("memory_chat")
    jagent = jax_get_agent(jcfg, client=JaxFake(scripted=scripted_memory_turns(JaxFake)))
    want = asyncio.run(drive_memory_chat(jagent, JaxFake))
    assert got == want
    (first, second, _), shown, (agent_memories, toolkit_memories) = got
    assert first[1][0][0] == "add_memory" and "Stored semantic memory" in first[1][0][2]
    assert second[0] == "Your favourite colour is teal."
    # run 2 was shown run 1's turn as memory, and the stored skill
    system = shown[-1][0]
    assert system[0] == "system" and "## Relevant memory" in system[1]
    assert "favourite colour is teal" in system[1] and "colour-recall" in system[1]
    assert any("teal" in m[3] for m in toolkit_memories)
    # the skill surfaced in run 2 and the run answered: its stats moved
    (skill,) = [m for m in agent_memories if m[2] == "procedural"]
    assert skill[6:] == (1, 1)
    assert {m[2] for m in agent_memories} == {"working", "episodic", "procedural"}
    assert all(tk.store.store.device.type == "cpu" for tk in memory_toolkits(agent))


def test_get_agent_serves_simple_and_llm_as_jax(clean_env):
    for spec in ({"type": "simple"}, {"type": "llm", "agent": {"instructions": "Be brief."}}):
        agent = get_agent(spec, client=FakeChatClient())
        jagent = jax_get_agent(spec, client=JaxFake())
        assert type(agent).__name__ == type(jagent).__name__
        assert isinstance(agent, (SimpleAgent, LLMAgent))
        out = asyncio.run(agent.run("hello there"))
        jout = asyncio.run(jagent.run("hello there"))
        if spec["type"] == "simple":
            out, jout = out.final_output, jout.final_output
        assert out == jout == "echo: hello there"
