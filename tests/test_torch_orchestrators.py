"""The port's orchestrators (``agents/orchestra.py``, ``orchestrator.py``,
``workforce.py``, ``factory.py``) against the JAX package's, on the CPU.

- each of the 17 tests of ``tests/agents/test_orchestrators.py`` runs as a
  case on both packages: the JAX test's own asserts hold on each, and the
  outputs compare equal (final output, trajectory, the event stream with
  its timestamps and ``duration_ms`` left out, the prompts the scripted
  models saw); the parallel orchestrator's events compare per worker, in
  order, since concurrent workers interleave freely;
- the five shipped configs (``orchestra_example``, ``workforce_example``,
  ``orchestrator/chain``, ``orchestrator/parallel``,
  ``examples/text2sql``) load through each package's ``ConfigLoader`` and
  build through ``get_agent``; ``device="cpu"`` reaches every worker, its
  toolkits and its clients, and a ``provider: local`` worker model is a
  ``LocalChatClient`` on the CPU;
- ``chip_smoke.py`` phase 4h's scripted runs (its scenario code, on a
  small corpus) on both packages: the same final outputs, per-worker
  events, trajectories, trajectory-store rows and trace rows;
- the store's search coalescer under the parallel orchestrator: searches
  that ``task_timeout`` cancels in the coalescer's window leave the next
  run's results as an uncoalesced store's.

Tolerance: exact for text, events and SQL; a KB search's printed scores
within TOL + 1e-3 where near-ties may trade places (``same_observation``)."""

import asyncio
import importlib.util
import json
import re
import types
from pathlib import Path

import pytest

import youtu_rag_tpu.agents.factory as jax_factory
import youtu_rag_tpu.agents.orchestra as jax_orchestra
import youtu_rag_tpu.agents.orchestrator as jax_orchestrator
import youtu_rag_tpu.agents.workforce as jax_workforce
import youtu_rag_tpu_torch.agents.factory as factory
import youtu_rag_tpu_torch.agents.orchestra as orchestra
import youtu_rag_tpu_torch.agents.orchestrator as orchestrator
import youtu_rag_tpu_torch.agents.workforce as workforce
from youtu_rag_tpu.agents.config import AgentConfig as JaxAgentConfig
from youtu_rag_tpu.agents.llm import FakeChatClient as JaxFake
from youtu_rag_tpu.agents.simple_agent import SimpleAgent as JaxSimpleAgent
from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.llm import FakeChatClient
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

REPO = Path(__file__).resolve().parent.parent


def package(jax: bool):
    if jax:
        return types.SimpleNamespace(
            AgentConfig=JaxAgentConfig, Fake=JaxFake, SimpleAgent=JaxSimpleAgent,
            orchestra=jax_orchestra, orchestrator=jax_orchestrator, workforce=jax_workforce,
            get_agent=jax_factory.get_agent)
    return types.SimpleNamespace(
        AgentConfig=AgentConfig, Fake=FakeChatClient, SimpleAgent=SimpleAgent,
        orchestra=orchestra, orchestrator=orchestrator, workforce=workforce,
        get_agent=factory.get_agent)


def event_view(e):
    data = {k: v for k, v in e.data.items() if k != "duration_ms"}
    return (e.type, e.text, e.name, e.arguments, e.call_id, json.dumps(data, sort_keys=True))


def per_worker(events):
    """The events of each worker (tag ``parallel_agent`` or ``agent_name``)
    and the orchestrator's own, each in order."""
    out: dict[str, list] = {}
    for e in events:
        key = e.data.get("parallel_agent") or e.data.get("agent_name") or ""
        out.setdefault(key, []).append(event_view(e))
    return out


def record_view(rec):
    return (rec.final_output, rec.trajectory, rec.error,
            [(t.name, t.arguments, t.output) for t in rec.tool_calls])


def worker(ns, reply):
    return ns.SimpleAgent(ns.AgentConfig(), client=ns.Fake(
        rule_fn=lambda m, t: ns.Fake.text_response(reply)))


def streamed(agent, task):
    async def collect():
        rec = agent.run_streamed(task)
        evs = [e async for e in rec.stream_events()]
        await rec.wait()
        return rec, evs

    return asyncio.run(collect())


# ---------------------------------------------------------------------------
# the 17 cases of tests/agents/test_orchestrators.py
# ---------------------------------------------------------------------------


def case_parse_plan_protocol(ns):
    text = (
        "<analysis>split into search and math</analysis>\n"
        '<plan>[\n{"agent_name": "searcher", "task": "find population", "completed": false},\n'
        '{"agent_name": "calculator", "task": "double it", "completed": false}\n]</plan>'
    )
    plan = ns.orchestra.parse_plan(text)
    assert plan.analysis == "split into search and math"
    assert [t.agent_name for t in plan.todo] == ["searcher", "calculator"]
    assert ns.orchestra.parse_plan("garbage").todo == []
    return plan.analysis, [vars(t) for t in plan.todo]


PLAN_TWO = (
    "<analysis>two steps</analysis>"
    '<plan>[{"agent_name": "searcher", "task": "look up X", "completed": false},'
    '{"agent_name": "writer", "task": "summarize", "completed": false}]</plan>'
)


def case_orchestra_plan_work_report(ns):
    def rule(messages, tools):
        content = messages[-1].content or ""
        if "task planner" in (messages[0].content or ""):
            return ns.Fake.text_response(PLAN_TWO)
        if "reporter" in content.lower() or "Trajectory:" in content:
            return ns.Fake.text_response("FINAL REPORT")
        return ns.Fake.text_response("?")

    client = ns.Fake(rule_fn=rule)
    agent = ns.orchestra.OrchestraAgent(
        ns.AgentConfig(type="orchestra"), client=client,
        workers={"searcher": worker(ns, "X is 42"), "writer": worker(ns, "Summary: 42")})
    rec = asyncio.run(agent.run("what is X?"))
    assert rec.final_output == "FINAL REPORT"
    roles = [t.get("role") for t in rec.trajectory]
    assert "searcher" in roles and "writer" in roles
    return record_view(rec), [[(m.role, m.content) for m in c["messages"]] for c in client.calls]


def one_step_rule(ns, plan_text, other="done"):
    def rule(messages, tools):
        if "task planner" in (messages[0].content or ""):
            return ns.Fake.text_response(plan_text)
        return ns.Fake.text_response(other)
    return rule


def case_orchestra_events_stream(ns):
    plan = '<analysis>a</analysis><plan>[{"agent_name": "w", "task": "t", "completed": false}]</plan>'
    agent = ns.orchestra.OrchestraAgent(ns.AgentConfig(type="orchestra"),
                                        client=ns.Fake(rule_fn=one_step_rule(ns, plan)),
                                        workers={"w": worker(ns, "ok")})
    rec, evs = streamed(agent, "q")
    types_ = [e.type for e in evs]
    assert "plan" in types_ and "agent_switch" in types_ and "report" in types_
    assert types_[-1] == "final"
    return record_view(rec), [event_view(e) for e in evs]


def case_orchestra_workflow_updates(ns):
    plan = ('<analysis>a</analysis><plan>[{"agent_name": "w1", "task": "t1", "completed": false},'
            '{"agent_name": "w2", "task": "t2", "completed": false}]</plan>')
    agent = ns.orchestra.OrchestraAgent(
        ns.AgentConfig(type="orchestra"), client=ns.Fake(rule_fn=one_step_rule(ns, plan)),
        workers={"w1": worker(ns, "r1"), "w2": worker(ns, "r2")})
    rec, evs = streamed(agent, "q")
    wfs = [e.data["nodes"] for e in evs if e.type == "workflow_update"]
    assert len(wfs) >= 5
    assert [n["status"] for n in wfs[0]] == ["pending", "pending"]
    assert any([n["status"] for n in w] == ["running", "pending"] for w in wfs)
    assert any([n["status"] for n in w] == ["done", "running"] for w in wfs)
    assert [n["status"] for n in wfs[-1]] == ["done", "done"]
    assert wfs[0][0]["agent"] == "w1" and wfs[0][1]["task"] == "t2"
    return record_view(rec), [event_view(e) for e in evs]


def case_chain_orchestrator_sequential_context(ns):
    seen = []

    def worker_rule(msgs, tools):
        prompt = next(m.content for m in reversed(msgs) if m.role == "user")
        seen.append(prompt)
        return ns.Fake.text_response(f"result-of[{prompt[-20:]}]")

    workers = {n: ns.SimpleAgent(ns.AgentConfig(), client=ns.Fake(rule_fn=worker_rule))
               for n in ("a", "b")}
    router = ns.Fake(rule_fn=lambda m, t: ns.Fake.text_response(
        '[{"agent_name": "a", "task": "step one"}, {"agent_name": "b", "task": "step two"}]'))
    agent = ns.orchestrator.OrchestratorAgent(ns.AgentConfig(type="orchestrator"),
                                              client=router, workers=workers)
    rec, evs = streamed(agent, "do the thing")
    assert rec.final_output.startswith("result-of")
    assert "Result of step 1" in seen[1]
    return record_view(rec), [event_view(e) for e in evs], seen


def case_chain_orchestrator_chitchat_path(ns):
    def router_rule(msgs, tools):
        if "orchestrator routing" in (msgs[0].content or ""):
            return ns.Fake.text_response('[{"agent_name": "chitchat", "task": "hi"}]')
        return ns.Fake.text_response("hello there!")

    agent = ns.orchestrator.OrchestratorAgent(
        ns.AgentConfig(type="orchestrator"), client=ns.Fake(rule_fn=router_rule), workers={})
    rec, evs = streamed(agent, "hi")
    assert rec.final_output == "hello there!"
    return record_view(rec), [event_view(e) for e in evs]


def parallel_router(ns, plan):
    def rule(msgs, tools):
        content = msgs[-1].content or ""
        if "INDEPENDENT" in (msgs[0].content or ""):
            return ns.Fake.text_response(plan)
        if content.startswith("Merge the results"):
            return ns.Fake.text_response("MERGED")
        return ns.Fake.text_response("?")
    return rule


def case_parallel_orchestrator_merges(ns):
    agent = ns.orchestrator.ParallelOrchestratorAgent(
        ns.AgentConfig(type="parallel_orchestrator", max_parallel=2),
        client=ns.Fake(rule_fn=parallel_router(
            ns, '[{"agent_name": "a", "task": "part 1"}, {"agent_name": "b", "task": "part 2"}]')),
        workers={"a": worker(ns, "alpha"), "b": worker(ns, "beta")})
    rec, evs = streamed(agent, "big question")
    assert rec.final_output == "MERGED"
    assert {t.get("role") for t in rec.trajectory if t.get("role") in ("a", "b")} == {"a", "b"}
    return (rec.final_output, sorted(json.dumps(t, sort_keys=True) for t in rec.trajectory),
            per_worker(evs))


class SlowMixin:
    async def chat(self, messages, tools=None, **kw):
        await asyncio.sleep(1.0)
        return self.text_response("late")


def slow_agent(ns, router_rule):
    slow_client = type("SlowClient", (SlowMixin, ns.Fake), {})()
    return ns.orchestrator.ParallelOrchestratorAgent(
        ns.AgentConfig(type="parallel_orchestrator", task_timeout=0.05),
        client=ns.Fake(rule_fn=router_rule),
        workers={"slow": ns.SimpleAgent(ns.AgentConfig(), client=slow_client)})


def slow_router(ns):
    def rule(msgs, tools):
        if "INDEPENDENT" in (msgs[0].content or ""):
            return ns.Fake.text_response('[{"agent_name": "slow", "task": "x"}]')
        return ns.Fake.text_response("merged anyway")
    return rule


def case_parallel_orchestrator_timeout(ns):
    rec = asyncio.run(slow_agent(ns, slow_router(ns)).run("q"))
    assert rec.final_output == "merged anyway"
    assert any("timed out" in (t.get("content") or "") for t in rec.trajectory)
    return record_view(rec)


def case_parse_parallel_plan_groups_and_flat(ns):
    parse = ns.orchestrator.parse_parallel_plan
    groups = parse(
        '{"groups": [[{"agent_name": "a", "task": "t1"}, {"agent_name": "b", "task": "t2"}],'
        ' [{"agent_name": "c", "task": "t3"}]]}')
    assert [len(g) for g in groups] == [2, 1]
    assert groups[1][0].agent_name == "c"
    flat = parse('[{"agent_name": "a", "task": "t"}]')
    assert len(flat) == 1 and len(flat[0]) == 1
    assert parse("garbage") == [] and parse('{"groups": []}') == []
    return [[vars(t) for t in g] for g in groups], [[vars(t) for t in g] for g in flat]


def case_parallel_orchestrator_grouped_streaming(ns):
    seen = []

    def worker_rule(msgs, tools):
        prompt = next(m.content for m in reversed(msgs) if m.role == "user")
        seen.append(prompt)
        return ns.Fake.text_response(f"res[{prompt[:12]}]")

    workers = {n: ns.SimpleAgent(ns.AgentConfig(), client=ns.Fake(rule_fn=worker_rule))
               for n in ("a", "b", "c")}
    plan = ('{"groups": [[{"agent_name": "a", "task": "part 1"},'
            ' {"agent_name": "b", "task": "part 2"}],'
            ' [{"agent_name": "c", "task": "combine"}]]}')
    agent = ns.orchestrator.ParallelOrchestratorAgent(
        ns.AgentConfig(type="parallel_orchestrator", max_parallel=2),
        client=ns.Fake(rule_fn=parallel_router(ns, plan)), workers=workers)
    rec, evs = streamed(agent, "big question")
    assert rec.final_output == "MERGED"
    assert any("Result of earlier task" in p and "Your task: combine" in p for p in seen)
    kinds = [(e.type, e.data.get("status")) for e in evs
             if e.type in ("parallel_group", "parallel_task", "merge")]
    assert kinds.count(("parallel_group", "start")) == 2
    assert kinds.count(("parallel_group", "done")) == 2
    assert kinds.count(("parallel_task", "start")) == 3
    assert kinds.count(("parallel_task", "done")) == 3
    assert ("merge", "start") in kinds and ("merge", "done") in kinds
    g_evs = [e.data for e in evs if e.type == "parallel_group"]
    assert [(d["group"], d["status"]) for d in g_evs] == [
        (0, "start"), (0, "done"), (1, "start"), (1, "done")]
    tagged = [e for e in evs if e.data.get("parallel_agent")]
    assert tagged and all(e.type not in ("final", "error", "done") for e in tagged)
    dones = [e for e in evs if e.type == "parallel_task" and e.data["status"] == "done"]
    assert all("res[" in d.data["result"] and "duration_ms" in d.data for d in dones)
    return rec.final_output, per_worker(evs), sorted(seen)


def case_parallel_orchestrator_timeout_emits_task_card(ns):
    rec, evs = streamed(slow_agent(ns, slow_router(ns)), "q")
    assert rec.final_output == "merged anyway"
    cards = [e.data for e in evs if e.type == "parallel_task"]
    assert cards[-1]["status"] == "timeout" and "timed out" in cards[-1]["error"]
    return record_view(rec), per_worker(evs)


def workforce_rule(ns, plan, check, answer, calls=None):
    def rule(msgs, tools):
        content = msgs[-1].content or ""
        system = msgs[0].content or ""
        if "project planner" in system:
            return ns.Fake.text_response(plan)
        if content.startswith("Pick the best executor"):
            name = ("researcher" if "Task: research" in content else "writer") if calls else "e"
            return ns.Fake.text_response(json.dumps({"executor": name, "instruction": "do it"})
                                         if calls else '{"executor": "e", "instruction": "go"}')
        if content.startswith("You are reviewing plan progress"):
            if calls is not None:
                calls["check"] += 1
            return ns.Fake.text_response(check)
        if content.startswith("Extract the final answer"):
            return ns.Fake.text_response(answer)
        return ns.Fake.text_response("?")
    return rule


def case_workforce_full_loop(ns):
    calls = {"check": 0}
    agent = ns.workforce.WorkforceAgent(
        ns.AgentConfig(type="workforce"),
        client=ns.Fake(rule_fn=workforce_rule(ns, '["research topic", "write summary"]',
                                              '{"action": "continue"}', "WORKFORCE ANSWER",
                                              calls)),
        executors={"researcher": worker(ns, "facts found"),
                   "writer": worker(ns, "summary written")})
    rec, evs = streamed(agent, "research and summarize")
    assert rec.final_output == "WORKFORCE ANSWER"
    assert calls["check"] == 2
    assert [t.get("role") for t in rec.trajectory if t.get("role") in ("researcher", "writer")] \
        == ["researcher", "writer"]
    return record_view(rec), [event_view(e) for e in evs]


def case_workforce_workflow_updates(ns):
    agent = ns.workforce.WorkforceAgent(
        ns.AgentConfig(type="workforce"),
        client=ns.Fake(rule_fn=workforce_rule(ns, '["t1", "t2"]', '{"action": "continue"}', "A")),
        executors={"e": worker(ns, "ok")})
    rec, evs = streamed(agent, "q")
    wfs = [e.data["nodes"] for e in evs if e.type == "workflow_update"]
    assert [n["status"] for n in wfs[0]] == ["pending", "pending"]
    assert any([n["status"] for n in w] == ["running", "pending"] for w in wfs)
    assert [n["status"] for n in wfs[-1]] == ["done", "done"]
    return record_view(rec), [event_view(e) for e in evs]


def case_workforce_early_finish(ns):
    agent = ns.workforce.WorkforceAgent(
        ns.AgentConfig(type="workforce"),
        client=ns.Fake(rule_fn=workforce_rule(ns, '["t1", "t2", "t3"]', '{"action": "finish"}',
                                              "EARLY")),
        executors={"e": worker(ns, "ok")})
    rec = asyncio.run(agent.run("q"))
    assert rec.final_output == "EARLY"
    assert len([t for t in rec.trajectory if t.get("role") == "e"]) == 1
    return record_view(rec)


def case_factory_builds_orchestrators(ns):
    c = ns.Fake()
    built = {t: type(ns.get_agent({"type": t}, client=c)).__name__
             for t in ("orchestra", "orchestrator", "parallel_orchestrator", "workforce")}
    assert built == {"orchestra": "OrchestraAgent", "orchestrator": "OrchestratorAgent",
                     "parallel_orchestrator": "ParallelOrchestratorAgent",
                     "workforce": "WorkforceAgent"}
    assert isinstance(ns.get_agent({"type": "orchestra"}, client=c), ns.orchestra.OrchestraAgent)
    return built


def case_parse_task_list_robust(ns):
    parse = ns.orchestrator.parse_task_list
    assert parse("no json here") == []
    ts = parse('prefix [{"agent_name": "a", "task": "t"}] suffix')
    assert ts[0].agent_name == "a"
    return [vars(t) for t in ts]


def case_planner_examples_rendered(ns):
    text = ns.orchestra.load_planner_examples()
    assert "Q3 revenue" in text and "<plan>[" in text
    seen = {}
    plan = '<analysis>a</analysis><plan>[{"agent_name": "w", "task": "t", "completed": false}]</plan>'

    def rule(messages, tools):
        if "task planner" in (messages[0].content or ""):
            seen["prompt"] = messages[0].content
            return ns.Fake.text_response(plan)
        return ns.Fake.text_response("done")

    prompts = []
    for cfg in (ns.AgentConfig(type="orchestra"),
                ns.AgentConfig(type="orchestra", planner_config={"use_examples": False})):
        agent = ns.orchestra.OrchestraAgent(cfg, client=ns.Fake(rule_fn=rule),
                                            workers={"w": worker(ns, "ok")})
        asyncio.run(agent.run("q"))
        prompts.append(seen["prompt"])
    assert "Examples:" in prompts[0] and "Examples:" not in prompts[1]
    return text, prompts


CASES = [case_parse_plan_protocol, case_orchestra_plan_work_report, case_orchestra_events_stream,
         case_orchestra_workflow_updates, case_chain_orchestrator_sequential_context,
         case_chain_orchestrator_chitchat_path, case_parallel_orchestrator_merges,
         case_parallel_orchestrator_timeout, case_parse_parallel_plan_groups_and_flat,
         case_parallel_orchestrator_grouped_streaming,
         case_parallel_orchestrator_timeout_emits_task_card, case_workforce_full_loop,
         case_workforce_workflow_updates, case_workforce_early_finish,
         case_factory_builds_orchestrators, case_parse_task_list_robust,
         case_planner_examples_rendered]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_case_matches_jax(case):
    assert case(package(jax=False)) == case(package(jax=True))


def test_planner_examples_are_the_ports_own_copy():
    path = Path(orchestra.__file__).parent / "data" / "planner_examples.json"
    assert path.exists()
    assert json.loads(path.read_text()) == json.loads(
        (Path(jax_orchestra.__file__).parent / "data" / "planner_examples.json").read_text())
    assert orchestra.load_planner_examples() == jax_orchestra.load_planner_examples()
    assert orchestra.load_planner_examples(str(path.parent / "missing.json")) == ""


# ---------------------------------------------------------------------------
# the shipped configs through get_agent, with the device seam
# ---------------------------------------------------------------------------

SHIPPED = ("orchestra_example", "workforce_example", "orchestrator/chain",
           "orchestrator/parallel", "examples/text2sql")
TYPES = {"orchestra_example": "OrchestraAgent", "workforce_example": "WorkforceAgent",
         "orchestrator/chain": "OrchestratorAgent",
         "orchestrator/parallel": "ParallelOrchestratorAgent",
         "examples/text2sql": "OrchestraAgent"}
CLEAN_ENV = ("YRT_LLM_MODEL", "YRT_LLM_BASE_URL", "YRT_LLM_API_KEY", "YRT_KB_NAME",
             "YRT_TEXT2SQL_DB")


@pytest.fixture
def clean_env(monkeypatch):
    for var in CLEAN_ENV:
        monkeypatch.delenv(var, raising=False)


def workers_of(agent):
    return getattr(agent, "_workers", None) or getattr(agent, "_executors", None) or {}


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_builds_with_device(name, clean_env):
    from youtu_rag_tpu.core.loader import ConfigLoader as JaxLoader
    from youtu_rag_tpu_torch.core.loader import ConfigLoader

    cfg = ConfigLoader().load_agent_config(name)
    jax_cfg = JaxLoader().load_agent_config(name)
    agent = factory.get_agent(cfg, client=FakeChatClient(), device="cpu")
    jax_agent = jax_factory.get_agent(jax_cfg, client=JaxFake())
    assert type(agent).__name__ == type(jax_agent).__name__ == TYPES[name]
    asyncio.run(agent.build())
    asyncio.run(jax_agent.build())
    assert sorted(workers_of(agent)) == sorted(workers_of(jax_agent))
    assert workers_of(agent)
    for w in workers_of(agent).values():
        if isinstance(w, SimpleAgent):
            assert w.device == "cpu"
            assert all(tk.config.config.get("device") == "cpu" for tk in w.router.toolkits)
        else:  # orchestra_react_sql's text2sql worker
            assert type(w).__name__ == "Text2SQLWorkerAgent"
    asyncio.run(agent.cleanup())


@pytest.mark.parametrize("name", ["orchestra_example", "workforce_example",
                                  "orchestrator/parallel"])
def test_local_worker_models_land_on_the_device(name, clean_env):
    """A worker model of ``provider: local`` becomes a LocalChatClient on the
    orchestrator's device, for every worker it builds from config."""
    from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient
    from youtu_rag_tpu_torch.core.loader import ConfigLoader

    cfg = ConfigLoader().load_agent_config(name)
    local = {"provider": "local", "weights_dir": str(REPO / "benchmarks/models/yrt_tiny_chat")}
    entries = (cfg.workers or cfg.orchestrator_workers or cfg.workforce_executor_agents)
    for w_cfg in entries.values():
        w_cfg.model = w_cfg.model.model_validate(local)
    agent = factory.get_agent(cfg, client=FakeChatClient(), device="cpu")
    asyncio.run(agent.build())
    for w in workers_of(agent).values():
        inner = w.client.inner
        assert isinstance(inner, LocalChatClient) and inner.device.type == "cpu"


def test_text2sql_worker_llm_gets_the_device(clean_env):
    """orchestra_react_sql's text2sql worker: a given client wins, as in JAX;
    else its LLMAgent builds the config's model on the agent's device."""
    from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient
    from youtu_rag_tpu_torch.core.loader import ConfigLoader

    cfg = ConfigLoader().load_agent_config("examples/text2sql")
    agent = factory.get_agent(cfg, device="cpu", client=FakeChatClient())
    assert isinstance(agent._workers["text2sql"].agent.llm.client, FakeChatClient)
    cfg = ConfigLoader().load_agent_config("examples/text2sql")
    cfg.model = cfg.model.model_validate(
        {"provider": "local", "weights_dir": str(REPO / "benchmarks/models/yrt_tiny_chat")})
    agent = factory.get_agent(cfg, device="cpu")
    inner = agent._workers["text2sql"].agent.llm.client.inner
    assert isinstance(inner, LocalChatClient) and inner.device.type == "cpu"


def test_registry_types_and_refusals():
    assert set(factory.ORCHESTRATOR_TYPES) == {"orchestra", "orchestra_react_sql",
                                               "orchestrator", "parallel_orchestrator",
                                               "workforce"}
    for t in factory.ORCHESTRATOR_TYPES:
        assert type(factory.get_agent({"type": t}, client=FakeChatClient())).__name__ == \
            type(jax_factory.get_agent({"type": t}, client=JaxFake())).__name__
    # the excel type is ported (integrations/dtr): the port's ExcelAgent
    assert type(factory.get_agent({"type": "excel"}, client=FakeChatClient())).__name__ == \
        type(jax_factory.get_agent({"type": "excel"}, client=JaxFake())).__name__ == "ExcelAgent"


# ---------------------------------------------------------------------------
# chip_smoke.py phase 4h's scripted runs, on both packages
# ---------------------------------------------------------------------------


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return chip_smoke()


@pytest.fixture(scope="module")
def team_kbs(smoke, tmp_path_factory):
    """Phase 4h's KBs on a small corpus, in each package: the facts, the
    port's KB and the JAX package's (the native hash path on both), and
    each package's text2sql KB with its sqlite database_url."""
    from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
    from youtu_rag_tpu.ingest.processors import SourceTask as JaxSourceTask
    from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.ingest.processors import SourceTask
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    root = tmp_path_factory.mktemp("team")
    facts = smoke.write_ingest_corpus(str(root), 0, n_docs=24, chars=1500)
    names = smoke.write_table_sources(str(root))
    out = {"facts": facts}
    for side, kb_cls, cfg_cls, task_cls in (("port", KnowledgeBase, RAGConfig, SourceTask),
                                            ("jax", JaxKB, JaxRAGConfig, JaxSourceTask)):
        kw = {"device": "cpu"} if side == "port" else {}
        kb = kb_cls(f"team-{side}", cfg_cls(name=f"team-{side}"), **kw)
        asyncio.run(kb.build_sources([task_cls(n, "text", path=str(root / n)) for n, _ in facts]))
        t2s = kb_cls(f"t2s-{side}", cfg_cls(name=f"t2s-{side}"), **kw)
        report = asyncio.run(t2s.build_sources([task_cls(n, "table", path=str(root / n))
                                                for n in names]))
        table = next(t for t in report.tables if t.startswith("staff"))
        db_url = "sqlite:///" + smoke.write_external_staff(str(root / f"ext-{side}.sqlite"), table)
        out[side] = (kb, t2s, db_url)
    return out


def jax_agents_package():
    import youtu_rag_tpu.agents as agents
    import youtu_rag_tpu.db.models as models
    import youtu_rag_tpu.db.service as service
    import youtu_rag_tpu.tracing.tracer as tracer
    from youtu_rag_tpu.core.loader import ConfigLoader
    from youtu_rag_tpu.retrieval.kb import GLOBAL_KB_REGISTRY

    return types.SimpleNamespace(
        get_agent=jax_factory.get_agent, Fake=agents.FakeChatClient,
        SimpleAgent=agents.SimpleAgent, loader=ConfigLoader(), registry=GLOBAL_KB_REGISTRY,
        DBService=service.DBService, models=models, tracer=tracer, device={})


@pytest.mark.parametrize("kind", ["orchestra_example", "orchestrator/chain",
                                  "orchestrator/parallel", "workforce_example",
                                  "examples/text2sql"])
def test_phase_4h_scenario_matches_jax(smoke, team_kbs, kind, tmp_path, clean_env):
    """Phase 4h (a)-(b) on the CPU: the port against the JAX package, each
    with its own KB on the same corpus, its own trajectory store."""
    facts = team_kbs["facts"]
    asked = facts[:: len(facts) // 4][:4]
    sides = []
    for side, pkg in (("port", smoke.port_agents_package(device="cpu")),
                      ("jax", jax_agents_package())):
        kb, t2s, db_url = team_kbs[side]
        db = pkg.DBService(f"sqlite:///{tmp_path}/{side}.db")
        registered = set(pkg.registry.names())
        if kind == "examples/text2sql":
            run = smoke.text2sql_team_run(pkg, t2s, db_url, db)
        else:
            run = smoke.scripted_run(pkg, kind, kb, asked, db)
        assert set(pkg.registry.names()) == registered  # the run left the registry as it was
        assert run["error"] is None and not run["worker_errors"] and not run["missing"]
        assert run["records_added"] == 1
        assert run["searches"] == (1 if kind == "examples/text2sql" else len(asked))
        assert run["tools"] and run["generations"] or kind == "examples/text2sql"
        sides.append(run)
    got, want = sides
    diffs, ties = smoke.compare_runs(got, want)
    assert not diffs
    if kind == "examples/text2sql":
        sql = got["workers"]["text2sql"][0][3][0]
        assert json.loads(sql[2])["rows"][0][0] == "zed" and "zed" in got["final"]
    else:
        assert re.search(rf"\b{len(asked)} (of {len(asked)} )?facts found", got["final"])


def test_same_observation_allows_near_ties_only(smoke):
    a = ("[1] (score 0.812, source d1.md)\nalpha\n\n[2] (score 0.700, source d2.md)\nbeta"
         "\n\n[3] (score 0.699, source d3.md)\ngamma")
    swapped = ("[1] (score 0.812, source d1.md)\nalpha\n\n[2] (score 0.700, source d3.md)"
               "\ngamma\n\n[3] (score 0.699, source d2.md)\nbeta")
    far = a.replace("0.699", "0.650")
    other_last = a.replace("source d3.md)\ngamma", "source d9.md)\ndelta")
    other_first = a.replace("source d1.md)\nalpha", "source d9.md)\ndelta")
    assert smoke.same_observation(a, a) and smoke.same_observation(swapped, a)
    assert not smoke.same_observation(far, a)
    assert smoke.same_observation(other_last, a) and not smoke.same_observation(other_first, a)
    assert not smoke.same_observation("No results found.", a)


def test_coalescer_survives_a_cancelled_search():
    """A search that task_timeout cancels while it waits in the store's
    coalescer window leaves nothing half-merged: the other search of that
    window and the next window answer as an uncoalesced store does."""
    import numpy as np

    from youtu_rag_tpu_torch.core.config import VectorStoreConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore

    rng = np.random.default_rng(0)
    rows = rng.standard_normal((64, 16)).astype(np.float32)
    stores = [TorchVectorStore(VectorStoreConfig(coalesce_window_ms=w), device="cpu")
              for w in (50.0, 0.0)]
    for store in stores:
        asyncio.run(store.add_chunks([Chunk(f"c{i}", "d", "x", i, embedding=r.tolist())
                                      for i, r in enumerate(rows)]))
    q = rng.standard_normal((3, 16)).astype(np.float32)

    async def go(store):
        doomed = asyncio.ensure_future(store.search(q[0].tolist(), top_k=4))
        other = asyncio.ensure_future(store.search(q[1].tolist(), top_k=4))
        await asyncio.sleep(0.005)  # both wait in the window
        doomed.cancel()
        kept = await other
        after = await store.search(q[2].tolist(), top_k=4)
        return doomed.cancelled(), kept, after

    cancelled, kept, after = asyncio.run(go(stores[0]))
    ref = [asyncio.run(stores[1].search(v.tolist(), top_k=4)) for v in q[1:]]
    assert cancelled
    assert [(c.id, s) for c, s in kept] == [(c.id, s) for c, s in ref[0]]
    assert [(c.id, s) for c, s in after] == [(c.id, s) for c, s in ref[1]]
    assert stores[0]._search_coalescer.stats["queries"] == 3


def test_parallel_timeout_leaves_the_coalescer_clean():
    """A parallel task that task_timeout cancels while its search waits in
    the store's coalescer window: the next run's searches, through the same
    coalescer, answer as an uncoalesced store does."""
    import numpy as np

    from youtu_rag_tpu_torch.core.config import VectorStoreConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.retrieval.store import TorchVectorStore
    from youtu_rag_tpu_torch.tools.base import AsyncBaseToolkit, register_tool

    rng = np.random.default_rng(1)
    rows = rng.standard_normal((64, 16)).astype(np.float32)
    queries = {f"q{i}": v for i, v in enumerate(rng.standard_normal((4, 16)).astype(np.float32))}
    coalesced, plain = (TorchVectorStore(VectorStoreConfig(coalesce_window_ms=w), device="cpu")
                        for w in (100.0, 0.0))
    for store in (coalesced, plain):
        asyncio.run(store.add_chunks([Chunk(f"c{i}", "d", "x", i, embedding=r.tolist())
                                      for i, r in enumerate(rows)]))

    class Search(AsyncBaseToolkit):
        @register_tool
        async def search(self, name: str) -> str:
            """Search the store.

            Args:
                name: The query's name.
            """
            hits = await coalesced.search(queries[name].tolist(), top_k=3)
            return json.dumps([(c.id, round(s, 6)) for c, s in hits])

    def worker_rule(msgs, tools):
        if msgs[-1].role == "tool":
            return FakeChatClient.text_response(msgs[-1].content)
        task = next(m.content for m in msgs if m.role == "user")
        return FakeChatClient.tool_response("search", {"name": task.rsplit(" ", 1)[-1]})

    def agent(timeout, names):
        plan = json.dumps([{"agent_name": "w", "task": f"find {n}"} for n in names])
        router = FakeChatClient(rule_fn=lambda m, t: FakeChatClient.text_response(
            plan if "INDEPENDENT" in (m[0].content or "") else "merged"))
        worker = SimpleAgent(AgentConfig(), client=FakeChatClient(rule_fn=worker_rule),
                             toolkits=[Search()])
        return orchestrator.ParallelOrchestratorAgent(
            AgentConfig(type="parallel_orchestrator", max_parallel=2, task_timeout=timeout),
            client=router, workers={"w": worker})

    async def go():
        first = await agent(0.02, ["q0", "q1"]).run("x")
        second = await agent(30.0, ["q2", "q3"]).run("y")
        return first, second

    first, second = asyncio.run(go())
    assert [t["content"] for t in first.trajectory if t.get("role") == "w"] == [
        "(timed out after 0.02s)"] * 2
    want = {json.dumps([(c.id, round(s, 6)) for c, s in asyncio.run(
        plain.search(queries[n].tolist(), top_k=3))]) for n in ("q2", "q3")}
    assert {t["content"] for t in second.trajectory if t.get("role") == "w"} == want
    assert coalesced._search_coalescer.stats["queries"] == 4
