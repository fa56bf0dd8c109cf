"""The port's trajectory store and tracing sinks (``db/models.py``,
``db/migrations.py``, ``db/service.py``, ``tracing/tracer.py``'s
``DBTracingProcessor`` and ``setup_tracing``, ``tracing/otlp.py``) against
the JAX package's, on the CPU.

Each case of ``tests/db/test_db.py`` (6), ``tests/db/test_migrations.py``
(2) and ``tests/tracing/test_otlp.py`` (5) runs on both packages: the JAX
test's asserts hold on each, and what each returns compares equal. Clocks
and ids: record rows compare without ``created_at``, trace rows without
their ids and ``duration_ms``; OTLP spans compare without their ids and
times, and the payload's scope names the package. Each package's DB files
read the other's.

Tolerance: none; every compared value is a row, a string or a number as
written."""

import asyncio
import dataclasses
import json
import sqlite3
import types

import pytest

import youtu_rag_tpu.agents.llm as jax_llm
import youtu_rag_tpu.agents.simple_agent as jax_simple
import youtu_rag_tpu.db.migrations as jax_migrations
import youtu_rag_tpu.db.models as jax_models
import youtu_rag_tpu.db.service as jax_service
import youtu_rag_tpu.tracing.otlp as jax_otlp
import youtu_rag_tpu.tracing.tracer as jax_tracer
import youtu_rag_tpu_torch.agents.llm as llm
import youtu_rag_tpu_torch.agents.simple_agent as simple
import youtu_rag_tpu_torch.db.migrations as migrations
import youtu_rag_tpu_torch.db.models as models
import youtu_rag_tpu_torch.db.service as service
import youtu_rag_tpu_torch.tracing.otlp as otlp
import youtu_rag_tpu_torch.tracing.tracer as tracer
from youtu_rag_tpu.agents.config import AgentConfig as JaxAgentConfig
from youtu_rag_tpu_torch.agents.config import AgentConfig


def package(jax: bool):
    if jax:
        return types.SimpleNamespace(models=jax_models, service=jax_service,
                                     migrations=jax_migrations, tracer=jax_tracer, otlp=jax_otlp,
                                     llm=jax_llm, simple=jax_simple, AgentConfig=JaxAgentConfig)
    return types.SimpleNamespace(models=models, service=service, migrations=migrations,
                                 tracer=tracer, otlp=otlp, llm=llm, simple=simple,
                                 AgentConfig=AgentConfig)


def row(rec, drop=("created_at",)):
    return {k: v for k, v in dataclasses.asdict(rec).items() if k not in drop}


SPAN_IDS = ("created_at", "trace_id", "span_id", "duration_ms")


# ---------------------------------------------------------------------------
# tests/db/test_db.py
# ---------------------------------------------------------------------------


def case_noop_mode_is_safe(ns, tmp):
    db = ns.service.DBService(url=None)
    assert not db.available
    assert db.add(ns.models.TrajectoryRecord("t1", "q")) is False
    assert db.select(ns.models.TrajectoryRecord) == []
    assert db.count(ns.models.TrajectoryRecord) == 0
    return db.available, db.update(ns.models.TrajectoryRecord, {"trace_id": "t1"}, {"output": "x"})


def case_add_select_roundtrip(ns, tmp):
    db = ns.service.DBService(url=f"sqlite:///{tmp}/t.db")
    rec = ns.models.TrajectoryRecord(
        trace_id="t1", input="what is 2+2", output="4",
        trajectory=[{"role": "user", "content": "what is 2+2"}],
        tool_calls=[{"name": "add", "arguments": "{}"}], usage_input_tokens=10)
    assert db.add(rec)
    got = db.select(ns.models.TrajectoryRecord, where={"trace_id": "t1"})
    assert len(got) == 1 and got[0].output == "4"
    assert got[0].trajectory[0]["role"] == "user"
    assert got[0].tool_calls[0]["name"] == "add" and got[0].usage_input_tokens == 10
    assert got[0].created_at == rec.created_at
    return [row(r) for r in got]


def case_update_and_count(ns, tmp):
    db = ns.service.DBService(url=f"sqlite:///{tmp}/t.db")
    for i in range(3):
        db.add(ns.models.EvaluationSample(dataset="d", index=i, raw_question=f"q{i}",
                                          exp_id="e1", correct=bool(i % 2)))
    assert db.count(ns.models.EvaluationSample, {"exp_id": "e1"}) == 3
    n = db.update(ns.models.EvaluationSample, {"index": 1}, {"response": "ans",
                                                             "stage": "rollout"})
    assert n == 1
    got = db.select(ns.models.EvaluationSample, where={"index": 1})
    assert got[0].response == "ans"
    return n, [row(r) for r in db.select(ns.models.EvaluationSample, order_by="_rowid ASC")]


def case_agent_trajectory_to_db(ns, tmp):
    """SimpleAgent trajectory sink → DBService row (the wiring the API uses)."""
    db = ns.service.DBService(url=f"sqlite:///{tmp}/traj.db")

    async def sink(record):
        db.add(ns.models.TrajectoryRecord.from_recorder_dict(record))

    agent = ns.simple.SimpleAgent(
        ns.AgentConfig(),
        client=ns.llm.FakeChatClient(scripted=[ns.llm.FakeChatClient.text_response("done")]),
        trajectory_sink=sink)
    asyncio.run(agent.run("task one"))
    rows = db.select(ns.models.TrajectoryRecord)
    assert rows and rows[0].input == "task one" and rows[0].output == "done"
    return [row(r, drop=("created_at", "trace_id")) for r in rows]


def traced_run(ns, db):
    ns.tracer.setup_tracing(db_service=db)
    try:
        t = ns.tracer.get_tracer()
        with t.trace("tr-fixed"):
            with t.span("tool", "kb_embedding_search", arguments='{"query": "x"}') as s:
                s.attributes["output"] = "result text"
            with t.span("generation", "agent", model="m1") as s:
                s.attributes["output"] = "hello"
                s.attributes["input_tokens"] = 5
            with t.span("retrieval", "search", query="x"):
                pass
    finally:
        ns.tracer.setup_tracing()  # detach


def case_tracing_db_sink(ns, tmp):
    db = ns.service.DBService(url=f"sqlite:///{tmp}/trace.db")
    traced_run(ns, db)
    rows = db.select(ns.models.ToolTraceRecord)
    assert rows and rows[0].name == "kb_embedding_search" and rows[0].trace_id == "tr-fixed"
    gen = db.select(ns.models.GenerationTraceRecord)
    assert gen and gen[0].trace_id == "tr-fixed" and gen[0].input_tokens == 5
    assert not ns.tracer.get_tracer().processors
    return ([row(r, SPAN_IDS) for r in rows], [row(r, SPAN_IDS) for r in gen],
            rows[0].trace_id)


def case_span_error_capture(ns, tmp):
    t = ns.tracer.get_tracer()
    try:
        with t.span("tool", "boom"):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    assert t.spans[-1].error == "x" and t.spans[-1].end_time is not None
    return t.spans[-1].error, t.spans[-1].kind, t.spans[-1].name


# ---------------------------------------------------------------------------
# tests/db/test_migrations.py
# ---------------------------------------------------------------------------


def case_old_schema_gains_missing_columns(ns, tmp):
    path = tmp / "old.db"
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE trajectories (_rowid INTEGER PRIMARY KEY AUTOINCREMENT, "
                 '"trace_id" TEXT, "input" TEXT)')
    conn.execute("INSERT INTO trajectories (trace_id, input) VALUES ('t1', 'hello')")
    conn.commit()
    conn.close()
    svc = ns.service.DBService(f"sqlite:///{path}")
    assert svc.available
    rows = svc.select(ns.models.TrajectoryRecord, where={"trace_id": "t1"})
    assert rows and rows[0].input == "hello"
    assert svc.add(ns.models.TrajectoryRecord(trace_id="t2", input="x", output="y"))
    assert svc.select(ns.models.TrajectoryRecord, where={"trace_id": "t2"})[0].output == "y"
    svc.close()
    conn = sqlite3.connect(path)
    cols = [r[1:3] for r in conn.execute("PRAGMA table_info(trajectories)")]
    conn.close()
    return row(rows[0], drop=()), cols


def case_migrate_table_is_idempotent(ns, tmp):
    path = tmp / "fresh.db"
    ns.service.DBService(f"sqlite:///{path}").close()
    conn = sqlite3.connect(path)
    before = ns.migrations.existing_columns(conn, "trajectories")
    assert ns.migrations.migrate_table(conn, "trajectories", ns.models.TrajectoryRecord) == []
    assert ns.migrations.existing_columns(conn, "trajectories") == before
    tables = {t: sorted(ns.migrations.existing_columns(conn, t)) for (t,) in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name != 'sqlite_sequence'")}
    conn.close()
    types_ = {cls.__name__: {f.name: ns.migrations.column_type(f)
                             for f in dataclasses.fields(cls)}
              for cls in (ns.models.TrajectoryRecord, ns.models.EvaluationSample,
                          ns.models.ToolTraceRecord, ns.models.GenerationTraceRecord)}
    return tables, types_


# ---------------------------------------------------------------------------
# tests/tracing/test_otlp.py
# ---------------------------------------------------------------------------


def emit_spans(ns):
    t = ns.tracer.get_tracer()
    t.spans.clear()
    with t.trace("tr-test"):
        with t.span("agent", "kb_agent", input="what is hbm?") as s:
            s.attributes["output"] = "answer"
        with t.span("generation", "kb_agent", model="encoder-x") as s:
            s.attributes["input_tokens"] = 12
            s.attributes["output_tokens"] = 34
            s.attributes["input_messages"] = [{"role": "user", "content": "q"}]
            s.attributes["output"] = "a"
        with t.span("tool", "kb_embedding_search", arguments='{"query": "x"}') as s:
            s.attributes["output"] = "3 hits"
        with t.span("retrieval", "search", query="hbm bandwidth") as s:
            s.attributes["documents"] = [{"id": "c1", "score": 0.9}]
    return list(t.spans[-4:])


def otlp_view(span_json):
    """An OTLP span without its ids and times."""
    return {k: v for k, v in span_json.items()
            if k not in ("traceId", "spanId", "parentSpanId", "startTimeUnixNano",
                         "endTimeUnixNano")}


def case_openinference_mapping(ns, tmp):
    o = ns.otlp
    agent, gen, tool, retr = emit_spans(ns)
    a = o.openinference_attributes(agent)
    assert a[o.SPAN_KIND] == "AGENT" and a[o.GRAPH_NODE_ID] == "kb_agent"
    g = o.openinference_attributes(gen)
    assert g[o.SPAN_KIND] == "LLM" and g[o.LLM_MODEL] == "encoder-x"
    assert g[o.LLM_TOKENS_PROMPT] == 12 and g[o.LLM_TOKENS_COMPLETION] == 34
    assert json.loads(g["input.value"]) == [{"role": "user", "content": "q"}]
    t = o.openinference_attributes(tool)
    assert t[o.SPAN_KIND] == "TOOL" and t[o.TOOL_NAME] == "kb_embedding_search"
    r = o.openinference_attributes(retr)
    assert r[o.SPAN_KIND] == "RETRIEVER" and "hbm" in r["input.value"]
    return [o.openinference_attributes(s) for s in (agent, gen, tool, retr)]


def case_otlp_span_shape(ns, tmp):
    o = ns.otlp
    spans = emit_spans(ns)
    j = o.span_to_otlp(spans[1])
    assert len(j["traceId"]) == 32 and len(j["spanId"]) == 16
    assert int(j["endTimeUnixNano"]) >= int(j["startTimeUnixNano"])
    keys = {a["key"] for a in j["attributes"]}
    assert o.SPAN_KIND in keys and o.LLM_MODEL in keys
    tok = next(a for a in j["attributes"] if a["key"] == o.LLM_TOKENS_PROMPT)
    assert tok["value"] == {"intValue": "12"}
    assert j["status"] == {"code": 1}
    payload = json.loads(json.dumps(o.OTLPJsonExporter("http://phx:6006").to_payload(spans)))
    rs = payload["resourceSpans"][0]
    assert rs["resource"]["attributes"][0]["key"] == "openinference.project.name"
    assert len(rs["scopeSpans"][0]["spans"]) == 4
    assert rs["scopeSpans"][0]["scope"]["name"] == ns.tracer.__name__.rsplit(".", 1)[0]
    # the same span ids hash to the same OTLP ids on both packages
    assert o._hex_id("sp-abc", 8) == jax_otlp._hex_id("sp-abc", 8)
    return (rs["resource"], [otlp_view(s) for s in rs["scopeSpans"][0]["spans"]],
            "parentSpanId" in j)


def case_error_span_status(ns, tmp):
    t = ns.tracer.get_tracer()
    try:
        with t.span("tool", "boom"):
            raise ValueError("kaput")
    except ValueError:
        pass
    j = ns.otlp.span_to_otlp(t.spans[-1])
    assert j["status"] == {"code": 2, "message": "kaput"}
    return otlp_view(j)


def case_processor_batches_and_degrades(ns, tmp):
    sent = []
    proc = ns.otlp.OTLPProcessor("http://collector:4318", batch_size=2)
    proc.exporter._post = lambda url, body: sent.append((url, json.loads(body))) or True
    spans = emit_spans(ns)
    for s in spans[:3]:
        proc.on_span_end(s)
    assert len(sent) == 1
    assert proc.flush()
    assert len(sent) == 2 and sent[0][0].endswith("/v1/traces")
    # an unreachable collector degrades to a warning, never raises; the post
    # fails before it leaves the process
    bad = ns.otlp.OTLPProcessor("http://127.0.0.1:1", batch_size=1)

    def refuse(url, body):
        raise ConnectionError("connection refused")

    bad.exporter._post = refuse
    bad.on_span_end(spans[0])
    assert bad.flush() is True  # nothing left to send
    assert bad.exporter._warned
    return [(url, [[otlp_view(s) for s in rs["scopeSpans"][0]["spans"]]
                   for rs in body["resourceSpans"]]) for url, body in sent]


def case_setup_tracing_installs_otlp(ns, tmp):
    t = ns.tracer.setup_tracing(otlp_endpoint="http://phx:6006", console=True)
    names = [type(p).__name__ for p in t.processors]
    t.processors.clear()
    assert "OTLPProcessor" in names
    return names


CASES = [case_noop_mode_is_safe, case_add_select_roundtrip, case_update_and_count,
         case_agent_trajectory_to_db, case_tracing_db_sink, case_span_error_capture,
         case_old_schema_gains_missing_columns, case_migrate_table_is_idempotent,
         case_openinference_mapping, case_otlp_span_shape, case_error_span_status,
         case_processor_batches_and_degrades, case_setup_tracing_installs_otlp]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_case_matches_jax(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = case(package(jax=False), tmp_path / "port")
    want = case(package(jax=True), tmp_path / "jax")
    assert got == want


@pytest.mark.parametrize("writer, reader", [(True, False), (False, True)],
                         ids=["jax_writes", "port_writes"])
def test_db_files_read_across_packages(tmp_path, writer, reader):
    """A trajectory DB one package writes, the other reads row for row."""
    w, r = package(writer), package(reader)
    db = w.service.DBService(f"sqlite:///{tmp_path}/x.db")
    db.add(w.models.TrajectoryRecord("t1", "q", output="a", trajectory=[{"role": "user"}]))
    db.add(w.models.ToolTraceRecord("t1", "s1", "tool", "{}", "out", 1.5))
    db.add(w.models.GenerationTraceRecord("t1", "s2", "m", [{"role": "user"}], "hi", 3, 4, 2.0))
    db.add(w.models.EvaluationSample("d", 0, correct=True, reward=0.5))
    db.close()
    other = r.service.DBService(f"sqlite:///{tmp_path}/x.db")
    for cls_name in ("TrajectoryRecord", "ToolTraceRecord", "GenerationTraceRecord",
                     "EvaluationSample"):
        got = other.select(getattr(r.models, cls_name))
        want = w.service.DBService(f"sqlite:///{tmp_path}/x.db").select(
            getattr(w.models, cls_name))
        assert [dataclasses.asdict(x) for x in got] == [dataclasses.asdict(x) for x in want]
        assert len(got) == 1


def test_db_tracing_processor_records_an_agent_run(tmp_path):
    """setup_tracing(db_service=...) over a SimpleAgent run with a tool: the
    same tool and generation rows on both packages."""
    out = []
    for ns in (package(False), package(True)):
        db = ns.service.DBService(f"sqlite:///{tmp_path}/{len(out)}.db")
        ns.tracer.setup_tracing(db_service=db)
        try:
            from youtu_rag_tpu_torch.tools.base import AsyncBaseToolkit as PortToolkit
            from youtu_rag_tpu_torch.tools.base import register_tool as port_register
            from youtu_rag_tpu.tools.base import AsyncBaseToolkit as JaxToolkit
            from youtu_rag_tpu.tools.base import register_tool as jax_register

            base, reg = (PortToolkit, port_register) if not out else (JaxToolkit, jax_register)

            class Echo(base):
                @reg
                async def echo(self, text: str) -> str:
                    """Echo the text.

                    Args:
                        text: The text.
                    """
                    return f"echo: {text}"

            fake = ns.llm.FakeChatClient
            agent = ns.simple.SimpleAgent(ns.AgentConfig(), client=fake(scripted=[
                fake.tool_response("echo", {"text": "hi"}), fake.text_response("done")]),
                toolkits=[Echo()])
            with ns.tracer.get_tracer().trace("tr-run"):
                asyncio.run(agent.run("say hi"))
        finally:
            ns.tracer.setup_tracing()
        out.append(([row(r, SPAN_IDS) for r in db.select(ns.models.ToolTraceRecord)],
                    [row(r, SPAN_IDS) for r in db.select(ns.models.GenerationTraceRecord)],
                    {r.trace_id for r in db.select(ns.models.ToolTraceRecord)}))
    assert out[0] == out[1]
    tools, gens, traces = out[0]
    assert [t["output"] for t in tools] == ["echo: hi"] and len(gens) == 2
    assert traces == {"tr-run"}
