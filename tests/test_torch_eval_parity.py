"""The port's eval harness against the JAX package's, on the CPU, over one
corpus of fact documents built into a KB on each package (the C hash
embedder on both):

- ``RetrievalBenchmark`` (Recall@all, recall@5, NDCG_w@5, MRR) on the
  dense and the hybrid retriever, plain and filtered qrels: the same
  report and the same retrieved documents per query;
- ``BaseBenchmark`` as ``run_eval`` drives it, over a jsonl of the fact
  questions with their values: a ``simple`` agent with the KB-search
  toolkit, a scripted model (one search, then the value its top hit
  states) and the ``exact_match`` processor. The same stats (but the host
  clock's ``avg_time_cost``), every sample judged in the sqlite DB;
- ``python -m youtu_rag_tpu_torch.run_eval`` runs on ``--device cpu`` and,
  without ``--device`` on a host without CUDA, refuses.

Tolerance: none; metrics are compared as computed, documents and answers
as text."""

import asyncio
import json
import re

import numpy as np
import pytest
import torch

import youtu_rag_tpu.agents.llm as jax_llm
import youtu_rag_tpu.db.models as jax_models
import youtu_rag_tpu.db.service as jax_service
import youtu_rag_tpu.eval.benchmark as jax_benchmark
import youtu_rag_tpu.eval.config as jax_eval_config
import youtu_rag_tpu.eval.retrieval_eval as jax_retrieval_eval
import youtu_rag_tpu_torch.agents.llm as llm
import youtu_rag_tpu_torch.db.models as models
import youtu_rag_tpu_torch.db.service as service
import youtu_rag_tpu_torch.eval.benchmark as benchmark
import youtu_rag_tpu_torch.eval.config as eval_config
import youtu_rag_tpu_torch.eval.retrieval_eval as retrieval_eval
from youtu_rag_tpu.agents.config import AgentConfig as JaxAgentConfig
from youtu_rag_tpu.agents.simple_agent import SimpleAgent as JaxSimpleAgent
from youtu_rag_tpu.core.config import RAGConfig as JaxRAGConfig
from youtu_rag_tpu.retrieval.kb import KnowledgeBase as JaxKB
from youtu_rag_tpu.tools.base import ToolkitConfig as JaxToolkitConfig
from youtu_rag_tpu_torch import run_eval
from youtu_rag_tpu_torch.agents.config import AgentConfig
from youtu_rag_tpu_torch.agents.simple_agent import SimpleAgent
from youtu_rag_tpu_torch.core.config import RAGConfig
from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
from youtu_rag_tpu_torch.tools.base import ToolkitConfig
from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

N_DOCS = 24
SYLLABLES = ["ka", "lo", "mi", "ren", "sa", "tu", "vo", "zel", "bri", "dan", "fe", "gor"]


def word(rng, n: int) -> str:
    return "".join(rng.choice(SYLLABLES, size=n))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``N_DOCS`` markdown files, each with one fact sentence ("The <attr>
    of <entity> is <value>.") over filler of a shared vocabulary; returns
    (file paths, [(file name, question, value)])."""
    root = tmp_path_factory.mktemp("facts")
    rng = np.random.default_rng(18)
    vocab = sorted({word(rng, 2) for _ in range(300)})
    facts, paths = [], []
    for i in range(N_DOCS):
        name, ent, attr = f"doc{i:02d}.md", f"{word(rng, 3).capitalize()}", f"{word(rng, 3)} index"
        value = str(int(rng.integers(10_000, 100_000)))
        filler = " ".join(" ".join(rng.choice(vocab, size=12)).capitalize() + "." for _ in range(20))
        (root / name).write_text(f"# {ent}\n\nThe {attr} of {ent} is {value}.\n\n{filler}\n")
        facts.append((name, f"What is the {attr} of {ent}?", value))
        paths.append(str(root / name))
    return paths, facts


@pytest.fixture(scope="module")
def kbs(corpus, jax_lib):
    paths, _ = corpus
    port = KnowledgeBase("evalkb", RAGConfig(name="evalkb"), device="cpu")
    jax_kb = JaxKB("evalkb", JaxRAGConfig(name="evalkb"))
    port.embedder._use_native = jax_kb.embedder._use_native = True
    got = asyncio.run(port.build_files(paths))
    want = asyncio.run(jax_kb.build_files(paths))
    assert got.total_chunks == want.total_chunks >= N_DOCS
    return port, jax_kb


def qrels(facts) -> list[dict]:
    rows = [{"query": q, "relevant": [name]} for name, q, _ in facts]
    # a filtered query runs the retriever's filtered path, one query at a time
    name, q, _ = facts[0]
    rows.append({"query": q, "relevant": [name], "filters": {"document_id": name}})
    return rows


@pytest.mark.parametrize("hybrid", [False, True], ids=["dense", "hybrid"])
def test_retrieval_benchmark_matches_jax(kbs, corpus, hybrid):
    port, jax_kb = kbs
    rows = qrels(corpus[1])
    got_bench = retrieval_eval.RetrievalBenchmark(port, top_k=5, use_hybrid=hybrid)
    want_bench = jax_retrieval_eval.RetrievalBenchmark(jax_kb, top_k=5, use_hybrid=hybrid)
    got_samples, want_samples = got_bench.load_qrels(rows), want_bench.load_qrels(rows)
    got = asyncio.run(got_bench.run(got_samples))
    want = asyncio.run(want_bench.run(want_samples))
    assert got == want
    assert [s.retrieved for s in got_samples] == [s.retrieved for s in want_samples]
    assert got["samples"] == N_DOCS + 1 and got["recall_at_all"] > 0.9


def answer_rule(fake):
    """A scripted model over ``fake`` (a package's ``FakeChatClient``):
    search the KB for the question, then answer with the value the top
    hit's fact sentence states."""

    def rule(messages, tools):
        last = messages[-1]
        if last.role != "tool":
            question = next(m.content for m in reversed(messages) if m.role == "user")
            return fake.tool_response("kb_embedding_search", {"query": question, "top_k": 3})
        m = re.search(r"The .+? of .+? is (\d+)\.", last.content or "")
        return fake.text_response(f"The value is {m.group(1)}." if m else "I do not know.")

    return rule


def data_file(tmp_path, facts) -> str:
    path = tmp_path / "facts.jsonl"
    path.write_text("".join(json.dumps({"question": q, "answer": v}) + "\n" for _, q, v in facts))
    return str(path)


def test_base_benchmark_matches_jax(kbs, corpus, tmp_path):
    port, jax_kb = kbs
    facts = corpus[1]
    data = data_file(tmp_path, facts)
    stats = {}
    for name, pkg in (("port", (llm, models, service, benchmark, eval_config, AgentConfig,
                                SimpleAgent, ToolkitConfig, port)),
                      ("jax", (jax_llm, jax_models, jax_service, jax_benchmark, jax_eval_config,
                               JaxAgentConfig, JaxSimpleAgent, JaxToolkitConfig, jax_kb))):
        llm_, models_, service_, bench_, cfg_, AC, SA, TC, kb = pkg
        agent_cfg = AC(toolkits={"kb_search": TC(name="kb_search", config={"kb": kb})})
        agent = SA(agent_cfg, client=llm_.FakeChatClient(rule_fn=answer_rule(llm_.FakeChatClient)))
        db = service_.DBService(f"sqlite:///{tmp_path}/{name}.db")
        config = cfg_.EvalConfig(exp_id="facts", processor="exact_match",
                                 data=cfg_.EvalDataConfig(dataset="facts", source=data))
        stats[name] = asyncio.run(bench_.BaseBenchmark(config, agent=agent, db=db).main())
        assert db.count(models_.EvaluationSample, {"stage": "judged"}) == len(facts)
    for s in stats.values():
        s.pop("avg_time_cost")
    assert stats["port"] == stats["jax"]
    assert stats["port"]["judged"] == len(facts) and stats["port"]["accuracy"] > 0.9


def test_run_eval_entry_point(kbs, corpus, tmp_path, capsys, monkeypatch):
    port, _ = kbs
    data = data_file(tmp_path, corpus[1])
    cfg = AgentConfig(toolkits={"kb_search": ToolkitConfig(name="kb_search", config={"kb": port})})
    agent = SimpleAgent(cfg, client=llm.FakeChatClient(rule_fn=answer_rule(llm.FakeChatClient)),
                        device="cpu")
    db = service.DBService(f"sqlite:///{tmp_path}/run_eval.db")
    argv = ["--data", data, "--exp-id", "cli", "--processor", "exact_match", "--device", "cpu"]
    stats = asyncio.run(run_eval.main(argv, agent=agent, db=db))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == stats
    assert stats["judged"] == len(corpus[1]) and stats["exp_id"] == "cli"
    assert db.count(models.EvaluationSample, {"stage": "judged", "exp_id": "cli"}) == len(corpus[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(run_eval.main(["--data", data]))
