"""The port's meta generators (``youtu_rag_tpu_torch/meta/``) and their
entry points: the cases of ``tests/test_meta.py`` on the port
(``tests/torch_port_cases.py``), plus the generated toolkit's base class
and the two entries, ``gen_simple_agent`` and ``gen_tool``, with a
scripted model."""

import asyncio

import pytest

from torch_port_cases import port_cases

globals().update(port_cases("test_meta.py"))

from youtu_rag_tpu_torch.agents.llm import FakeChatClient  # noqa: E402
from youtu_rag_tpu_torch.agents.llm_agent import LLMAgent  # noqa: E402
from youtu_rag_tpu_torch.meta import generators  # noqa: E402


def scripted(*texts):
    return LLMAgent(client=FakeChatClient(scripted=[FakeChatClient.text_response(t)
                                                    for t in texts]))


def test_tool_prompt_names_the_port():
    assert "youtu_rag_tpu_torch.tools.base" in generators.TOOL_GEN_PROMPT
    assert "youtu_rag_tpu.tools" not in generators.TOOL_GEN_PROMPT


def test_generated_toolkit_subclasses_the_port_base():
    from youtu_rag_tpu_torch.tools.base import AsyncBaseToolkit

    _, cls = asyncio.run(generators.ToolGenerator(scripted(GOOD_TOOL_SOURCE)).generate("x"))
    assert issubclass(cls, AsyncBaseToolkit)
    assert cls.__mro__[1].__module__ == "youtu_rag_tpu_torch.tools.base"


def test_gen_simple_agent_entry(tmp_path, capsys):
    from youtu_rag_tpu_torch import gen_simple_agent
    from youtu_rag_tpu_torch.core.loader import ConfigLoader

    out = tmp_path / "agent.yaml"
    cfg = asyncio.run(gen_simple_agent.main(["a kb helper", "--out", str(out)],
                                            llm_agent=scripted(GOOD_AGENT_YAML)))
    assert cfg.agent.name == "kb_helper"
    assert ConfigLoader(tmp_path).load_agent_config(out.name).agent.name == "kb_helper"
    assert "wrote" in capsys.readouterr().out


def test_gen_tool_entry(tmp_path):
    from youtu_rag_tpu_torch import gen_tool

    out = tmp_path / "wc.py"
    cls = asyncio.run(gen_tool.main(["word counting", "--out", str(out), "--retries", "1"],
                                    llm_agent=scripted("not python", GOOD_TOOL_SOURCE)))
    assert out.read_text() == GOOD_TOOL_SOURCE.strip()
    assert asyncio.run(cls().call_tool("count_words", {"text": "a b"})) == "2"


@pytest.mark.parametrize("entry", ["gen_simple_agent", "gen_tool"])
def test_entries_default_to_cuda(entry, monkeypatch, tmp_path):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"youtu_rag_tpu_torch.{entry}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(mod.main(["x", "--out", str(tmp_path / "o")]))
