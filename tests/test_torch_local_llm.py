"""The port's ``LocalChatClient`` (``youtu_rag_tpu_torch/agents/local_llm.py``)
on the CPU: the JAX package's ``tests/agents/test_local_llm.py`` cases on
the port, and the same replies as JAX's ``LocalChatClient`` on the same
weights (a tiny random llama decoder with a byte-level vocabulary, and the
committed ``yrt_tiny_chat`` through ``weights_dir``).

Tolerance: none. Greedy replies, token counts and rendered prompts are
equal; both clients serve their matmul weights in bf16."""

import asyncio
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.agents.llm import ChatMessage as JaxMessage
from youtu_rag_tpu.agents.local_llm import LocalChatClient as JaxClient
from youtu_rag_tpu.agents.local_llm import render_chat as jax_render
from youtu_rag_tpu.models.bpe import BPETokenizer as JaxBPE
from youtu_rag_tpu.models.decoder import DecoderConfig as JaxConfig
from youtu_rag_tpu.models.decoder import init_decoder_params
from youtu_rag_tpu_torch.agents.llm import ChatMessage, get_chat_client
from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient, _bucket, render_chat
from youtu_rag_tpu_torch.models.bpe import BPETokenizer, bytes_to_unicode
from youtu_rag_tpu_torch.models.convert import decoder_params_from_numpy
from youtu_rag_tpu_torch.models.decoder import DecoderConfig
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

CHAT = Path(__file__).resolve().parent.parent / "benchmarks" / "models" / "yrt_tiny_chat"
KW = dict(vocab_size=320, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_len=128,
          arch="llama", eos_token_id=256)


def byte_tokenizer(cls):
    """A merge-free byte-level vocabulary: every byte one token, and EOS."""
    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode().values())}
    vocab["<|endoftext|>"] = 256
    return cls(vocab, [], scheme="byte_level", added_tokens={"<|endoftext|>": 256},
               eos_token="<|endoftext|>")


@pytest.fixture(scope="module")
def pair():
    """(port client, JAX client) on the same random weights, f32 compute."""
    jcfg = JaxConfig(dtype=jnp.float32, **KW)
    jparams = init_decoder_params(jcfg, seed=0)
    cfg = DecoderConfig(dtype=torch.float32, **KW)
    params = decoder_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    port = LocalChatClient(params=params, cfg=cfg, tokenizer=byte_tokenizer(BPETokenizer),
                           template="plain", max_new_tokens=16, device="cpu")
    jax_client = JaxClient(params=jparams, cfg=jcfg, tokenizer=byte_tokenizer(JaxBPE),
                           template="plain", max_new_tokens=16)
    return port, jax_client


@pytest.fixture(scope="module")
def client(pair):
    return pair[0]


def test_chat_returns_text_and_usage(client):
    resp = asyncio.run(client.chat([ChatMessage(role="user", content="hi")]))
    assert resp.message.role == "assistant"
    assert isinstance(resp.message.content, str)
    assert resp.usage.input_tokens > 0
    assert 0 <= resp.usage.output_tokens <= 16


@pytest.mark.parametrize("text", ["hi", "same prompt", "q3", "a longer question about KB"])
def test_chat_matches_jax(pair, text):
    port, jax_client = pair
    got = asyncio.run(port.chat([ChatMessage(role="user", content=text)]))
    want = asyncio.run(jax_client.chat([JaxMessage(role="user", content=text)]))
    assert got.message.content == want.message.content
    assert (got.usage.input_tokens, got.usage.output_tokens) == (want.usage.input_tokens,
                                                                 want.usage.output_tokens)


def test_serving_weights_are_bf16(client):
    assert client.params["layers"]["wqkv"].dtype == torch.bfloat16
    assert client.params["layers"]["ln1_scale"].dtype == torch.float32
    assert client.device == torch.device("cpu")


def test_chat_deterministic_at_temperature_zero(client):
    msgs = [ChatMessage(role="user", content="same prompt")]
    r1 = asyncio.run(client.chat(msgs))
    r2 = asyncio.run(client.chat(msgs))
    assert r1.message.content == r2.message.content


def test_sampling_is_seeded(pair):
    """temperature > 0 draws from the client's torch.Generator: two clients
    with one seed reply alike."""
    port = pair[0]
    twins = [LocalChatClient(params=port.params, cfg=port.cfg, tokenizer=port.tokenizer,
                             template="plain", max_new_tokens=16, temperature=1.0, top_k=20,
                             seed=3, device="cpu") for _ in range(2)]
    msgs = [ChatMessage(role="user", content="sample")]
    assert len({asyncio.run(c.chat(msgs)).message.content for c in twins}) == 1


def test_stream_chat_deltas_end_with_done(client):
    async def run():
        return [d async for d in client.stream_chat([ChatMessage(role="user", content="go")])]

    events = asyncio.run(run())
    assert events[-1].type == "done"
    text = "".join(e.text for e in events if e.type == "text_delta")
    assert text == (events[-1].response.message.content or "")
    assert all(len(e.text) <= 48 for e in events if e.type == "text_delta")


def test_tools_rejected_use_react_wrapper(client):
    with pytest.raises(ValueError, match="ReactChatClient"):
        asyncio.run(client.chat([ChatMessage(role="user", content="x")],
                                tools=[{"type": "function", "function": {"name": "f"}}]))


def test_react_wrapper_composes(client):
    from youtu_rag_tpu_torch.agents.react import ReactChatClient

    resp = asyncio.run(ReactChatClient(client).chat(
        [ChatMessage(role="user", content="x")],
        tools=[{"type": "function", "function": {"name": "f", "description": "d",
                                                 "parameters": {}}}]))
    assert resp.message.role == "assistant"


def test_concurrent_chats_serialize(client):
    async def run():
        return await asyncio.gather(*[client.chat([ChatMessage(role="user", content=f"q{i}")])
                                      for i in range(4)])

    out = asyncio.run(run())
    assert len(out) == 4 and all(r.message.role == "assistant" for r in out)


def test_get_chat_client_local_dispatch(tmp_path, monkeypatch):
    from youtu_rag_tpu_torch.agents import local_llm
    from youtu_rag_tpu_torch.agents.react import ReactChatClient

    built = {}

    def fake_init(self, weights_dir=None, **kw):
        built["dir"], built["kw"] = weights_dir, kw

    monkeypatch.setattr(local_llm.LocalChatClient, "__init__", fake_init)
    c = get_chat_client({"provider": "local", "weights_dir": str(tmp_path), "max_tokens": 64},
                        device="cpu")
    assert isinstance(c, ReactChatClient) and isinstance(c.inner, local_llm.LocalChatClient)
    assert built["dir"] == str(tmp_path)
    assert built["kw"]["max_new_tokens"] == 64 and built["kw"]["device"] == "cpu"


def test_render_chat_templates_match_jax():
    msgs = [("system", "be brief"), ("user", "hello"), ("assistant", "hi"), ("user", "again")]
    for template in ("plain", "chatml", "llama"):
        got = render_chat([ChatMessage(role=r, content=c) for r, c in msgs], template)
        assert got == jax_render([JaxMessage(role=r, content=c) for r, c in msgs], template)
    plain = render_chat([ChatMessage(role="user", content="hello")], "plain")
    assert plain.endswith("assistant:")
    assert [_bucket(n) for n in (1, 16, 17, 100, 256)] == [16, 16, 32, 128, 256]


def test_template_detection(client):
    chatml = byte_tokenizer(BPETokenizer)
    chatml.added["<|im_start|>"] = 300
    c = LocalChatClient(params=client.params, cfg=client.cfg, tokenizer=chatml, device="cpu")
    assert c.template == "chatml" and client.template == "plain"


def test_stop_strings_cut_generation(client):
    c = LocalChatClient(params=client.params, cfg=client.cfg, tokenizer=client.tokenizer,
                        template="plain", max_new_tokens=16, stop=["\nuser:"], device="cpu")
    resp = asyncio.run(c.chat([ChatMessage(role="user", content="hi")]))
    assert "\nuser:" not in (resp.message.content or "")


def test_max_new_tokens_clamped_to_context(client):
    resp = asyncio.run(client.chat([ChatMessage(role="user", content="hi")], max_tokens=4096))
    assert resp.usage.output_tokens <= client.cfg.max_len // 2


def test_cuda_by_default(client, monkeypatch):
    """Without ``device`` the client takes the CUDA card, and a host
    without one refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalChatClient(params=client.params, cfg=client.cfg, tokenizer=client.tokenizer)


def test_weights_dir_serves_tiny_chat_as_jax():
    """``yrt_tiny_chat`` through ``weights_dir`` (bf16, the plain template):
    the same turn-1 reply as JAX's client, the ReAct action it was trained
    to emit."""
    from youtu_rag_tpu.models.lm_synth import DEFAULT_KB_INSTRUCTIONS

    port = LocalChatClient(CHAT, max_new_tokens=64, device="cpu")
    jax_client = JaxClient(CHAT, max_new_tokens=64)
    assert port.template == jax_client.template == "plain"
    question = "What is the color of Zoka?"
    got = asyncio.run(port.chat([ChatMessage("system", DEFAULT_KB_INSTRUCTIONS),
                                 ChatMessage("user", question)]))
    want = asyncio.run(jax_client.chat([JaxMessage("system", DEFAULT_KB_INSTRUCTIONS),
                                        JaxMessage("user", question)]))
    assert got.message.content == want.message.content
    assert got.usage.output_tokens == want.usage.output_tokens
