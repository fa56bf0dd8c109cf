"""The port's causal-LM trainer (``models/train_lm.py``, the decoder's
``remat``, ``train_chat_lm``) against the JAX package's, on the CPU.

Tolerances (f32 unless named): ``lm_loss`` within 1e-5 relative, with and
without label smoothing; first-step gradients within 1e-5 of each leaf's
largest (the port's fused ``wqkv`` against JAX's ``wq``, ``wk``, ``wv``
side by side); losses over 5 steps within 1e-5 relative; parameters after
5 steps within 1e-4 absolute (the bound and its reason as in
``tests/test_torch_train.py``: Adam turns a near-zero gradient's rounding
into a direction).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from youtu_rag_tpu.models import decoder as jax_decoder
from youtu_rag_tpu.models import train_lm as jax_lm
from youtu_rag_tpu_torch.models import decoder as port_decoder
from youtu_rag_tpu_torch.models import train_lm as port_lm
from youtu_rag_tpu_torch.models.convert import decoder_params_from_numpy
from torch_native_helpers import jax_tracer_restored, torch_one_thread  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored", "torch_one_thread")

TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
            max_len=32, arch="llama", eos_token_id=1)


def configs(**over):
    kw = {**TINY, **over}
    return (jax_decoder.DecoderConfig(**kw, dtype=jnp.float32),
            port_decoder.DecoderConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jax.jit(lambda: jax_decoder.init_decoder_params(jcfg, 0))())


def batch(seed: int, b: int = 4, t: int = 32) -> dict:
    """Right-padded rows with a prompt and a completion span."""
    r = np.random.default_rng(seed)
    tokens = r.integers(2, TINY["vocab_size"], (b, t)).astype(np.int32)
    n = r.integers(t // 2, t + 1, b)
    p = r.integers(2, t // 2, b)
    pos = np.arange(t)[None]
    mask = (pos < n[:, None]).astype(np.float32)
    return {"tokens": np.where(mask > 0, tokens, 1).astype(np.int32), "mask": mask,
            "loss_mask": ((pos >= p[:, None]) & (pos < n[:, None])).astype(np.float32)}


def port_grads_as_jax(params, grads, cfg):
    """The port's gradients in JAX's layout (wqkv split), by path."""
    from youtu_rag_tpu_torch.models.train import leaf_names

    tree = {"layers": {}}
    for n, g in zip(leaf_names(params), grads):
        node = tree
        *parents, leaf = n.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = g
    return port_lm.split_qkv(tree, cfg)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_loss_matches_jax(tree, smoothing):
    jcfg, pcfg = configs()
    jtc = jax_lm.LMTrainConfig(label_smoothing=smoothing, remat=False)
    ptc = port_lm.LMTrainConfig(label_smoothing=smoothing, remat=False)
    b = batch(0)
    want = jax_lm.lm_loss(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, b), jcfg, jtc)
    got = port_lm.lm_loss(decoder_params_from_numpy(tree, pcfg),
                          {k: torch.from_numpy(v) for k, v in b.items()}, pcfg, ptc)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_label_smoothing_is_optax_smooth_labels():
    """``F.cross_entropy(label_smoothing=a)`` is optax's ``smooth_labels``
    followed by ``softmax_cross_entropy``, per row."""
    r = np.random.default_rng(3)
    logits = r.normal(size=(6, 11)).astype(np.float32) * 3
    labels = r.integers(0, 11, 6)
    for a in (0.0, 0.1, 0.5):
        want = optax.softmax_cross_entropy(
            jnp.asarray(logits), optax.smooth_labels(jax.nn.one_hot(labels, 11), a))
        got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              reduction="none", label_smoothing=a)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_lm_train_step_matches_jax(tree):
    jcfg, pcfg = configs()
    jtc = jax_lm.LMTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                               label_smoothing=0.1, remat=True)
    ptc = port_lm.LMTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                                label_smoothing=0.1, remat=True)
    jp = jax.tree.map(jnp.asarray, tree)
    pp = decoder_params_from_numpy(tree, pcfg)

    jg = jax.jit(jax.grad(jax_lm.lm_loss), static_argnums=(2, 3))(jp, batch(0), jcfg, jtc)
    from youtu_rag_tpu_torch.models.train import as_batch, value_and_grad

    _, pg = value_and_grad(lambda p, b: (port_lm.lm_loss(p, b, pcfg, ptc), None), pp,
                           as_batch(batch(0), "cpu"))
    got, want = flat(port_grads_as_jax(pp, pg, pcfg)), flat(jg)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = max(float(np.abs(want[name]).max()), 1e-12)
        np.testing.assert_allclose(g, want[name], rtol=0, atol=1e-5 * scale, err_msg=name)

    jopt, popt = jax_lm.make_lm_optimizer(jtc), port_lm.make_lm_optimizer(ptc)
    js, ps = jopt.init(jp), popt.init(pp)
    jstep = jax_lm.make_lm_train_step(jcfg, jtc, jopt)
    pstep = port_lm.make_lm_train_step(pcfg, ptc, popt)
    for i in range(5):
        jp, js, jm = jstep(jp, js, batch(i))
        pp, ps, pm = pstep(pp, ps, batch(i))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    got, want = flat(port_lm.split_qkv(pp, pcfg)), flat(jp)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)


def test_remat_changes_no_gradient_and_no_logit(tree):
    _, pcfg = configs()
    from youtu_rag_tpu_torch.models.train import as_batch, value_and_grad

    pp = decoder_params_from_numpy(tree, pcfg)
    b = as_batch(batch(2), "cpu")
    grads = []
    for remat in (False, True):
        tc = port_lm.LMTrainConfig(remat=remat)
        _, g = value_and_grad(lambda p, x: (port_lm.lm_loss(p, x, pcfg, tc), None), pp, b)
        grads.append(g)
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(
            port_decoder.causal_logits(pp, b["tokens"], b["mask"], pcfg, remat=True),
            port_decoder.causal_logits(pp, b["tokens"], b["mask"], pcfg), rtol=0, atol=0)


def test_split_qkv_gives_jax_layout(tree):
    _, pcfg = configs(qkv_bias=True)
    jcfg, _ = configs(qkv_bias=True)
    full = jax.tree.map(np.asarray, jax.jit(lambda: jax_decoder.init_decoder_params(jcfg, 1))())
    full["layers"]["bq"] = np.random.default_rng(0).normal(size=full["layers"]["bq"].shape)
    split = flat(port_lm.split_qkv(decoder_params_from_numpy(full, pcfg), pcfg))
    want = flat(full)
    assert sorted(split) == sorted(want)
    for name in want:
        np.testing.assert_allclose(split[name], want[name].astype(np.float32), rtol=0, atol=0)


def test_encode_and_pack_match_jax():
    from youtu_rag_tpu.models.bpe import train_bpe as jax_train_bpe
    from youtu_rag_tpu_torch.models.bpe import train_bpe

    texts = ["The color of Zoka is teal.", "Thought: look it up\nAction: kb_search"] * 4
    jtok, ptok = jax_train_bpe(texts, vocab_size=300), train_bpe(texts, vocab_size=300)
    samples = [("The color of Zoka is", " teal."), ("Thought: look it up " * 6, "Action: x")]
    want = jax_lm.encode_samples(samples, jtok, 24, jtok.eos_id)
    got = port_lm.encode_samples(samples, ptok, 24, ptok.eos_id)
    assert [(a.tolist(), n) for a, n in got] == [(a.tolist(), n) for a, n in want]
    jb, pb = jax_lm.pack_batch(want, 24, jtok.eos_id), port_lm.pack_batch(got, 24, ptok.eos_id)
    for key in jb:
        assert np.array_equal(jb[key], pb[key]), key


def test_train_chat_lm_end_to_end(tmp_path, capsys):
    """A few steps on the CPU; the outputs load into LocalChatClient, the
    JAX package's loader and ``cli_chat --llm-weights-dir``."""
    import asyncio

    from youtu_rag_tpu.models.pretrained import load_pretrained_decoder as jax_load
    from youtu_rag_tpu_torch import cli_chat, train_chat_lm
    from youtu_rag_tpu_torch.agents.llm import ChatMessage
    from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient

    out = tmp_path / "lm"
    losses = []
    report = train_chat_lm.main(
        ["--steps", "4", "--batch", "2", "--layers", "1", "--d-model", "32", "--heads", "2",
         "--d-ff", "64", "--vocab-size", "300", "--tokenizer-episodes", "6", "--max-len", "512",
         "--eval-episodes", "2", "--warmup", "1", "--out", str(out), "--device", "cpu"],
        on_step=lambda s, p, o, m: losses.append(float(m["loss"])))
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert report["max_len"] == 512 and report["vocab"] % 128 == 0 and report["evals"]
    assert sorted(p.name for p in out.iterdir()) == [
        "decoder_config.json", "decoder_params.npz", "tokenizer.json", "train_report.json"]
    with np.load(out / "decoder_params.npz") as z:
        assert z["layers/wq"].dtype == np.float16 and "layers/wqkv" not in z.files
    jparams, jcfg = jax_load(out)
    assert jcfg.vocab_size == report["vocab"] and sorted(jparams["layers"]) == [
        "ln1_scale", "ln2_scale", "w1", "w2", "w_gate", "wk", "wo", "wq", "wv"]
    client = LocalChatClient(str(out), device="cpu", max_new_tokens=4)
    reply = asyncio.run(client.chat([ChatMessage(role="user", content="What is the color?")]))
    assert reply.message is not None
    facts = tmp_path / "facts"
    facts.mkdir()
    (facts / "a.md").write_text("The color of Zoka is teal.")
    assert json.loads((out / "train_report.json").read_text())["steps"] == 4
    capsys.readouterr()
    import io
    import sys

    stdin = sys.stdin
    sys.stdin = io.StringIO("What is the color of Zoka?\n")
    try:
        asyncio.run(cli_chat.main(["--paths", str(facts), "--llm-weights-dir", str(out),
                                   "--device", "cpu"]))
    finally:
        sys.stdin = stdin
    assert "agentic mode" in capsys.readouterr().out


def test_bpe_word_split_matches_jax():
    """The byte-level tokenizer's GPT-2 split is JAX's piece for piece on
    every ASCII character, quotes before contractions, runs of mixed
    whitespace and non-ASCII letters."""
    import random

    from youtu_rag_tpu.models import bpe as jax_bpe
    from youtu_rag_tpu_torch.models import bpe

    alphabet = "ab Z9'\t\n\r\x0b\x0c\x1c\x1f!?.,\"{}:_-sdtmlrev \x7f\x00"
    r = random.Random(0)
    texts = ["".join(r.choice(alphabet) for _ in range(r.randint(0, 24))) for _ in range(3000)]
    texts += ["".join(map(chr, range(128))) * 2, "it's   they'll\n\n  x", "héllo wörld 42"]
    for t in texts:
        assert bpe._gpt2_word_split(t) == jax_bpe._gpt2_word_split(t), repr(t)
