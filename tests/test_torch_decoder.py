"""The port's causal-LM decoder (``youtu_rag_tpu_torch/models/decoder.py``,
the decoder loaders of ``models/pretrained.py`` and ``models/convert.py``)
against the JAX package's ``models/decoder.py`` on the same numpy inputs,
on the CPU.

Tolerances, stated per check:
- f32 logits of ``causal_logits``, ``prefill`` and ``decode_step`` within
  1e-4 of JAX's (gpt2; llama with GQA, tied and untied heads, q/k/v
  biases), every parameter drawn at random (biases and norm scales too);
- decode with the cache against the teacher-forced forward within 1e-4,
  and a left-padded row against the same row alone within 1e-4;
- the int8 KV cache: the quantizer bit-equal to JAX's jitted one on the
  same inputs (values and scales); the cache a prefill writes equal in its
  int8 bytes to JAX's, its scales within 1e-6 relative (f32 k and v differ
  by an ulp where the two matmuls sum in another order), logits within
  1e-4 of JAX's int8 path;
- ``generate``'s greedy tokens and lengths equal to JAX's (EOS padding
  included); the sampling masks (temperature, top-k, top-p) equal to the
  logits JAX's ``sample_token`` hands its draw;
- ``load_pretrained_decoder`` on gpt2, llama and qwen2 checkpoints written
  by ``transformers``: the same parameter tree and config as JAX's loader,
  logits within 1e-4 of JAX's and 1e-3 of the ``transformers`` forward;
- the committed ``yrt_tiny_chat`` served in bf16 (``cast_params_for_serving``,
  dtype bf16): greedy tokens equal to JAX's on prompts in its training
  format, up to the first step whose JAX top-2 margin is under the bf16
  logit tolerance (0.1); the test asserts it compared at least 48 steps.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtu_rag_tpu.models import decoder as jd
from youtu_rag_tpu.models.pretrained import load_pretrained_decoder as jax_load
from youtu_rag_tpu_torch.models import decoder as td
from youtu_rag_tpu_torch.models.convert import decoder_params_from_numpy
from youtu_rag_tpu_torch.models.pretrained import load_pretrained_decoder

TOL = 1e-4
CHAT = Path(__file__).resolve().parent.parent / "benchmarks" / "models" / "yrt_tiny_chat"

# name → (arch, n_kv_heads, tie_embeddings, qkv_bias)
ARCHS = {
    "gpt2": ("gpt2", 4, True, False),
    "llama-gqa-tied": ("llama", 2, True, False),
    "llama-mqa-untied-bias": ("llama", 1, False, True),
}


def configs(name, kv_cache_dtype="native", eos=3, max_len=64):
    """(JAX config, port config) at tiny widths, f32."""
    arch, n_kv, tie, bias = ARCHS[name]
    kw = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, n_kv_heads=n_kv, d_ff=64,
              max_len=max_len, arch=arch, tie_embeddings=tie, qkv_bias=bias, eos_token_id=eos,
              kv_cache_dtype=kv_cache_dtype)
    return (jd.DecoderConfig(dtype=jnp.float32, **kw),
            td.DecoderConfig(dtype=torch.float32, **kw))


def random_tree(jcfg, seed):
    """JAX's parameter tree shapes with every leaf random: norm scales
    around 1, everything else N(0, 0.08^2) (numpy f32)."""
    shapes = jax.tree.map(np.shape, jd.init_decoder_params(jcfg, seed=0))
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = path[-1].key
        x = rng.standard_normal(shape).astype(np.float32)
        return (1.0 + 0.1 * x) if "ln" in name else 0.08 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def both(name, seed=0, **kw):
    """(jax params, jax cfg, port params, port cfg) on the same numpy tree."""
    jc, tc = configs(name, **kw)
    tree = random_tree(jc, seed)
    return jax.tree.map(jnp.asarray, tree), jc, decoder_params_from_numpy(tree, tc), tc


def batch(seed, b=3, t=9, vocab=96):
    """Tokens and a left-padding mask (row i padded by 2 i)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        mask[i, : 2 * i] = 0.0
    return toks, mask


@pytest.mark.parametrize("name", list(ARCHS))
def test_causal_logits_match_jax(name):
    jp, jc, tp, tc = both(name)
    toks, mask = batch(1)
    want = np.asarray(jd.causal_logits(jp, jnp.asarray(toks), jnp.asarray(mask), jc))
    got = td.causal_logits(tp, torch.from_numpy(toks), torch.from_numpy(mask), tc).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_steps_match_jax(name, kv):
    """Prefill a left-padded batch, then four decode steps on the same
    tokens: the logits of every step within TOL of JAX's (its jitted
    prefill and decode_step, the serving forms)."""
    jp, jc, tp, tc = both(name, seed=2, kv_cache_dtype=kv)
    toks, mask = batch(3)
    b, t = toks.shape
    total = t + 4
    jcache, tcache = jd.init_cache(jc, b, total), td.init_cache(tc, b, total)
    jprefill = jax.jit(jd.prefill, static_argnames="cfg")
    jdecode = jax.jit(jd.decode_step, static_argnames="cfg")
    jl, jcache = jprefill(jp, jnp.asarray(toks), jnp.asarray(mask), jcache, cfg=jc)
    tl, tcache = td.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mask), tcache, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    attn = np.concatenate([mask, np.zeros((b, 4), np.float32)], axis=1)
    pos = mask.sum(1).astype(np.int32)
    for step in range(4):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        attn[:, t + step] = 1.0
        jl, jcache = jdecode(jp, jnp.asarray(tok), jnp.int32(t + step), jnp.asarray(attn),
                             jnp.asarray(pos + step), jcache, cfg=jc)
        tl, tcache = td.decode_step(tp, torch.from_numpy(tok), t + step, torch.from_numpy(attn),
                                    torch.from_numpy(pos + step), tcache, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    if kv == "int8":  # the cache's int8 bytes equal; scales within an ulp or so
        for key in ("k", "v"):
            np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
            np.testing.assert_allclose(tcache[f"{key}_scale"].numpy(),
                                       np.asarray(jcache[f"{key}_scale"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("name", ["gpt2", "llama-gqa-tied"])
def test_cached_decode_matches_teacher_forced(name, kv):
    """Feeding a sequence token by token through the cache gives the
    teacher-forced logits at every position (int8: within 0.05, the cache's
    rounding; native: TOL)."""
    _, _, tp, tc = both(name, seed=4, kv_cache_dtype=kv)
    toks, _ = batch(5, b=2, t=12)
    full = td.causal_logits(tp, torch.from_numpy(toks), torch.ones(2, 12), tc)
    cache = td.init_cache(tc, 2, 12)
    p = 4
    logits, cache = td.prefill(tp, torch.from_numpy(toks[:, :p]), torch.ones(2, p), cache, tc)
    tol = 0.05 if kv == "int8" else TOL
    torch.testing.assert_close(logits, full[:, p - 1], rtol=0, atol=tol)
    attn = torch.zeros(2, 12)
    attn[:, :p] = 1.0
    for t in range(p, 12):
        attn[:, t] = 1.0
        logits, cache = td.decode_step(tp, torch.from_numpy(toks[:, t]), t, attn,
                                       torch.full((2,), t, dtype=torch.int32), cache, tc)
        torch.testing.assert_close(logits, full[:, t], rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(ARCHS))
def test_left_pad_invariance(name):
    """A row's logits and greedy tokens do not depend on the other rows of
    its batch (its left padding)."""
    _, _, tp, tc = both(name, seed=6)
    seqs = [[5, 17, 42], [8, 1, 2, 3, 4, 60, 7], [11]]
    toks, mask = td.left_pad_batch(seqs, pad_id=0)
    out, lengths = td.generate(tp, torch.from_numpy(toks), torch.from_numpy(mask), tc,
                               max_new_tokens=6)
    last = td.causal_logits(tp, torch.from_numpy(toks), torch.from_numpy(mask), tc)[:, -1]
    for i, s in enumerate(seqs):
        t1, m1 = td.left_pad_batch([s], pad_id=0, bucket=False)
        alone = td.causal_logits(tp, torch.from_numpy(t1), torch.from_numpy(m1), tc)[:, -1]
        torch.testing.assert_close(last[i : i + 1], alone, rtol=0, atol=TOL)
        o1, l1 = td.generate(tp, torch.from_numpy(t1), torch.from_numpy(m1), tc, max_new_tokens=6)
        assert out[i].tolist() == o1[0].tolist() and int(lengths[i]) == int(l1[0])


def test_quantizer_bit_equal_to_jitted_jax():
    """``_quantize_kv`` against JAX's jitted one on the same f32 inputs:
    values and scales bit-equal (rows of every magnitude, exact halves, a
    zero row)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 4, 33, 16)).astype(np.float32)
    x *= rng.uniform(1e-3, 1e3, (64, 4, 33, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = np.arange(16, dtype=np.float32) - 7.5  # halves after scaling
    x[0, 0, 1, 0] = 127.0
    jq, js = jax.jit(jd._quantize_kv)(jnp.asarray(x))
    tq, ts = td._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    dq = td._dequantize_kv(tq, ts, torch.bfloat16).float().numpy()
    want = np.asarray(jd._dequantize_kv(jq, js, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(dq, want)


def eos_from_rollout(name, toks, mask, step=2):
    """A token that row 0's greedy rollout emits at ``step`` (so that row
    stops there when it is EOS)."""
    jp, jc, _, _ = both(name, seed=8)
    out, _ = jd.generate(jp, jnp.asarray(toks), jnp.asarray(mask), jax.random.PRNGKey(0),
                         cfg=jc, max_new_tokens=8)
    return int(np.asarray(out)[0, step])


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_generate_greedy_matches_jax(name, kv):
    """Greedy ``generate``: tokens [B, max_new] and lengths equal to JAX's,
    with an EOS that one row emits early (its tail padded with EOS)."""
    toks, mask = batch(9)
    eos = eos_from_rollout(name, toks, mask)
    jp, jc, tp, tc = both(name, seed=8, kv_cache_dtype=kv, eos=eos)
    want, wl = jd.generate(jp, jnp.asarray(toks), jnp.asarray(mask), jax.random.PRNGKey(0),
                           cfg=jc, max_new_tokens=10)
    got, gl = td.generate(tp, torch.from_numpy(toks), torch.from_numpy(mask), tc,
                          max_new_tokens=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert int(gl[0]) <= 2 and (got[0, int(gl[0]):] == eos).all()


@pytest.mark.parametrize("temperature, top_k, top_p",
                         [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.8), (0.9, 12, 0.6)])
def test_sampling_masks_match_jax(monkeypatch, temperature, top_k, top_p):
    """The logits JAX's ``sample_token`` hands ``jax.random.categorical``
    (temperature, then its top-k and top-p masks) equal the port's
    ``sampling_logits``; the draws differ by design (the port samples with
    a ``torch.Generator``), and every draw falls inside the mask."""
    seen = {}

    def capture(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    rng = np.random.default_rng(int(10 * temperature) + top_k)
    logits = (3.0 * rng.standard_normal((4, 96))).astype(np.float32)
    jd.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k, top_p)
    got = td.sampling_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(got <= td.NEG_INF, seen["logits"] <= jd.NEG_INF)
    kept = got > td.NEG_INF
    np.testing.assert_allclose(got[kept], seen["logits"][kept], rtol=1e-6, atol=0)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = td.sample_token(torch.from_numpy(logits), g, temperature, top_k, top_p).numpy()
        assert kept[np.arange(4), tok].all()
    greedy = td.sample_token(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(greedy, np.argmax(logits, -1))


def test_position_ids_and_left_pad_batch_match_jax():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 1]], np.float32)
    np.testing.assert_array_equal(td.position_ids_from_mask(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jd.position_ids_from_mask(jnp.asarray(mask))))
    seqs = [[1, 2, 3], [4], [5, 6, 7, 8, 9]]
    for bucket in (True, False):
        for a, b in zip(td.left_pad_batch(seqs, 0, bucket), jd.left_pad_batch(seqs, 0, bucket)):
            np.testing.assert_array_equal(a, b)


def test_cast_for_serving_and_config_round_trip(tmp_path):
    _, jc, tp, tc = both("llama-mqa-untied-bias")
    served = td.cast_params_for_serving(tp)
    jserved = jd.cast_params_for_serving(jd.init_decoder_params(jc, seed=0))
    flat = {k: v.dtype for k, v in served["layers"].items()}
    fused = {"wq": "wqkv", "wk": "wqkv", "wv": "wqkv", "bq": "bqkv", "bk": "bqkv", "bv": "bqkv"}
    assert flat == {fused.get(k, k): (torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
                    for k, v in jserved["layers"].items()}
    assert served["tok_emb"].dtype == served["lm_head"].dtype == torch.bfloat16
    assert served["final_ln_scale"].dtype == torch.float32
    cfg = dataclasses.replace(tc, dtype=torch.bfloat16, kv_cache_dtype="int8")
    td.save_decoder_config(cfg, tmp_path / "decoder_config.json")
    assert td.load_decoder_config(tmp_path / "decoder_config.json") == cfg
    jcfg = jd.load_decoder_config(tmp_path / "decoder_config.json")
    assert jcfg.kv_cache_dtype == "int8" and jcfg.dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(tmp_path, kind):
    """A random HF checkpoint written by ``transformers``: (dir, model)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if kind == "gpt2":
        cfg = transformers.GPT2Config(vocab_size=96, n_positions=64, n_embd=32, n_layer=2,
                                      n_head=2, activation_function="gelu_new",
                                      layer_norm_epsilon=1e-5, bos_token_id=0, eos_token_id=0)
        model = transformers.GPT2LMHeadModel(cfg)
    elif kind == "qwen2":
        cfg = transformers.Qwen2Config(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                       num_attention_heads=4, num_key_value_heads=2,
                                       intermediate_size=64, max_position_embeddings=64,
                                       rms_norm_eps=1e-6, rope_theta=1e6,
                                       tie_word_embeddings=True, eos_token_id=2)
        model = transformers.Qwen2ForCausalLM(cfg)
    else:
        cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                       num_attention_heads=4, num_key_value_heads=1,
                                       intermediate_size=64, max_position_embeddings=64,
                                       rms_norm_eps=1e-6, rope_theta=10000.0,
                                       tie_word_embeddings=False, bos_token_id=1,
                                       eos_token_id=2)
        model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    with torch.no_grad():  # qwen2's biases start at zero: make them count
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    d = tmp_path / kind
    model.save_pretrained(str(d), safe_serialization=True)
    return d, model


@pytest.mark.parametrize("kind", ["gpt2", "llama", "qwen2"])
def test_load_pretrained_decoder_matches_jax_and_transformers(tmp_path, kind):
    d, model = save_checkpoint(tmp_path, kind)
    tree, cfg = load_pretrained_decoder(d, dtype=torch.float32)
    jparams, jcfg = jax_load(d, dtype=jnp.float32)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"} \
        == {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    params = decoder_params_from_numpy(tree, cfg)
    ids = np.array([[5, 17, 42, 3, 88, 11, 7]], np.int32)
    mask = np.ones_like(ids, np.float32)
    got = td.causal_logits(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    want = np.asarray(jd.causal_logits(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids).long()).logits.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_convert_rejects_a_wrong_tree():
    jc, tc = configs("llama-gqa-tied")
    tree = random_tree(jc, 0)
    tree["layers"].pop("wk")
    with pytest.raises(ValueError, match="wk"):
        decoder_params_from_numpy(tree, tc)
    tree = random_tree(jc, 0)
    tree["tok_emb"] = tree["tok_emb"][:, :16]
    with pytest.raises(ValueError, match="tok_emb"):
        decoder_params_from_numpy(tree, tc)


# ---------------------------------------------------------------------------
# the committed chat model, in bf16
# ---------------------------------------------------------------------------

MARGIN = 0.1  # bf16 logits of two decoders agree to a few hundredths


def test_tiny_chat_bf16_greedy_matches_jax():
    """``yrt_tiny_chat`` in bf16 as ``LocalChatClient`` serves it, on both
    turns of two episodes in its training format (the JAX package's
    ``lm_synth`` renders them through the serving path): greedy tokens equal
    to JAX's for each prompt, up to the first step whose JAX top-2 margin
    (teacher-forced, bf16) is under MARGIN."""
    from youtu_rag_tpu.models.bpe import BPETokenizer
    from youtu_rag_tpu.models.lm_synth import synth_corpus

    tree, cfg = load_pretrained_decoder(CHAT)
    jparams, jcfg = jax_load(CHAT)
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    tp = td.cast_params_for_serving(decoder_params_from_numpy(tree, cfg))
    jp = jd.cast_params_for_serving(jparams)
    tok = BPETokenizer.from_dir(CHAT)
    samples, _ = synth_corpus(2, seed=5)  # both turns of two episodes
    seqs = [tok.encode(prompt, add_bos=True) for prompt, _ in samples]
    toks, mask = jd.left_pad_batch(seqs, pad_id=jcfg.eos_token_id)
    n_new = 32
    want, wl = jd.generate(jp, jnp.asarray(toks), jnp.asarray(mask), jax.random.PRNGKey(0),
                           cfg=jcfg, max_new_tokens=n_new)
    got, gl = td.generate(tp, torch.from_numpy(toks), torch.from_numpy(mask), cfg,
                          max_new_tokens=n_new)
    want = np.asarray(want)
    full = np.concatenate([toks, want], axis=1)
    fmask = np.concatenate([mask, np.ones_like(want, np.float32)], axis=1)
    logits = np.asarray(jd.causal_logits(jp, jnp.asarray(full), jnp.asarray(fmask), jcfg))
    compared = []
    for row in range(len(seqs)):
        n = int(np.asarray(wl)[row])
        steps = 0
        for s in range(min(n + 1, n_new)):
            top2 = np.sort(logits[row, toks.shape[1] - 1 + s])[-2:]
            if top2[1] - top2[0] < MARGIN:
                break
            assert int(got[row, s]) == int(want[row, s]), (row, s)
            steps += 1
        compared.append(steps)
        if steps > n:  # the whole answer and its EOS
            assert int(gl[row]) == n
    print(f"yrt_tiny_chat bf16: greedy steps compared per prompt {compared}")
    assert sum(compared) >= 48
