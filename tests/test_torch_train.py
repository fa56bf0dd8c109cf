"""The port's encoder training against the JAX package's, on the CPU:
the optimizer (schedule, clip, AdamW) against optax, the InfoNCE and MoE
train steps against JAX's on the same numpy parameters and batches, the
MoE forward and its aux loss, ``TrainCheckpointer``, the npz deployment
format across packages, the attention kernels' refusal to differentiate,
and ``train_embedder`` end to end.

Tolerances (f32 throughout):
- schedule: 1e-6 relative plus 1e-6 x peak absolute (optax evaluates it in
  f32 and the port in f64 rounded to f32; near the cosine's end the value
  is a difference of nearly equal f32 numbers);
- optimizer on identical gradients: 1e-6 relative (one f32 rounding per
  operation, in the same order);
- first-step gradients: 1e-5 relative to each leaf's largest gradient
  (two frameworks summing the same products in other orders; ~1e-6 seen);
- losses over 5 steps: 1e-5 relative;
- parameters after 5 steps: 1e-4 absolute. A gradient that differs by
  ~1e-6 relative moves Adam's direction m/(sqrt(v) + eps) by as much, but
  for an element whose gradient is within rounding of zero the direction
  can differ by O(1), and the parameter by up to the learning rate (1e-2)
  per update; these configs hold no such element (5e-6 seen), and 1e-4
  is 20x what was seen and 100x below one such disagreement.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from youtu_rag_tpu.models import encoder as jax_encoder
from youtu_rag_tpu.models import train as jax_train
from youtu_rag_tpu.parallel import expert_parallel as jax_ep
from youtu_rag_tpu_torch.models import encoder as port_encoder
from youtu_rag_tpu_torch.models import train as port_train
from youtu_rag_tpu_torch.models.checkpoint import TrainCheckpointer
from youtu_rag_tpu_torch.models.convert import encoder_params_from_numpy, moe_params_from_numpy
from youtu_rag_tpu_torch.ops import attention as port_attention
from youtu_rag_tpu_torch.parallel import expert_parallel as port_ep
from torch_native_helpers import jax_tracer_restored, torch_one_thread  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored", "torch_one_thread")

TINY = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=16, out_dim=16)
N_EXPERTS = 4


def configs(**over):
    kw = {**TINY, **over}
    return (jax_encoder.EncoderConfig(**kw, dtype=jnp.float32),
            port_encoder.EncoderConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module")
def enc_tree():
    """JAX's initial encoder parameters (seed 0) as numpy."""
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jax.jit(lambda: jax_encoder.init_encoder_params(jcfg, 0))())


@pytest.fixture(scope="module")
def moe_tree():
    """JAX's initial MoE parameters (seed 0) as numpy."""
    jcfg, _ = configs()
    return jax.tree.map(np.asarray,
                        jax.jit(lambda: jax_ep.init_moe_params(jcfg, N_EXPERTS, 0))())


def batch(seed: int, b: int = 8, t: int = 16) -> dict:
    """q/d ids and masks from a seed: row lengths 4..t, ids zero past them."""
    r = np.random.default_rng(seed)
    out = {}
    for side in "qd":
        n = r.integers(4, t + 1, b)
        mask = (np.arange(t)[None] < n[:, None]).astype(np.float32)
        out[f"{side}_ids"] = (r.integers(1, TINY["vocab_size"], (b, t)) * mask).astype(np.int32)
        out[f"{side}_mask"] = mask
    return out


def paths(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for k, v in tree.items():
        out.extend(paths(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])
    return out


def get(tree, path: str) -> np.ndarray:
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree.detach()) if isinstance(tree, torch.Tensor) else np.asarray(tree)


def jax_grads(loss_fn):
    """JAX's ((loss, metrics), grads) of ``loss_fn``, jitted (eager JAX
    dispatches the layer scan op by op)."""
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=(2, 3))


def assert_grads_close(jax_grads, port_params, port_grads):
    for name, g in zip(paths(port_params), port_grads):
        want = get(jax_grads, name)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * scale, err_msg=name)


def assert_params_close(jax_params, port_params, atol=1e-4):
    for name in paths(port_params):
        np.testing.assert_allclose(get(port_params, name), get(jax_params, name), rtol=0,
                                   atol=atol, err_msg=name)


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 7), (5, 6), (20, 200)])
def test_schedule_matches_optax_at_every_count(warmup, total):
    peak = 1e-3
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    got = port_train.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    counts = range(total + 3)
    np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts],
                               rtol=1e-6, atol=1e-6 * peak)
    assert got(0) == 0.0 or warmup == 0


def test_first_update_uses_lr_zero():
    """optax reads the schedule at the count before the update: with a
    2-step warmup to 1e-3 the first three updates use 0, 5e-4, 1e-3."""
    opt = port_train.make_optimizer(port_train.TrainConfig(learning_rate=1e-3, warmup_steps=2,
                                                           total_steps=10))
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    lrs = []
    for _ in range(3):
        lrs.append(opt.schedule(int(state["count"])))
        before = params["w"].clone()
        opt.update([torch.full((3,), 0.5)], state, params)
        if len(lrs) == 1:
            assert torch.equal(params["w"], before)  # lr 0: not even weight decay moves it
    assert lrs == [0.0, float(np.float32(5e-4)), float(np.float32(1e-3))]


def tree_np(seed: int) -> dict:
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(5, 3)).astype(np.float32),
            "layers": {"b": r.normal(size=(7,)).astype(np.float32),
                       "c": r.normal(size=(2, 2, 2)).astype(np.float32)}}


def test_optimizer_matches_optax_with_and_without_clip():
    """Six updates on identical gradients, some with a global norm above 1
    (clipped) and some below (passed as they are), and one exactly 1 (optax
    clips at >= max_norm)."""
    tc = port_train.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=8,
                                weight_decay=0.05)
    jopt = jax_train.make_optimizer(jax_train.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                                          total_steps=8, weight_decay=0.05))
    popt = port_train.make_optimizer(tc)
    jp = jax.tree.map(jnp.asarray, tree_np(0))
    js = jopt.init(jp)
    pp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree_np(0))
    ps = popt.init(pp)
    for i, norm in enumerate([3.0, 0.25, 1.0, 7.5, 0.9, 2.0]):
        g = tree_np(100 + i)
        total = np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree.leaves(g)))
        g = jax.tree.map(lambda x: (x * (norm / total)).astype(np.float32), g)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        popt.update([torch.from_numpy(get(g, n).copy()) for n in paths(pp)], ps, pp)
        for name in paths(pp):
            np.testing.assert_allclose(get(pp, name), get(jp, name), rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i}: {name}")
    assert int(ps["count"]) == 6


# ------------------------------------------------------------- InfoNCE step


def test_info_nce_step_matches_jax(enc_tree):
    jcfg, pcfg = configs()
    tree = enc_tree
    jtc = jax_train.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10, remat=False)
    ptc = port_train.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10, remat=True)
    jp = jax.tree.map(jnp.asarray, tree)
    pp = encoder_params_from_numpy(tree, pcfg)

    (jl, jm), jg = jax_grads(jax_train.info_nce_loss)(jp, batch(0), jcfg, jtc)
    (pl, pm), pg = port_train.value_and_grad(port_train.info_nce_loss, pp,
                                             port_train.as_batch(batch(0), "cpu"), pcfg, ptc)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    assert float(pm["accuracy"]) == float(jm["accuracy"])
    assert_grads_close(jg, pp, pg)

    jopt, popt = jax_train.make_optimizer(jtc), port_train.make_optimizer(ptc)
    js, ps = jopt.init(jp), popt.init(pp)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jtc, jopt))
    pstep = port_train.make_train_step(pcfg, ptc, popt)
    for i in range(5):
        jp, js, jm = jstep(jp, js, batch(i))
        pp, ps, pm = pstep(pp, ps, batch(i))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_params_close(jp, pp)


@pytest.mark.parametrize("short", ["q", "d"])
def test_info_nce_loss_with_unequal_lengths_matches_jax(enc_tree, short):
    """The shorter side is padded into the one forward with mask 0; the
    loss and gradients are JAX's two forwards'."""
    jcfg, pcfg = configs()
    b = batch(4)
    b[f"{short}_ids"], b[f"{short}_mask"] = b[f"{short}_ids"][:, :10], b[f"{short}_mask"][:, :10]
    jtc = jax_train.TrainConfig(remat=False)
    (jl, _), jg = jax_grads(jax_train.info_nce_loss)(
        jax.tree.map(jnp.asarray, enc_tree), b, jcfg, jtc)
    pp = encoder_params_from_numpy(enc_tree, pcfg)
    (pl, _), pg = port_train.value_and_grad(port_train.info_nce_loss, pp,
                                            port_train.as_batch(b, "cpu"), pcfg,
                                            port_train.TrainConfig(remat=False))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    assert_grads_close(jg, pp, pg)


def test_remat_changes_no_gradient():
    _, pcfg = configs()
    params = port_encoder.init_encoder_params(pcfg, torch.Generator().manual_seed(0))
    b = port_train.as_batch(batch(3), "cpu")
    grads = []
    for remat in (False, True):
        tc = port_train.TrainConfig(remat=remat)
        _, g = port_train.value_and_grad(port_train.info_nce_loss, params, b, pcfg, tc)
        grads.append(g)
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_train_step_learns():
    _, pcfg = configs()
    params = port_encoder.init_encoder_params(pcfg, torch.Generator().manual_seed(0))
    tc = port_train.TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=20, remat=False)
    opt = port_train.make_optimizer(tc)
    state, step = opt.init(params), port_train.make_train_step(pcfg, tc, opt)
    b = batch(7)
    losses = [float(step(params, state, b)[2]["loss"]) for _ in range(20)]
    assert np.all(np.isfinite(losses)) and np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])


# ------------------------------------------------------------------ MoE


def test_moe_forward_and_aux_match_jax(moe_tree):
    jcfg, pcfg = configs()
    tree = moe_tree
    pp = moe_params_from_numpy(tree, pcfg, N_EXPERTS)
    b = batch(1)
    jemb, jcls, jaux = jax_ep.moe_encode_tokens_with_aux(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(b["q_ids"]), jnp.asarray(b["q_mask"]),
        jcfg, N_EXPERTS)
    emb, cls, aux = port_ep.moe_encode_tokens_with_aux(
        pp, torch.from_numpy(b["q_ids"]), torch.from_numpy(b["q_mask"]), pcfg, N_EXPERTS)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(jemb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(jcls), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    emb2, _ = port_ep.moe_encode_tokens(pp, torch.from_numpy(b["q_ids"]),
                                        torch.from_numpy(b["q_mask"]), pcfg, N_EXPERTS)
    torch.testing.assert_close(emb2, emb, rtol=0, atol=0)
    shares = port_ep.expert_shares(pp, torch.from_numpy(b["q_ids"]),
                                   torch.from_numpy(b["q_mask"]), pcfg, N_EXPERTS)
    assert shares.shape == (TINY["n_layers"], N_EXPERTS)
    np.testing.assert_allclose(shares.sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "ties", "one_expert"])
def test_load_balancing_loss_matches_jax(case):
    r = np.random.default_rng(5)
    logits = r.normal(size=(3, 10, N_EXPERTS)).astype(np.float32)
    if case == "ties":  # equal maxima: the first wins in both packages
        logits[..., 1] = logits[..., 2] = logits.max(axis=-1) + 1.0
    if case == "one_expert":
        logits[..., 3] += 50.0
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    idx = np.array(jnp.argmax(jnp.asarray(probs), axis=-1))
    assert np.array_equal(torch.argmax(torch.from_numpy(probs), dim=-1).numpy(), idx)
    want = jax_ep.load_balancing_loss(jnp.asarray(probs), jnp.asarray(idx), N_EXPERTS)
    got = port_ep.load_balancing_loss(torch.from_numpy(probs), torch.from_numpy(idx), N_EXPERTS)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_step_matches_jax(moe_tree):
    jcfg, pcfg = configs()
    tree = moe_tree
    jtc = jax_train.MoETrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                                   remat=False, n_experts=N_EXPERTS)
    ptc = port_train.MoETrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                                    remat=False, n_experts=N_EXPERTS)
    jp = jax.tree.map(jnp.asarray, tree)
    pp = moe_params_from_numpy(tree, pcfg, N_EXPERTS)
    (jl, jm), jg = jax_grads(jax_train.moe_info_nce_loss)(jp, batch(0), jcfg, jtc)
    (pl, pm), pg = port_train.value_and_grad(port_train.moe_info_nce_loss, pp,
                                             port_train.as_batch(batch(0), "cpu"), pcfg, ptc)
    for key in ("loss", "contrastive_loss", "aux_loss"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert_grads_close(jg, pp, pg)

    jopt, popt = jax_train.make_optimizer(jtc), port_train.make_optimizer(ptc)
    js, ps = jopt.init(jp), popt.init(pp)
    jstep = jax.jit(jax_train.make_moe_train_step(jcfg, jtc, jopt))
    pstep = port_train.make_moe_train_step(pcfg, ptc, popt)
    for i in range(5):
        jp, js, jm = jstep(jp, js, batch(i))
        pp, ps, pm = pstep(pp, ps, batch(i))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_params_close(jp, pp)


def test_moe_params_from_numpy_checks_shapes(moe_tree):
    _, pcfg = configs()
    tree = moe_tree
    with pytest.raises(ValueError, match="MoE encoder parameters: layers/router has shape"):
        moe_params_from_numpy(tree, pcfg, N_EXPERTS + 1)
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "router"})
    with pytest.raises(ValueError, match="layers/router is missing"):
        moe_params_from_numpy(bad, pcfg, N_EXPERTS)
    init = port_ep.init_moe_params(pcfg, N_EXPERTS, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init["layers"].items()} == \
        {k: v.shape for k, v in tree["layers"].items()}


# ------------------------------------------------------------ checkpoints


def small_state(seed: int):
    _, pcfg = configs()
    params = port_encoder.init_encoder_params(pcfg, torch.Generator().manual_seed(seed))
    opt = port_train.make_optimizer(port_train.TrainConfig(warmup_steps=1, total_steps=5))
    state = opt.init(params)
    opt.update([torch.ones_like(p) for p in port_train.leaves(params)], state, params)
    return params, state


def assert_trees_equal(a, b):
    assert paths(a) == paths(b)
    for name in paths(a):
        ta, tb = get(a, name), get(b, name)
        assert ta.dtype == tb.dtype and np.array_equal(ta, tb), name


def test_checkpoint_round_trip_and_rotation(tmp_path):
    ck = TrainCheckpointer(tmp_path / "ckpt")
    assert ck.latest_step() is None
    saved = {}
    for step in (1, 2, 3, 4, 5):
        params, state = small_state(step)
        ck.save(step, params, state, metadata={"loss": step / 10})
        saved[step] = (params, state)
    assert ck.all_steps() == [3, 4, 5] and ck.latest_step() == 5
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4", "5"]
    params, state, meta = ck.restore(4)
    assert meta == {"loss": 0.4}
    assert_trees_equal(params, saved[4][0])
    assert_trees_equal(state, saved[4][1])
    assert int(state["count"]) == 1
    # the files load with weights_only=True on their own
    raw = torch.load(tmp_path / "ckpt" / "5" / "params.pt", weights_only=True)
    assert_trees_equal(raw, saved[5][0])
    # a save at or below the latest step is skipped, as orbax's manager does
    other, other_state = small_state(99)
    ck.save(5, other, other_state)
    assert_trees_equal(ck.restore()[0], saved[5][0])
    ck.close()


def test_checkpoint_restores_onto_templates(tmp_path):
    params, state = small_state(0)
    ck = TrainCheckpointer(tmp_path)
    ck.save(7, params, state)
    like = {k: ({n: t.double().requires_grad_() for n, t in v.items()} if isinstance(v, dict)
                else v.double().requires_grad_()) for k, v in params.items()}
    got, got_state, _ = ck.restore(params_like=like, opt_state_like=state)
    assert got["tok_emb"].dtype == torch.float64 and got["tok_emb"].requires_grad
    assert got_state["count"].dtype == torch.int64
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(tmp_path / "empty").restore()


# --------------------------------------------------- npz across packages


def test_npz_trained_by_one_package_loads_in_the_other(tmp_path, enc_tree):
    """A port-trained npz served by JAX's TpuEmbedder and a JAX-trained npz
    served by the port's TorchEmbedder give the same embeddings (f32)."""
    from youtu_rag_tpu.models.embedder import TpuEmbedder
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    jcfg, pcfg = configs(max_len=32)
    texts = ["unit KL-4407 inventory tag", "glacier hydrology surveys", "a third text here"]
    # the port trains, JAX serves
    params = port_encoder.init_encoder_params(pcfg, torch.Generator().manual_seed(1))
    tc = port_train.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4, remat=False)
    opt = port_train.make_optimizer(tc)
    state, step = opt.init(params), port_train.make_train_step(pcfg, tc, opt)
    for i in range(3):
        step(params, state, batch(i, t=32))
    port_encoder.save_params_npz(params, tmp_path / "port.npz")
    want = TorchEmbedder(config=pcfg, params=params, device="cpu").embed_batch(texts)
    got = TpuEmbedder(config=jcfg, params=jax_encoder.load_params_npz(tmp_path / "port.npz"))
    np.testing.assert_allclose(np.asarray(got.embed_batch(texts)), want, rtol=0, atol=1e-5)
    # JAX trains, the port serves
    jtc = jax_train.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4, remat=False)
    jopt = jax_train.make_optimizer(jtc)
    jp = jax.tree.map(jnp.asarray, enc_tree)
    js, jstep = jopt.init(jp), jax.jit(jax_train.make_train_step(jcfg, jtc, jopt))
    for i in range(3):
        jp, js, _ = jstep(jp, js, batch(i, t=32))
    jax_encoder.save_params_npz(jax.device_get(jp), tmp_path / "jax.npz")
    want = np.asarray(TpuEmbedder(config=jcfg, params=jp).embed_batch(texts))
    served = TorchEmbedder(config=pcfg, device="cpu", params=encoder_params_from_numpy(
        port_encoder.load_params_npz(tmp_path / "jax.npz"), pcfg))
    np.testing.assert_allclose(served.embed_batch(texts), want, rtol=0, atol=1e-5)


# ----------------------------------------------- attention refuses grad


def attention_args(requires_grad: bool):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 256, 64, generator=g).requires_grad_(requires_grad)
               for _ in range(3))
    return q, k, v, torch.zeros(1, 256)


@pytest.mark.parametrize("name", ["blockwise_attention", "flash_attention",
                                  "flash_attention_stats"])
def test_attention_wrappers_refuse_a_differentiable_call(name):
    fn = getattr(port_attention, name)
    with pytest.raises(ValueError, match="no backward"):
        fn(*attention_args(True))
    with torch.no_grad():
        fn(*attention_args(True))  # no graph: the plain route runs
    fn(*attention_args(False))
    with torch.inference_mode():
        fn(*attention_args(False))


def test_encoder_with_kernels_refuses_to_train_and_serves_under_inference():
    _, pcfg = configs(max_len=256, d_model=128, n_heads=2, attention_impl="pallas")
    params = port_encoder.init_encoder_params(pcfg, torch.Generator().manual_seed(0))
    b = port_train.as_batch(batch(0, b=2, t=256), "cpu")
    with pytest.raises(ValueError, match="no backward"):
        port_train.value_and_grad(port_train.info_nce_loss, params, b, pcfg,
                                  port_train.TrainConfig(remat=False))
    with torch.inference_mode():
        emb, _ = port_encoder.encode_tokens(params, b["q_ids"], b["q_mask"], pcfg)
    plain = dataclasses.replace(pcfg, attention_impl="xla")
    want, _ = port_encoder.encode_tokens(params, b["q_ids"], b["q_mask"], plain)
    torch.testing.assert_close(emb, want.detach(), rtol=0, atol=1e-5)


def test_count_params_matches_jax():
    jcfg, pcfg = configs(lex_pool=True, lex_buckets=8)
    shapes = jax.eval_shape(lambda: jax_encoder.init_encoder_params(jcfg, 0))
    pp = port_encoder.init_encoder_params(pcfg)
    assert port_encoder.count_params(pp) == jax_encoder.count_params(shapes)


# ---------------------------------------------------- train_embedder


ARGS = ["--synthetic", "8", "--paraphrase", "16", "--preset", "tiny", "--batch", "8",
        "--seqlen", "32", "--warmup", "2", "--holdout", "8", "--device", "cpu"]


def test_train_embedder_end_to_end(tmp_path):
    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    out = tmp_path / "ft"
    lrs = {}
    report = train_embedder.main(ARGS + ["--steps", "8", "--ckpt-every", "4", "--out", str(out)],
                                 on_step=lambda s, p, o, m: lrs.setdefault(s, int(o["count"])))
    assert report["steps"] == 8 and len(report["losses"]) == 8
    assert np.isfinite(report["losses"]).all()
    assert set(report["recall_before"]) == {"n", "recall@1", "recall@5"}
    assert lrs == {s: s for s in range(1, 9)}
    assert TrainCheckpointer(out / "ckpt").all_steps() == [4, 8]
    cfg = json.loads((out / "encoder_config.json").read_text())
    assert cfg["max_len"] == 512 and cfg["attention_impl"] == "xla" and cfg["dtype"] == "bfloat16"
    emb = TorchEmbedder.from_weights_dir(out, device="cpu")
    vec = emb.embed_batch(["What is the batch lot recorded for KL-4407?"])
    assert vec.shape == (1, 128) and np.isclose(np.linalg.norm(vec), 1.0, atol=1e-5)
    assert json.loads((out / "report.json").read_text())["final_loss"] == report["final_loss"]

    # resume from step 4: the remaining steps continue the optimizer's count
    resumed = tmp_path / "resumed"
    (resumed / "ckpt").mkdir(parents=True)
    shutil.copytree(out / "ckpt" / "4", resumed / "ckpt" / "4")
    counts = {}
    again = train_embedder.main(ARGS + ["--steps", "8", "--resume", "--out", str(resumed)],
                                on_step=lambda s, p, o, m: counts.setdefault(s, int(o["count"])))
    assert counts == {s: s for s in range(5, 9)} and len(again["losses"]) == 4


@pytest.mark.parametrize("flags", [["--dp", "2", "--tp", "2"], ["--dp", "2"], ["--tp", "2"]],
                         ids=["dp2-tp2", "dp2", "tp2"])
def test_train_embedder_on_a_mesh_equals_one_device(flags, tmp_path, monkeypatch):
    """``--dp``/``--tp`` train the (dp, tp) step on ``cpu`` slots: after 2
    steps in f32 (the run's config with its dtype swapped) its losses,
    checkpoint and npz are the one-device run's, within the sharded steps'
    tolerances (losses rtol 2e-4, parameters rtol 2e-4 / atol 2e-5), and
    the npz serves."""
    import functools

    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    monkeypatch.setattr(port_encoder, "EncoderConfig",
                        functools.partial(port_encoder.EncoderConfig, dtype=torch.float32))
    run = ARGS + ["--steps", "2", "--ckpt-every", "2"]
    one = train_embedder.main(run + ["--out", str(tmp_path / "one")])
    mesh = train_embedder.main(run + flags + ["--out", str(tmp_path / "mesh")])
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=2e-4)
    want = np.load(tmp_path / "one" / "encoder_params.npz")
    got = np.load(tmp_path / "mesh" / "encoder_params.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)
    ckpt_one = TrainCheckpointer(tmp_path / "one" / "ckpt").restore(2)
    ckpt_mesh = TrainCheckpointer(tmp_path / "mesh" / "ckpt").restore(2)
    assert paths(ckpt_mesh[0]) == paths(ckpt_one[0])
    assert int(ckpt_mesh[1]["count"]) == int(ckpt_one[1]["count"]) == 2
    for name in paths(ckpt_one[1]["nu"]):
        np.testing.assert_allclose(get(ckpt_mesh[1]["nu"], name), get(ckpt_one[1]["nu"], name),
                                   rtol=2e-4, atol=1e-10, err_msg=name)
    vec = TorchEmbedder.from_weights_dir(tmp_path / "mesh", device="cpu").embed_batch(["KL-4407"])
    assert vec.shape == (1, 128) and np.isclose(np.linalg.norm(vec), 1.0, atol=1e-5)


def test_train_embedder_on_a_mesh_resumes(tmp_path):
    """A sharded run resumes from its (full-tree) checkpoint: the count
    carries on and the optimizer state is placed again."""
    from youtu_rag_tpu_torch import train_embedder

    out = tmp_path / "ft"
    train_embedder.main(ARGS + ["--steps", "2", "--ckpt-every", "2", "--dp", "2", "--tp", "2",
                                "--out", str(out)])
    counts = {}
    again = train_embedder.main(
        ARGS + ["--steps", "4", "--resume", "--dp", "2", "--tp", "2", "--out", str(out)],
        on_step=lambda s, p, o, m: counts.setdefault(s, int(o["count"])))
    assert counts == {3: 3, 4: 4} and np.isfinite(again["losses"]).all()


def test_train_embedder_mesh_without_a_device_needs_cuda(tmp_path):
    from youtu_rag_tpu_torch import train_embedder

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_embedder.main(args + ["--dp", "2", "--tp", "2", "--steps", "2",
                                    "--out", str(tmp_path)])


def test_train_embedder_data_helpers_match_jax(tmp_path):
    """ICT pairs, group tagging and the group-aware batches are the JAX
    script's, byte for byte."""
    import importlib.util
    import sys
    from pathlib import Path

    from youtu_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.models.tokenizer import HashTokenizer

    path = Path(__file__).resolve().parents[1] / "scripts" / "train_embedder.py"
    spec = importlib.util.spec_from_file_location("jax_train_embedder_script", path)
    jax_script = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = jax_script
    spec.loader.exec_module(jax_script)
    (tmp_path / "a.md").write_text(
        "TPUs multiply matrices with a systolic array. HBM feeds the MXU units. "
        "XLA compiles the graph ahead of time. Collectives ride the ICI links.\n\n"
        "Sharding is declared with named annotations. The mesh has two axes here.")
    want = jax_script.ict_pairs_from_corpus(tmp_path, chunk_size=120, seed=3)
    got = train_embedder.ict_pairs_from_corpus(tmp_path, chunk_size=120, seed=3)
    assert got == want and got
    pairs = jax_script.group_pairs(want, 5) + [("q", "p", 9), ("q2", "p2", 9)]
    assert train_embedder.group_pairs(want, 5) == jax_script.group_pairs(want, 5)
    jb = list(jax_script.make_batches(pairs, JaxHashTokenizer(512, 32), 3, 32, 4, 1))
    pb = list(train_embedder.make_batches(pairs, HashTokenizer(512, 32), 3, 32, 4, 1))
    for a, b in zip(jb, pb):
        for key in a:
            assert np.array_equal(a[key], b[key]), key
