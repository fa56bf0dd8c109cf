"""The port's sharded train steps against its single-device steps and the
JAX package's GSPMD steps, on the CPU: ``make_sharded_train_step`` over
(dp, tp), ``make_sharded_moe_train_step`` over (dp, ep) and
``make_sharded_lm_train_step`` over (dp, tp), on local meshes of 8 ``cpu``
slots (one replica: the dp rows share the device) and of 8 distinct
``cpu:i`` devices (a replica per dp row, each with its own parameters),
JAX on its 8 host devices, the same numpy parameters and batches.

Tolerances are JAX's (``tests/models/test_train_lm.py`` and
``test_moe_train.py``): losses rtol 2e-4, parameters rtol 2e-4 / atol
2e-5, over 3 steps (the first update's learning rate is 0). Two batches
would fail a per-replica loss: dp rows with different completion counts
(the LM loss divides by the count over the whole batch) and InfoNCE over
B rows where each replica holds B/dp (its negatives are the global
batch); each test also shows that the per-replica form differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from youtu_rag_tpu.models import decoder as jax_decoder
from youtu_rag_tpu.models import encoder as jax_encoder
from youtu_rag_tpu.models import train as jax_train
from youtu_rag_tpu.models import train_lm as jax_lm
from youtu_rag_tpu.parallel import expert_parallel as jax_ep
from youtu_rag_tpu.parallel.mesh import get_mesh as jax_mesh
from youtu_rag_tpu_torch.models import decoder as port_decoder
from youtu_rag_tpu_torch.models import encoder as port_encoder
from youtu_rag_tpu_torch.models import train as port_train
from youtu_rag_tpu_torch.models import train_lm as port_lm
from youtu_rag_tpu_torch.models.convert import (
    decoder_params_from_numpy,
    encoder_params_from_numpy,
    moe_params_from_numpy,
)
from youtu_rag_tpu_torch.parallel.mesh import Mesh
from torch_native_helpers import jax_tracer_restored, torch_one_thread  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored", "torch_one_thread")

LOSS_RTOL, RTOL, ATOL = 2e-4, 2e-4, 2e-5
ENC = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=16, out_dim=16)
DEC = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
           max_len=32, arch="llama", eos_token_id=1)
E = 4
STEPS = 3


def local_mesh(axes: dict, apart: bool) -> Mesh:
    n = int(np.prod(list(axes.values())))
    devs = [torch.device("cpu", i) for i in range(n)] if apart else ["cpu"] * n
    return Mesh(np.array(devs, dtype=object).reshape(list(axes.values())), list(axes))


def clone(tree: dict) -> dict:
    return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def assert_trees_close(got: dict, want: dict):
    want = flat(want)
    for name, v in flat(got).items():
        np.testing.assert_allclose(v, want[name], rtol=RTOL, atol=ATOL, err_msg=name)


def replicas_equal(placed) -> bool:
    first = port_train.leaves(placed[0])
    return all(all(torch.equal(a, b) for a, b in zip(first, port_train.leaves(r)))
               for r in placed[1:])


def enc_batch(seed: int, b: int = 8, t: int = 16) -> dict:
    r = np.random.default_rng(seed)
    out = {}
    for side in "qd":
        n = r.integers(4, t + 1, b)
        mask = (np.arange(t)[None] < n[:, None]).astype(np.float32)
        out[f"{side}_ids"] = (r.integers(1, ENC["vocab_size"], (b, t)) * mask).astype(np.int32)
        out[f"{side}_mask"] = mask
    return out


@pytest.fixture(scope="module")
def enc_twins():
    jcfg = jax_encoder.EncoderConfig(**ENC, dtype=jnp.float32)
    tcfg = port_encoder.EncoderConfig(**ENC, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(lambda: jax_encoder.init_encoder_params(jcfg, 0))())
    return jcfg, tcfg, tree


@pytest.fixture(scope="module")
def moe_twins():
    jcfg = jax_encoder.EncoderConfig(**ENC, dtype=jnp.float32)
    tcfg = port_encoder.EncoderConfig(**ENC, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(lambda: jax_ep.init_moe_params(jcfg, E, 3))())
    return jcfg, tcfg, tree


# ------------------------------------------------------------- dp x tp


@pytest.mark.parametrize("apart", [False, True], ids=["one-device", "cpu-i"])
def test_dp_tp_step_matches_single_device_and_jax(enc_twins, apart):
    jcfg, tcfg, tree = enc_twins
    tc = port_train.TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    jtc = jax_train.TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    batches = [enc_batch(s) for s in range(STEPS)]

    placed, opt_state, step = port_train.make_sharded_train_step(
        tcfg, tc, local_mesh({"dp": 4, "tp": 2}, apart),
        init_params=encoder_params_from_numpy(tree, tcfg))
    assert len(placed) == (4 if apart else 1)
    assert len(placed[0]["layers"]["wq"]) == 2 and placed[0]["layers"]["wq"][0].shape[-1] == 16
    opt = port_train.make_optimizer(tc)
    ref = encoder_params_from_numpy(tree, tcfg)
    ref_state, ref_step = opt.init(ref), port_train.make_train_step(tcfg, tc, opt)
    jparams, jstate, jstep = jax_train.make_sharded_train_step(
        jcfg, jtc, jax_mesh({"dp": 4, "tp": 2}), init_params=tree)
    for b in batches:
        placed, opt_state, m = step(placed, opt_state, b)
        ref, ref_state, mr = ref_step(ref, ref_state, b)
        jparams, jstate, mj = jstep(jparams, jstate, b)
        np.testing.assert_allclose(float(m["loss"]), float(mr["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["loss"]), float(mj["loss"]), rtol=LOSS_RTOL)
        assert float(m["accuracy"]) == float(mr["accuracy"])
    assert replicas_equal(placed)
    assert int(opt_state["count"]) == STEPS
    full = placed.gather()
    assert_trees_close(full, ref)
    assert_trees_close(full, jax.tree.map(np.asarray, jparams))
    mu = placed.placement.gather(opt_state["mu"])
    assert_trees_close(mu, ref_state["mu"])


def test_negatives_are_the_global_batch(enc_twins):
    """B = 8 over dp 4: each replica holds 2 rows, and its logits would be
    [2, 2] with B/dp negatives; the step's loss is the [8, 8] one."""
    _, tcfg, tree = enc_twins
    tc = port_train.TrainConfig(remat=False)
    params = encoder_params_from_numpy(tree, tcfg)
    b = {k: torch.from_numpy(v) for k, v in enc_batch(11).items()}
    placed, state, step = port_train.make_sharded_train_step(
        tcfg, tc, local_mesh({"dp": 4, "tp": 2}, True), init_params=params)
    _, _, m = step(placed, state, b)
    whole, _ = port_train.info_nce_loss(params, b, tcfg, tc)
    np.testing.assert_allclose(float(m["loss"]), float(whole), rtol=LOSS_RTOL)
    local = np.mean([float(port_train.info_nce_loss(
        params, {k: v[2 * i : 2 * i + 2] for k, v in b.items()}, tcfg, tc)[0]) for i in range(4)])
    assert abs(local - float(whole)) > 100 * LOSS_RTOL * float(whole)


def test_sharding_spec_for_replicates_what_does_not_divide(enc_twins):
    _, tcfg, tree = enc_twins
    params = encoder_params_from_numpy(tree, tcfg)
    params["pooler_w"] = torch.zeros(32, 32)  # unknown to the spec
    params["tok_emb"] = torch.zeros(255, 32)  # a vocabulary tp = 2 does not divide
    spec = port_train.sharding_spec_for(params, tcfg, local_mesh({"dp": 4, "tp": 2}, False))
    assert spec["pooler_w"] == (None, None) and spec["tok_emb"] == (None, None)
    assert spec["layers"]["wq"] == (None, None, "tp") and spec["layers"]["wo"] == (None, "tp", None)
    assert spec["out_proj"] == (None, "tp") and spec["final_ln_scale"] == (None,)


@pytest.mark.parametrize("arch", ["preln_rope", "bert"])
def test_param_sharding_spec_matches_jax(arch):
    from jax.sharding import PartitionSpec as P

    kw = dict(ENC, arch=arch, lex_pool=arch == "preln_rope")
    want = jax_encoder.param_sharding_spec(jax_encoder.EncoderConfig(**kw))
    got = port_encoder.param_sharding_spec(port_encoder.EncoderConfig(**kw))

    def walk(g, w):
        assert set(g) == set(w)
        for k in g:
            if isinstance(g[k], dict):
                walk(g[k], w[k])
            else:
                assert P(*g[k]) == w[k], k

    walk(got, want)


# ------------------------------------------------------------- dp x ep


@pytest.mark.parametrize("apart", [False, True], ids=["one-device", "cpu-i"])
def test_dp_ep_moe_step_matches_single_device_and_jax(moe_twins, apart):
    jcfg, tcfg, tree = moe_twins
    tc = port_train.MoETrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20,
                                   n_experts=E, remat=False)
    jtc = jax_train.MoETrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20,
                                   n_experts=E, remat=False)
    batches = [enc_batch(10 + s) for s in range(STEPS)]
    placed, opt_state, step = port_train.make_sharded_moe_train_step(
        tcfg, tc, local_mesh({"dp": 2, "ep": 4}, apart),
        init_params=moe_params_from_numpy(tree, tcfg, E))
    assert placed[0]["layers"]["ew1"][0].shape[1] == E // 4
    assert not isinstance(placed[0]["layers"]["router"], list)
    opt = port_train.make_optimizer(tc)
    ref = moe_params_from_numpy(tree, tcfg, E)
    ref_state, ref_step = opt.init(ref), port_train.make_moe_train_step(tcfg, tc, opt)
    jparams, jstate, jstep = jax_train.make_sharded_moe_train_step(
        jcfg, jtc, jax_mesh({"dp": 2, "ep": 4}), init_params=tree)
    for b in batches:
        placed, opt_state, m = step(placed, opt_state, b)
        ref, ref_state, mr = ref_step(ref, ref_state, b)
        jparams, jstate, mj = jstep(jparams, jstate, b)
        for key in ("loss", "contrastive_loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(mr[key]), rtol=LOSS_RTOL, err_msg=key)
            np.testing.assert_allclose(float(m[key]), float(mj[key]), rtol=LOSS_RTOL, err_msg=key)
        assert float(m["aux_loss"]) > 0.0
    assert replicas_equal(placed)
    full = placed.gather()
    assert_trees_close(full, ref)
    assert_trees_close(full, jax.tree.map(np.asarray, jparams))


def test_moe_spec_matches_jax(moe_twins):
    from jax.sharding import PartitionSpec as P

    _, tcfg, tree = moe_twins
    params = moe_params_from_numpy(tree, tcfg, E)
    got = port_train.moe_sharding_spec(params, local_mesh({"dp": 2, "ep": 4}, False))
    want = jax_train.moe_sharding_spec(tree, jax_mesh({"dp": 2, "ep": 4}))
    for k in got["layers"]:
        assert P(*got["layers"][k]) == P(*tuple(want["layers"][k]) + (None,) * (
            len(got["layers"][k]) - len(want["layers"][k]))), k
    with pytest.raises(ValueError, match="4 experts do not split over ep = 3"):
        port_train.make_sharded_moe_train_step(
            tcfg, port_train.MoETrainConfig(n_experts=E), local_mesh({"dp": 1, "ep": 3}, False))


# ------------------------------------------------------------- LM, dp x tp


def lm_batch(seed: int, b: int = 8, t: int = 32, uneven: bool = False) -> dict:
    """Right-padded rows with a prompt and a completion span; ``uneven``
    gives the two dp halves very different completion counts."""
    r = np.random.default_rng(seed)
    tokens = r.integers(2, DEC["vocab_size"], (b, t)).astype(np.int32)
    n = r.integers(t // 2, t + 1, b)
    p = r.integers(2, t // 2, b)
    if uneven:
        p[: b // 2] = n[: b // 2] - 2  # two completion tokens a row
    pos = np.arange(t)[None]
    mask = (pos < n[:, None]).astype(np.float32)
    return {"tokens": np.where(mask > 0, tokens, 1).astype(np.int32), "mask": mask,
            "loss_mask": ((pos >= p[:, None]) & (pos < n[:, None])).astype(np.float32)}


@pytest.fixture(scope="module")
def lm_twins():
    jcfg = jax_decoder.DecoderConfig(**DEC, dtype=jnp.float32)
    tcfg = port_decoder.DecoderConfig(**DEC, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(lambda: jax_decoder.init_decoder_params(jcfg, 0))())
    return jcfg, tcfg, tree


@pytest.mark.parametrize("apart", [False, True], ids=["one-device", "cpu-i"])
def test_lm_step_matches_single_device_and_jax(lm_twins, apart):
    jcfg, tcfg, tree = lm_twins
    tc = port_lm.LMTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jtc = jax_lm.LMTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    opt, jopt = port_lm.make_lm_optimizer(tc), jax_lm.make_lm_optimizer(jtc)
    params = decoder_params_from_numpy(tree, tcfg)
    step, place_params, place_batch = port_lm.make_sharded_lm_train_step(
        tcfg, tc, opt, local_mesh({"dp": 4, "tp": 2}, apart), params)
    placed = place_params(params)
    state = opt.init(placed)
    ref, ref_step = clone(params), port_lm.make_lm_train_step(tcfg, tc, opt)
    ref_state = opt.init(ref)
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    jstep, jplace, jplace_batch = jax_lm.make_sharded_lm_train_step(jcfg, jtc, jopt, jmesh, tree)
    jparams = jplace(tree)
    jstate = jopt.init(jparams)
    for s in range(STEPS):
        b = lm_batch(s, uneven=s == 1)
        placed, state, m = step(placed, state, place_batch(b))
        ref, ref_state, mr = ref_step(ref, ref_state, b)
        jparams, jstate, mj = jstep(jparams, jstate, jplace_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(mr["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["loss"]), float(mj["loss"]), rtol=LOSS_RTOL)
    assert replicas_equal(placed)
    full = placed.gather()
    assert_trees_close(full, ref)
    assert_trees_close(port_lm.split_qkv(full, tcfg), jax.device_get(jparams))


def test_lm_loss_is_the_global_mean_over_uneven_rows(lm_twins):
    """dp halves with 2 and ~12 completion tokens a row: the step's loss is
    the batch's summed cross-entropy over its completion count, not the
    mean of the halves' means."""
    _, tcfg, tree = lm_twins
    tc = port_lm.LMTrainConfig(remat=False)
    params = decoder_params_from_numpy(tree, tcfg)
    params["tok_emb"] = params["tok_emb"] * 50.0  # peaked logits: the tokens' losses differ
    b = {k: torch.from_numpy(v) for k, v in lm_batch(5, uneven=True).items()}
    step, place_params, place_batch = port_lm.make_sharded_lm_train_step(
        tcfg, tc, port_lm.make_lm_optimizer(tc), local_mesh({"dp": 2, "tp": 2}, True), params)
    placed = place_params(params)
    _, _, m = step(placed, port_lm.make_lm_optimizer(tc).init(placed), place_batch(b))
    whole = float(port_lm.lm_loss(params, b, tcfg, tc))
    np.testing.assert_allclose(float(m["loss"]), whole, rtol=LOSS_RTOL)
    halves = np.mean([float(port_lm.lm_loss(params, {k: v[4 * i : 4 * i + 4] for k, v in b.items()},
                                            tcfg, tc)) for i in range(2)])
    assert abs(halves - whole) > 100 * LOSS_RTOL * whole


def test_lm_part_and_join_invert(lm_twins):
    _, tcfg, tree = lm_twins
    params = decoder_params_from_numpy(tree, tcfg)
    for name in ("wqkv", "w1", "w2", "wo"):
        t = params["layers"][name]
        dim = port_decoder.decoder_sharding_spec(tcfg)["layers"][name].index("tp")
        parts = [port_decoder.tp_part(name, t, r, 2, dim, tcfg) for r in range(2)]
        assert torch.equal(port_decoder.tp_join(name, parts, dim, tcfg), t)


# ------------------------------------------------------------- gradients


GRAD_RTOL = 1e-5  # of each leaf's largest gradient (test_torch_train.py's first-step bound)


@pytest.mark.parametrize("kind", ["dp_tp", "dp_ep", "lm"])
def test_sharded_steps_apply_the_one_device_gradients(enc_twins, moe_twins, lm_twins, kind):
    """The gradients a sharded step applies (``step.grads``: summed over dp,
    gathered over tp or ep) are the one-device step's. Adam's update is
    blind to a gradient's scale, so the parameter checks above would not
    see a gradient counted tp times; this one does."""
    if kind == "dp_tp":
        _, tcfg, tree = enc_twins
        tc = port_train.TrainConfig(remat=True)
        params = encoder_params_from_numpy(tree, tcfg)
        placed, _, step = port_train.make_sharded_train_step(
            tcfg, tc, local_mesh({"dp": 4, "tp": 2}, True), init_params=clone(params))
        b = enc_batch(21)

        def loss_fn(p, bt):
            return port_train.info_nce_loss(p, bt, tcfg, tc)
    elif kind == "dp_ep":
        _, tcfg, tree = moe_twins
        tc = port_train.MoETrainConfig(n_experts=E, remat=False)
        params = moe_params_from_numpy(tree, tcfg, E)
        placed, _, step = port_train.make_sharded_moe_train_step(
            tcfg, tc, local_mesh({"dp": 2, "ep": 4}, True), init_params=clone(params))
        b = enc_batch(22)

        def loss_fn(p, bt):
            return port_train.moe_info_nce_loss(p, bt, tcfg, tc)
    else:
        _, tcfg, tree = lm_twins
        tc = port_lm.LMTrainConfig(remat=True)
        params = decoder_params_from_numpy(tree, tcfg)
        step, place_params, _ = port_lm.make_sharded_lm_train_step(
            tcfg, tc, port_lm.make_lm_optimizer(tc), local_mesh({"dp": 4, "tp": 2}, True),
            params)
        placed = place_params(params)
        b = lm_batch(23, uneven=True)

        def loss_fn(p, bt):
            return port_lm.lm_loss(p, bt, tcfg, tc), None
    _, got = step.grads(placed, b)
    (_, _), want = port_train.value_and_grad(loss_fn, params, port_train.as_batch(b, "cpu"))
    for name, g, w in zip(port_train.leaf_names(params), port_train.leaves(got), want):
        scale = max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)
