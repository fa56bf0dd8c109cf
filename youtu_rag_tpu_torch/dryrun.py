"""The multi-device dry run: every parallel path of the port, once, at tiny
widths.

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``.
``dryrun_multichip(n_devices, devices=None)`` builds meshes of
``parallel.mesh`` over ``n_devices`` slots and drives, each once:

- the (dp, tp) InfoNCE train step (``models.train.make_sharded_train_step``);
- tensor-parallel decoding (``models.decoder.shard_decoder`` /
  ``tp_generate``) against the replicated ``generate``: the same tokens;
- the sharded index over a ``db`` axis: brute with a filter, IVF, the int4
  tier, and on a dcn × ici hybrid mesh the train step and an index sharded
  over both axes;
- sequence parallelism (dp × sp; dp × sp × tp where ``n_devices % 8 ==
  0``), pipeline parallelism and expert parallelism (psum and all-to-all)
  against the unsharded forwards, and the (dp, ep) MoE train step.

It asserts JAX's bounds (1e-4 on SP, PP and EP; finite losses; an aux loss
above 0) and returns the numbers instead of printing them. ``devices``
are the slots' devices (a device may repeat: ``["cuda"] * 4`` holds four
slots on one card, ``["cpu"] * 8`` eight on the host); without it the
CUDA devices, at least ``n_devices`` of them.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def _slots(n_devices: int, devices) -> list[torch.device]:
    if devices is None:
        resolve_device(None)  # raises on a host without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise ValueError(f"dryrun over {n_devices} slots, have {len(devices)} devices")
    return devices[:n_devices]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float().cpu() - b.detach().float().cpu()).abs().max())


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Drive every parallel path once over ``n_devices`` slots (module
    docstring). Returns {"train_loss", "hybrid_loss", "moe_loss",
    "moe_aux_loss", "tp_decode_parity", "ivf_top1", "sp_err", "pp_err",
    "ep_err", "a2a_err"} (NaN or False where the slot count leaves a path
    out, as in JAX)."""
    from .core.config import IndexConfig
    from .core.types import Chunk
    from .models.encoder import EncoderConfig, encode_tokens, init_encoder_params
    from .models.train import TrainConfig, make_sharded_train_step
    from .parallel.mesh import get_hybrid_mesh, get_mesh
    from .parallel.sharded_index import ShardedVectorIndex

    devices = _slots(n_devices, devices)
    dev0 = devices[0]
    rng = np.random.default_rng(0)
    out: dict = {"hybrid_loss": float("nan"), "moe_loss": float("nan"),
                 "moe_aux_loss": float("nan"), "tp_decode_parity": False,
                 "sp_err": float("nan"), "pp_err": float("nan"), "ep_err": float("nan"),
                 "a2a_err": float("nan")}

    # -- the training step: dp x tp, Megatron-split encoder ------------------
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh = get_mesh({"dp": dp, "tp": tp}, devices=devices)
    cfg = EncoderConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                        max_len=32, out_dim=32)
    tc = TrainConfig(warmup_steps=1, total_steps=4)
    params, opt_state, step = make_sharded_train_step(cfg, tc, mesh)
    b = max(dp * 2, 4)
    batch = {"q_ids": rng.integers(4, 512, size=(b, 16)).astype(np.int32),
             "q_mask": np.ones((b, 16), np.float32),
             "d_ids": rng.integers(4, 512, size=(b, 16)).astype(np.int32),
             "d_mask": np.ones((b, 16), np.float32)}
    params, opt_state, metrics = step(params, opt_state, batch)
    out["train_loss"] = float(metrics["loss"])
    _check(np.isfinite(out["train_loss"]), f"train loss {out['train_loss']}")

    # -- the local LLM's decoder: tensor-parallel generate over the mesh -----
    if tp > 1:
        from .models.decoder import (
            DecoderConfig,
            generate,
            init_decoder_params,
            left_pad_batch,
            shard_decoder,
            tp_generate,
        )

        dcfg = DecoderConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                             d_ff=128, max_len=64, arch="llama", dtype=torch.float32,
                             eos_token_id=0)
        dparams = init_decoder_params(dcfg, torch.Generator().manual_seed(7), device=dev0)
        toks, tmask = left_pad_batch([[3, 1, 4, 1], [5, 9, 2]] * dp, pad_id=0, bucket=False)
        toks, tmask = torch.from_numpy(toks).to(dev0), torch.from_numpy(tmask).to(dev0)
        with torch.inference_mode():
            ref, _ = generate(dparams, toks, tmask, dcfg, max_new_tokens=4)
        got, _ = tp_generate(shard_decoder(dparams, dcfg, mesh), toks, tmask, max_new_tokens=4)
        _check(torch.equal(got.cpu(), ref.cpu()), "TP-sharded decode diverged from the "
                                                   "replicated run")
        out["tp_decode_parity"] = True

    # -- retrieval: the db-sharded index -------------------------------------
    db_mesh = get_mesh({"db": n_devices}, devices=devices)
    idx = ShardedVectorIndex(32, IndexConfig(min_capacity=256, block_rows=64), mesh=db_mesh)
    chunks = [Chunk(f"c{i}", "doc", f"text {i}", i, {"i": i}) for i in range(200)]
    embs = rng.normal(size=(200, 32)).astype(np.float32)
    idx.add(chunks, embs)
    hits = idx.search(rng.normal(size=(2, 32)).astype(np.float32), top_k=5,
                      filters={"i": {"$lt": 100}})
    _check(len(hits) == 2 and len(hits[0]) == 5, "brute search")
    _check(all(c.metadata["i"] < 100 for c, _ in hits[0]), "brute filter")
    idx.build_ivf(n_lists=4)
    hits = idx.search(embs[:1], top_k=3, filters={"i": {"$lt": 100}})
    _check(bool(hits[0]) and all(c.metadata["i"] < 100 for c, _ in hits[0]), "IVF filter")
    out["ivf_top1"] = hits[0][0][0].id
    idx4 = ShardedVectorIndex(32, IndexConfig(min_capacity=256, block_rows=64,
                                              storage_dtype="int4"), mesh=db_mesh)
    nemb = embs / np.linalg.norm(embs, axis=1, keepdims=True)
    idx4.add(chunks, nemb)
    h4 = idx4.search(nemb[:1], top_k=3)
    _check(h4[0][0][0].id == "c0" and h4[0][0][1] > 0.98, f"int4 top hit {h4[0][0]}")

    # -- the dcn x ici hybrid mesh --------------------------------------------
    if n_devices >= 4 and n_devices % 2 == 0:
        hmesh = get_hybrid_mesh({"tp": 2}, {"dp": 2}, devices=devices[:4])
        params2, opt2, step2 = make_sharded_train_step(cfg, tc, hmesh)
        _, _, metrics2 = step2(params2, opt2, batch)
        out["hybrid_loss"] = float(metrics2["loss"])
        _check(np.isfinite(out["hybrid_loss"]), f"hybrid loss {out['hybrid_loss']}")
        dcn_mesh = get_hybrid_mesh({"ici": -1}, {"dcn": 2}, devices=devices)
        hidx = ShardedVectorIndex(32, IndexConfig(min_capacity=512, block_rows=64),
                                  mesh=dcn_mesh, axis=("dcn", "ici"))
        hidx.add(chunks[:100], embs[:100])
        hh = hidx.search(embs[:1], top_k=3)
        _check(bool(hh[0]) and hh[0][0][0].id == "c0", "dcn x ici index")

    # -- sequence parallelism: the ring over sp (with tp at 8k slots) --------
    f32 = dict(vocab_size=512, d_model=64, n_heads=4, d_ff=128, out_dim=32,
               dtype=torch.float32)
    if n_devices >= 4 and n_devices % 2 == 0:
        from .parallel.sequence_parallel import make_sp_encoder

        tp_kw = {}
        if n_devices % 8 == 0:
            sp_mesh = get_mesh({"dp": 2, "sp": 2, "tp": n_devices // 4}, devices=devices)
            tp_kw = {"tp_axis": "tp"}
        else:
            sp_mesh = get_mesh({"dp": 2, "sp": n_devices // 2}, devices=devices)
        sp_cfg = EncoderConfig(n_layers=2, max_len=64, **f32)
        sp_params = _on(init_encoder_params(sp_cfg, torch.Generator().manual_seed(1)), dev0)
        t = 8 * (n_devices // 2)
        ids = torch.from_numpy(rng.integers(4, 512, size=(4, t))).to(dev0)
        smask = torch.ones((4, t), device=dev0)
        with torch.no_grad():
            emb_sp, _ = make_sp_encoder(sp_cfg, sp_mesh, dp_axis="dp", **tp_kw)(sp_params, ids,
                                                                               smask)
            emb_ref, _ = encode_tokens(sp_params, ids, smask, sp_cfg)
        out["sp_err"] = _max_err(emb_sp, emb_ref)
        _check(out["sp_err"] < 1e-4, f"ring-attention parity broke: {out['sp_err']}")

    # -- pipeline parallelism: GPipe microbatches over pp --------------------
    if n_devices >= 2:
        from .parallel.pipeline_parallel import make_pp_encoder, shard_params_pp

        n_st = 4 if n_devices >= 4 else 2
        pp_mesh = get_mesh({"pp": n_st}, devices=devices[:n_st])
        pp_cfg = EncoderConfig(n_layers=n_st, max_len=32, **f32)
        pp_params = _on(init_encoder_params(pp_cfg, torch.Generator().manual_seed(2)), dev0)
        ids = torch.from_numpy(rng.integers(4, 512, size=(2 * n_st, 16))).to(dev0)
        pmask = torch.ones((2 * n_st, 16), device=dev0)
        emb_pp, _ = make_pp_encoder(pp_cfg, pp_mesh)(shard_params_pp(pp_params, pp_mesh), ids,
                                                     pmask)
        with torch.no_grad():
            emb_ref, _ = encode_tokens(pp_params, ids, pmask, pp_cfg)
        out["pp_err"] = _max_err(emb_pp, emb_ref)
        _check(out["pp_err"] < 1e-4, f"pipeline parity broke: {out['pp_err']}")

    # -- expert parallelism: the experts over ep ------------------------------
    if n_devices >= 2:
        from .models.train import MoETrainConfig, make_sharded_moe_train_step
        from .parallel.expert_parallel import (
            init_moe_params,
            make_ep_encoder,
            make_ep_encoder_a2a,
            moe_encode_tokens,
            shard_params_ep,
        )

        epn = min(4, n_devices)
        ep_mesh = get_mesh({"ep": epn}, devices=devices[:epn])
        ep_cfg = EncoderConfig(n_layers=2, max_len=32, **f32)
        n_experts = 2 * epn
        ep_params = _on(init_moe_params(ep_cfg, n_experts, torch.Generator().manual_seed(3)),
                        dev0)
        ids = torch.from_numpy(rng.integers(4, 512, size=(3, 16))).to(dev0)
        emask = torch.ones((3, 16), device=dev0)
        placed = shard_params_ep(ep_params, ep_mesh)
        with torch.no_grad():
            emb_ep, _ = make_ep_encoder(ep_cfg, ep_mesh, n_experts)(placed, ids, emask)
            emb_ref, _ = moe_encode_tokens(ep_params, ids, emask, ep_cfg, n_experts)
            out["ep_err"] = _max_err(emb_ep, emb_ref)
            _check(out["ep_err"] < 1e-4, f"expert-parallel parity broke: {out['ep_err']}")
            ids2 = torch.from_numpy(rng.integers(4, 512, size=(epn * 2, 16))).to(dev0)
            emask2 = torch.ones((epn * 2, 16), device=dev0)
            # dropless at both hops, so the parity is exact
            a2a = make_ep_encoder_a2a(ep_cfg, ep_mesh, n_experts, capacity_factor=float(epn),
                                      expert_capacity_factor=float(n_experts))
            emb_a2a, _ = a2a(placed, ids2, emask2)
            emb_ref2, _ = moe_encode_tokens(ep_params, ids2, emask2, ep_cfg, n_experts)
        out["a2a_err"] = _max_err(emb_a2a, emb_ref2)
        _check(out["a2a_err"] < 1e-4, f"a2a expert dispatch parity broke: {out['a2a_err']}")

        if n_devices >= 4:
            moe_mesh = get_mesh({"dp": n_devices // epn, "ep": epn}, devices=devices)
            moe_tc = MoETrainConfig(warmup_steps=2, total_steps=10, n_experts=n_experts,
                                    remat=False)
            mparams, mopt, mstep = make_sharded_moe_train_step(ep_cfg, moe_tc, moe_mesh)
            mbatch = {"q_ids": ids2, "q_mask": emask2, "d_ids": ids2.clone(),
                      "d_mask": emask2.clone()}
            _, _, mm = mstep(mparams, mopt, mbatch)
            out["moe_loss"], out["moe_aux_loss"] = float(mm["loss"]), float(mm["aux_loss"])
            _check(np.isfinite(out["moe_loss"]) and out["moe_aux_loss"] > 0.0,
                   f"MoE step: loss {out['moe_loss']}, aux {out['moe_aux_loss']}")
    return out


def _on(tree: dict, device) -> dict:
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
