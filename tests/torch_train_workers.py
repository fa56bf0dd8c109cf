"""Worker processes of the port's multi-rank training and parallel-forward
tests (``tests/test_torch_train_multiproc.py``): each rank joins a process
group through a ``FileStore`` (no ports; gloo with one CPU slot a rank, or
NCCL with one card a rank), builds group meshes of ``parallel.mesh`` over
the ranks, runs the scenarios of its world and saves what each returns.
Imports torch and the port only, so a spawned worker starts without JAX;
``scenarios`` also runs them on a local mesh in one process, for the
comparison."""

import os

import numpy as np
import torch
import torch.distributed as dist

from youtu_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder_params
from youtu_rag_tpu_torch.models.train import (
    MoETrainConfig,
    TrainConfig,
    make_sharded_moe_train_step,
    make_sharded_train_step,
)
from youtu_rag_tpu_torch.parallel.expert_parallel import (
    init_moe_params,
    make_ep_encoder,
    make_ep_encoder_a2a,
    shard_params_ep,
)
from youtu_rag_tpu_torch.parallel.mesh import get_mesh
from youtu_rag_tpu_torch.parallel.pipeline_parallel import make_pp_encoder, shard_params_pp
from youtu_rag_tpu_torch.parallel.sequence_parallel import make_sp_encoder

KW = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=32, out_dim=16,
          dtype=torch.float32)
STEPS = 2
E = 4


def batch(seed: int, b: int = 8, t: int = 16) -> dict:
    r = np.random.default_rng(seed)
    out = {}
    for side in "qd":
        n = r.integers(4, t + 1, b)
        mask = (np.arange(t)[None] < n[:, None]).astype(np.float32)
        out[f"{side}_ids"] = torch.from_numpy((r.integers(1, 128, (b, t)) * mask).astype(np.int64))
        out[f"{side}_mask"] = torch.from_numpy(mask)
    return out


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def _steps(params, opt_state, step) -> dict:
    """Losses over STEPS steps, the gradients the first step applies and the
    parameters after the last."""
    _, grads = step.grads(params, batch(0))
    out = {f"grad:{k}": v for k, v in flat(grads).items()}
    losses, aux = [], []
    for s in range(STEPS):
        params, opt_state, m = step(params, opt_state, batch(s))
        losses.append(float(m["loss"]))
        aux.append(float(m.get("aux_loss", 0.0)))
    out.update({f"param:{k}": v for k, v in flat(params.gather()).items()})
    return {**out, "losses": np.array(losses), "aux": np.array(aux)}


def _forward(fn, params, b: int, t: int, seed: int, device) -> dict:
    inputs = batch(seed, b, t)
    with torch.no_grad():
        emb, cls = fn(params, inputs["q_ids"].to(device), inputs["q_mask"].to(device))
    return {"emb": emb.cpu().numpy(), "cls": cls.cpu().numpy()}


def _on(tree: dict, device) -> dict:
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def scenarios(world: int, devices) -> dict[str, dict]:
    """Each scenario of a world of ``world`` slots on ``devices`` (this
    process's own slot on a group mesh, every slot on a local one)."""
    cfg = EncoderConfig(**KW)
    dense = init_encoder_params(cfg, torch.Generator().manual_seed(0))
    moe = init_moe_params(cfg, E, torch.Generator().manual_seed(1))
    dev = torch.device(devices[0])
    out = {}
    if world == 4:
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, remat=True)
        out["tp"] = _steps(*make_sharded_train_step(
            cfg, tc, get_mesh({"dp": 2, "tp": 2}, devices=devices), init_params=dense))
        mtc = MoETrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, n_experts=E,
                             remat=False)
        out["ep"] = _steps(*make_sharded_moe_train_step(
            cfg, mtc, get_mesh({"dp": 2, "ep": 2}, devices=devices), init_params=moe))
        sp_mesh = get_mesh({"sp": 2, "tp": 2}, devices=devices)
        out["sp_tp"] = _forward(make_sp_encoder(cfg, sp_mesh, tp_axis="tp"), _on(dense, dev), 2,
                                16, 5, dev)
        ep_mesh = get_mesh({"ep": 4}, devices=devices)
        out["ep_psum"] = _forward(make_ep_encoder(cfg, ep_mesh, E),
                                  shard_params_ep(moe, ep_mesh), 3, 16, 6, dev)
        out["ep_a2a"] = _forward(make_ep_encoder_a2a(cfg, ep_mesh, E, capacity_factor=1.0,
                                                     expert_capacity_factor=1.0),
                                 shard_params_ep(moe, ep_mesh), 8, 16, 7, dev)
    else:
        pp_mesh = get_mesh({"pp": 2}, devices=devices)
        out["pp"] = _forward(make_pp_encoder(cfg, pp_mesh, n_micro=4),
                             shard_params_pp(dense, pp_mesh), 8, 16, 8, dev)
    return out


def run(rank: int, world: int, store_path: str, out_dir: str, backend: str = "gloo") -> None:
    """One rank: gloo on a CPU slot, or NCCL on card ``rank``."""
    torch.set_num_threads(1)
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        for name, arrays in scenarios(world, [device]).items():
            np.savez(os.path.join(out_dir, f"{name}-{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()
