"""Worker processes of the port's sequence-parallel group tests
(``tests/test_torch_sequence_parallel.py``): each rank joins a gloo
process group through a ``FileStore`` (no ports), runs the SP encoder on
its ring and saves what it returns. Imports torch and the port only, so a
spawned worker starts without JAX."""

import os

import numpy as np
import torch
import torch.distributed as dist

from youtu_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder_params
from youtu_rag_tpu_torch.parallel import make_sp_encoder

SMALL = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=128,
             out_dim=16, dtype=torch.float32)
FLASH = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, d_ff=128, max_len=1024,
             out_dim=16, dtype=torch.float32, attention_impl="pallas_interpret")
CASES = {  # mode → (config, batch, T, sp groups as lists of ranks)
    "sp4": (SMALL, 3, 64, [[0, 1, 2, 3]]),
    "dp2_sp2": (SMALL, 4, 32, [[0, 1], [2, 3]]),
    "sp4_flash": (FLASH, 2, 1024, [[0, 1, 2, 3]]),
}


def inputs(mode: str):
    """(config, parameters, ids [B, T], mask [B, T]) of a case, the same in
    every process: parameters from a seeded generator, ragged padding."""
    kw, b, t, _ = CASES[mode]
    cfg = EncoderConfig(**kw)
    params = init_encoder_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 256, size=(b, t)).astype(np.int64)
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        cut = t - int(rng.integers(0, t // 4 + 1))
        mask[i, cut:] = 0.0
        ids[i, cut:] = 0
    return cfg, params, torch.from_numpy(ids), torch.from_numpy(mask)


def run(rank: int, world: int, store_path: str, mode: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        cfg, params, ids, mask = inputs(mode)
        groups = [dist.new_group(ranks) for ranks in CASES[mode][3]]  # every rank makes each
        mine = next(i for i, ranks in enumerate(CASES[mode][3]) if rank in ranks)
        rows = np.array_split(np.arange(ids.shape[0]), len(groups))[mine]  # this replica's slice
        emb, cls = make_sp_encoder(cfg, groups[mine])(params, ids[rows], mask[rows])
        np.savez(os.path.join(out_dir, f"{mode}-{rank}.npz"), emb=emb.numpy(), cls=cls.numpy(),
                 rows=rows)
    finally:
        dist.destroy_process_group()
