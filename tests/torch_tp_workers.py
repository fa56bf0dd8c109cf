"""Worker processes of the port's tensor-parallel group tests
(``tests/test_torch_decoder_tp_multiproc.py``): each rank joins a gloo
process group through a ``FileStore`` (no ports), places the seeded
decoder on a group mesh of its own CPU slot, runs ``tp_generate`` and
saves the tokens. Imports torch and the port only, so a spawned worker
starts without JAX."""

import os

import numpy as np
import torch
import torch.distributed as dist

from youtu_rag_tpu_torch.models import decoder as td
from youtu_rag_tpu_torch.parallel import get_mesh

# mode → (mesh axes, processes)
CASES = {"tp2": ({"tp": 2}, 2), "dp2_tp2": ({"dp": 2, "tp": 2}, 4)}
PROMPTS = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5, 8], [9, 7]]
NEW = 10


def model():
    """The seeded int8-KV llama (GQA, untied, q/k/v biases) every rank builds."""
    cfg = td.DecoderConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                           d_ff=128, max_len=64, arch="llama", tie_embeddings=False,
                           qkv_bias=True, eos_token_id=0, kv_cache_dtype="int8",
                           dtype=torch.float32)
    params = td.init_decoder_params(cfg, torch.Generator().manual_seed(5))
    params["layers"]["bqkv"] = 0.05 * torch.randn(params["layers"]["bqkv"].shape,
                                                  generator=torch.Generator().manual_seed(6))
    toks, mask = td.left_pad_batch(PROMPTS, pad_id=0, bucket=False)
    return cfg, params, torch.from_numpy(toks), torch.from_numpy(mask)


def run(rank: int, world: int, store_path: str, mode: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        cfg, params, toks, mask = model()
        mesh = get_mesh(CASES[mode][0], devices=["cpu"])
        tpd = td.shard_decoder(params, cfg, mesh)
        out, lengths = td.tp_generate(tpd, toks, mask, max_new_tokens=NEW)
        np.savez(os.path.join(out_dir, f"{mode}-{rank}.npz"), out=out.numpy(),
                 lengths=lengths.numpy())
    finally:
        dist.destroy_process_group()
