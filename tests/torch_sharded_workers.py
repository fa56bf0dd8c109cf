"""Scenarios of the port's sharded index, run in one process on a local
mesh or in each rank of a gloo process group (``tests/test_torch_sharded_
multiproc*.py``). A rank joins through a ``FileStore`` (no ports), builds
its mesh from its own devices, runs the same SPMD program as every other
rank and writes what each search returned. Imports torch and the port
only, so a spawned worker starts without JAX."""

import json
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from youtu_rag_tpu_torch.core.config import IndexConfig
from youtu_rag_tpu_torch.core.types import Chunk
from youtu_rag_tpu_torch.index.persistence import load_index, save_index
from youtu_rag_tpu_torch.ops import kmeans as port_kmeans
from youtu_rag_tpu_torch.parallel import ShardedVectorIndex, get_hybrid_mesh, get_mesh

# a package's pieces the scenario drives (the tests pass the JAX package's)
PORT = SimpleNamespace(IndexConfig=IndexConfig, Chunk=Chunk, index=ShardedVectorIndex,
                       save=save_index, load=load_index, search={})

D = 32
# mode → (index config, processes, shards a process holds)
CASES = {
    "brute2": (dict(min_capacity=256, block_rows=32), 2, 1),
    "brute4_int8": (dict(min_capacity=256, block_rows=32, storage_dtype="int8"), 4, 1),
    "int4_2x2": (dict(min_capacity=256, block_rows=32, storage_dtype="int4"), 2, 2),
    "ivf4": (dict(min_capacity=512, block_rows=32, n_lists=8, n_probe=3, kmeans_iters=6), 4, 1),
    "ivf2_int8": (dict(min_capacity=512, block_rows=32, n_lists=8, n_probe=3, kmeans_iters=6,
                       storage_dtype="int8"), 2, 1),
    "hybrid": (dict(min_capacity=512, block_rows=32), 2, 2),
}


def unit(rng, n, d=D):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def chunks(pkg, n, doc, start=0):
    return [pkg.Chunk(f"{doc}-{i}", doc, f"t{i}", i, {"i": start + i}) for i in range(n)]


def data(mode: str):
    """The scenario's rows and queries, the same in every process."""
    rng = np.random.default_rng(3)
    if mode.startswith("ivf"):
        centers = unit(rng, 8)
        rows = np.concatenate([c[None] + 0.1 * rng.normal(size=(60, D)).astype(np.float32)
                               for c in centers])
        rows = rows[rng.permutation(len(rows))]
        return rows / np.linalg.norm(rows, axis=1, keepdims=True), centers[:4], unit(rng, 300)
    return unit(rng, 180), unit(rng, 4), unit(rng, 420)


def hits(pkg, index, q, **kw):
    return [[[c.id, float(s)] for c, s in h] for h in index.search(q, **kw, **pkg.search)]


def mesh_for(mode: str, local_devices: list):
    if mode == "hybrid":
        return get_hybrid_mesh({"ici": -1}, {"dcn": -1}, devices=local_devices), ("dcn", "ici")
    return get_mesh({"db": -1}, devices=local_devices), "db"


def compact_by_permutation(idx) -> None:
    """The group mesh's ``compact`` on one process (JAX's multi-process
    body): live rows to the front by a permutation, the stored values as
    they are, the capacity kept. ``compact`` on one process rebuilds
    instead, which re-quantizes a quantized tier."""
    live = [r for r, c in enumerate(idx._chunks) if c is not None]
    perm = np.asarray(live + [r for r, c in enumerate(idx._chunks) if c is None], np.int64)
    idx._apply_permutation(np.concatenate([perm, np.arange(idx.size, idx.capacity)]))
    idx._chunks = [idx._chunks[o] for o in perm[: len(live)]]
    idx._rebuild_host_maps()
    idx.size = idx.live_count = len(live)
    idx._clear_ivf_state()


def scenario(mode: str, mesh, axis, snapshot_dir: str, pkg=PORT, one_process=False) -> dict:
    """Every step's hits: appends that grow the index twice over (rows change
    shard), a filtered search, deletes, ``compact`` (``one_process``: its
    group-mesh body, ``compact_by_permutation``), appends after it, IVF (ivf
    modes: ``_mp_fit_assign`` on a group mesh) and a snapshot reloaded onto
    the mesh."""
    idx = pkg.index(D, pkg.IndexConfig(**CASES[mode][0]), mesh=mesh, axis=axis)
    base, q, more = data(mode)
    out = {"capacity": []}
    idx.add(chunks(pkg, len(base), "a"), base)
    out["capacity"].append(idx.capacity)
    out["first"] = hits(pkg, idx, q, top_k=6)
    out["filtered"] = hits(pkg, idx, q, top_k=5, filters={"i": {"$lt": 100}})
    idx.add(chunks(pkg, len(more), "b"), more)
    out["capacity"].append(idx.capacity)
    out["grown"] = hits(pkg, idx, np.concatenate([q, more[:2]]), top_k=6)
    # stored rows read back (on a group mesh from every process's shards)
    view = np.asarray(idx.dequantized_rows(idx.size - 3, 3))[:, :4]
    out["dequantized"] = [[["row", float(x)] for x in view.reshape(-1)]]
    if mode.startswith("ivf"):
        idx.build_ivf()
        out["ivf"] = hits(pkg, idx, q, top_k=6, filters={"i": {"$lt": 200}})
        novel = unit(np.random.default_rng(9), 1)
        idx.add(chunks(pkg, 1, "novel"), novel)
        out["novel"] = hits(pkg, idx, np.concatenate([novel, q]), top_k=6)
    dead = [f"a-{i}" for i in range(0, len(base), 2)] + [f"b-{i}" for i in range(0, 300, 3)]
    idx.delete(dead)
    out["deleted"] = hits(pkg, idx, q, top_k=6)
    compact_by_permutation(idx) if one_process else idx.compact()
    out["size"] = [idx.size, idx.count(), idx.capacity]
    out["compacted"] = hits(pkg, idx, q, top_k=6)
    idx.add(chunks(pkg, 40, "c"), base[:40] * -1.0)
    out["after"] = hits(pkg, idx, np.concatenate([q, -base[:2]]), top_k=6)
    if axis == "db":  # load_index reloads onto a mesh's db axis (both packages)
        path = os.path.join(snapshot_dir, "index")
        pkg.save(idx, path)
        out["reloaded"] = hits(pkg, pkg.load(path, mesh=mesh), q, top_k=6)
    return out


def run(rank: int, world: int, store_path: str, mode: str, out_dir: str, init=None) -> None:
    """One rank of ``mode``; ``init``: the k-means init rows to start from
    (the JAX package's draw, for IVF parity)."""
    torch.set_num_threads(1)
    if init is not None:
        port_kmeans.kmeans_init = lambda n, n_clusters, seed: np.asarray(init)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh, axis = mesh_for(mode, ["cpu"] * CASES[mode][2])
        snap = os.path.join(out_dir, f"{mode}-snap-{rank}")
        os.makedirs(snap, exist_ok=True)
        got = scenario(mode, mesh, axis, snap)
        with open(os.path.join(out_dir, f"{mode}-{rank}.json"), "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


SPAWN_TIMEOUT_S = 120


def spawn(mode: str, tmp_path, init=None) -> list[dict]:
    """Run ``mode`` on gloo in its processes, spawned; fail after
    SPAWN_TIMEOUT_S. Returns each rank's steps."""
    import time

    import pytest
    import torch.multiprocessing as mp

    world = CASES[mode][1]
    store = str(tmp_path / f"store-{mode}")
    ctx = mp.start_processes(run, args=(world, store, mode, str(tmp_path), init), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"{mode}: the {world} gloo processes did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(world):
        with open(tmp_path / f"{mode}-{r}.json") as f:
            outs.append(json.load(f))
    return outs
