"""Snapshots of the API's KBs across restarts and across the two packages.

A KB built and snapshotted through one package's app comes back in a new
``ApiState`` of either package over the same data dir (rehydrated from
``kbs/<name>/kb.json``, its index restored from ``snapshots/<name>``), and
both restored KBs answer the same queries alike; a bf16 KB answers as it
did before the restart. Answers are compared as ``test_torch_api``
compares responses (scores within ``TOL``, near-ties may swap)."""

from __future__ import annotations

import asyncio
import json

import pytest

from test_torch_api import assert_same, documents, normalize
from torch_api_helpers import Served, make_state, package, port_registry  # noqa: F401
from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

QUERIES = [("What is the color of Zoka?", "dense"), ("code ZX-9981", "hybrid"),
           ("launch code Vexaril", "lexical"), ("moon orbit earth", "dense")]


async def answers(state, pkg, kb: str) -> list:
    app = Served(pkg.app.create_app(state))
    try:
        out = []
        for q, mode in QUERIES:
            r = await app.fetch(f"/api/knowledge-bases/{kb}/query", "POST",
                                {"query": q, "mode": mode, "top_k": 4})
            assert r.code == 200, r.body
            out.append(normalize(json.loads(r.body), str(state.data_dir)))
        return out
    finally:
        await app.close()


async def build_and_snapshot(state, pkg, kb: str, storage_dtype: str) -> list:
    app = Served(pkg.app.create_app(state))
    try:
        cfg = {"vector_store": {"index": {"storage_dtype": storage_dtype}}}
        assert (await app.fetch("/api/knowledge-bases", "POST",
                                {"name": kb, "config": cfg})).code == 201
        r = await app.fetch(f"/api/knowledge-bases/{kb}/build", "POST", {"documents": documents()})
        assert r.code == 200, r.body
        r = await app.fetch(f"/api/knowledge-bases/{kb}/snapshot", "POST", {"action": "save"})
        assert r.code == 200, r.body
    finally:
        await app.close()
    return await answers(state, pkg, kb)


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_restores_in_either_package(writer, storage_dtype, jax_lib, port_registry):
    kb = f"snap-{writer}-{storage_dtype}"
    wpkg = package(writer)
    first = make_state(wpkg, "yrt-restore")
    before = asyncio.run(build_and_snapshot(first, wpkg, kb, storage_dtype))
    # a restart finds the JAX package's registry without the writer's KB
    package("jax").kb.GLOBAL_KB_REGISTRY.remove(kb)
    after = {}
    for reader in ("jax", "port"):
        rpkg = package(reader)
        state = make_state(rpkg, data_dir=str(first.data_dir))
        assert state.kbs.names() == [kb]
        restored = state.kbs.get(kb)
        assert asyncio.run(restored.store.count()) == asyncio.run(first.kbs.get(kb).store.count())
        assert restored.config.vector_store.index.storage_dtype == storage_dtype
        after[reader] = asyncio.run(answers(state, rpkg, kb))
    assert str(state.device) == str(restored.device) == "cpu"
    assert_same(after["port"], after["jax"], f"{writer} snapshot")
    if storage_dtype == "bfloat16":
        # the stored rows come back as they were; an int8 snapshot stores
        # the dequantized rows' codes and a load quantizes them again, in
        # both packages alike (scores move by ~1e-3)
        assert_same(after[writer], before, f"{writer} restart")
    assert [r["results"][0]["document_id"] for r in after["port"]] == [
        "zoka.md", "vault.md", "vexaril.md", "moon.md"]
