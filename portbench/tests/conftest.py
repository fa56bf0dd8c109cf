"""Shared set-up of the benchmark's CPU tests: a throwaway benchmark tree
(``tiny_tree``) whose cells are the real ones cut to a size a CPU runs in
seconds, added from files alone."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = {"model_type": "bert", "vocab_size": 30522, "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
              "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
              "hidden_act": "gelu", "pooling": "cls"}


def tiny_config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-" + name
    cfg["embedder"] = dict(TINY_MODEL)
    if "reranker" in cfg:
        cfg["reranker"] = dict(TINY_MODEL, num_labels=1)
    cfg["kb"].update(rows=8192, centres=256, texts=256, slice_rows=4096)
    # wider random weights: at 64 wide the checkpoint's 0.02 maps every text to
    # nearly one point, and a stale answer would read as right
    cfg["weights"]["std"] = 0.2
    cfg["rag"]["vector_store"]["index"]["block_rows"] = 256
    cfg["rag"]["vector_store"]["index"]["n_lists"] = 32
    cfg["rag"]["vector_store"]["index"]["n_probe"] = 8
    return cfg


def tiny_traffic(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "traffic", name + ".json")) as f:
        t = json.load(f)
    t.update(profile_s=0.3)
    if t["kind"] == "qa":
        t.update(sessions=4, check_every=2)
        t["question"]["max_words"] = 20
    else:
        t.update(docs_per_call=4, warmup_calls=1, reserve_rows=4096)
        t["doc"].update(median_chars=3000, max_chars=8000, paragraphs=64)
    return t


# set from CPU readings at these sizes (program / fp8 control, seed 11):
# emb_err 0.008 / 0.075, dense_gap 0.0005 / 0.012, score_err 0.013 (rerank) and
# 0.0008 (dense) / 0.050
TINY_LIMITS = {"missing": 0, "chunk_diff": 0, "emb_err": 0.03, "dense_gap": 0.004,
               "score_err": 0.04, "order_diff": 0, "cut_gap": 0, "lexical_diff": 0}

CELLS = {"tiny.rerank": ("pretrained-bge-base", "rerank-qa-c32"),
         "tiny.dense": ("ivf-int8-bge-base", "dense-qa-c64"),
         "tiny.ingest": ("pretrained-bge-base", "ingest-docs")}


def make_tree(dst: str) -> str:
    """A copy of the benchmark with the tiny cells added as files and
    entries only; returns its root."""
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell, (config, mix) in CELLS.items():
        cname, tname = "tiny-" + config, "tiny-" + mix
        with open(os.path.join(dst, "portbench", "configs", cname + ".json"), "w") as f:
            json.dump(tiny_config(config), f)
        with open(os.path.join(dst, "portbench", "traffic", tname + ".json"), "w") as f:
            json.dump(tiny_traffic(mix), f)
        with open(os.path.join(dst, "portbench", "limits", cell + ".json"), "w") as f:
            json.dump(TINY_LIMITS, f)
        if cname not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": cname, "source": "test", "reduced": [], "why": "test",
                                     "file": f"portbench/configs/{cname}.json"})
        real = next(w for w in bench["workloads"] if w["config"] == config and w["traffic"] == mix)
        bench["workloads"].append({"name": cell, "config": cname, "traffic": tname, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real["name"] in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("bench")))
