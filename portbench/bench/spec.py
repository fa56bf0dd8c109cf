"""Finds a cell's parts by name: ``BENCHMARK.json``'s entry, the
configuration's file, the traffic mix's file (``traffic/<mix>.json``),
the driver of the mix's ``kind`` (``drivers/<kind>.py``), the limits of
its correctness check (``limits/<cell>.json``) and the reader of each
per-layer metric (``metrics/<metric>.py``). A new cell, configuration,
mix, kind of traffic or metric is a new file and a new entry; no code here
names one.

A driver module gives ``run(fx, win, rec)`` (async: warms up, opens the
window, drives the traffic; returns the window's raw record),
``metrics(raw, win)`` (the end-to-end readings), ``counts(raw)``
(attempted, failed) and ``check(cell, fx, rec, raw, seed, control)`` (the
compared numbers, and the control's); and it may give ``build(config,
traffic, seed, device, tmp)``, the set-up of a system other than the KB
of ``bench/fixture.py``, which is the default."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    run_seconds: int
    readers: dict = field(default_factory=dict)
    driver: object = None


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with the
    metrics it reports: the end-to-end metrics whose ``workloads`` list it
    (or that list none), and the per-layer metrics likewise."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, bench["paths"][0])
    traffic = _load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", name + ".json"))

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    cell = Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                run_seconds=int(bench["run_seconds"]))
    cell.readers = {m["name"]: reader(bench_dir, m["name"]) for m in cell.per_layer}
    cell.driver = driver(bench_dir, traffic["kind"])
    return cell


def _module(bench_dir: str, folder: str, name: str):
    path = os.path.join(bench_dir, folder, name + ".py")
    key = f"portbench_{folder}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: str, metric: str):
    """``metrics/<metric>.py``'s ``read`` function."""
    return _module(bench_dir, "metrics", metric).read


def driver(bench_dir: str, kind: str):
    """``drivers/<kind>.py``, the module that drives a mix of that kind."""
    return _module(bench_dir, "drivers", kind)
