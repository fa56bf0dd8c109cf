"""The harness runs cells it finds by name, added from files alone: the
tiny copies of the three cells (``conftest.make_tree``) on the CPU, the
end-to-end run and the traced run, each correct, each line shaped as the
benchmark's contract has it."""

import json
import os

import pytest

from portbench.bench import harness, spec

from .conftest import CELLS, TINY_LIMITS, make_tree, tiny_traffic


def run_line(root, name, seed, trace, control=False):
    cell = spec.load(name, root)
    out = harness.run(cell, seed, 3.0, trace, "cpu", control=control)
    return cell, out, harness.result_line(cell, out, trace, "cpu")


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct(tiny_tree, name, trace):
    cell, out, line = run_line(tiny_tree, name, 2**31 + 17, trace)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    json.dumps(line)
    if trace:
        # every per-layer metric this cell lists that a CPU run can read
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert line["metrics"]["setup_s"]["value"] > 0
    assert line["attempted"] > 0 and line["failed"] == 0


def test_cell_found_from_files_alone(tiny_tree):
    cell = spec.load("tiny.dense", tiny_tree)
    assert cell.config["name"] == "tiny-ivf-int8-bge-base"
    assert cell.traffic["sessions"] == 4
    assert "step_mfu.query" in cell.readers and "rerank_ms.query" not in cell.readers
    with pytest.raises(KeyError):
        spec.load("no-such-cell", tiny_tree)


OPEN_LOOP = '''"""Open loop: question i is due at the i-th arrival of a Poisson
stream of ``rate`` a second drawn from the seed; its latency runs from the
due time."""

import asyncio
import time

import numpy as np

from portbench.bench.fixture import Fixture
from portbench.drivers import qa

metrics, counts, check = qa.metrics, qa.counts, qa.check


def build(config, traffic, seed, device, tmp):
    fx = Fixture(config, traffic, seed, device, tmp).build()
    fx.split["open_loop"] = 0.0
    return fx


async def run(fx, win, rec):
    questions = await qa.prepare(fx, win, rec)
    gaps = np.random.default_rng([fx.seed, 5]).exponential(1.0 / fx.traffic["rate"], 100000)
    lat = []
    tasks = win.open(rec)
    due = (win.start + np.cumsum(gaps)).tolist()
    n = int(np.searchsorted(due, win.end))

    async def one(i):
        await asyncio.sleep(max(due[i] - time.perf_counter(), 0.0))
        await qa.ask(fx, rec, questions[i % len(questions)], i)
        lat.append((i, due[i], time.perf_counter()))

    await asyncio.gather(*(one(i) for i in range(n)))
    for t in tasks:
        await t
    return {"latencies": lat, "questions": questions, "issued": n, "coalescers": {}}
'''


def test_new_kind_of_traffic_from_files_alone(tmp_path):
    """An open-loop kind of traffic, added as a driver file, a mix file, a
    limits file and entries in BENCHMARK.json, runs and is judged with no
    edit to a harness file."""
    root = make_tree(str(tmp_path))
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "drivers", "open-poisson.py"), "w") as f:
        f.write(OPEN_LOOP)
    mix = dict(tiny_traffic("rerank-qa-c32"), kind="open-poisson", rate=40.0)
    with open(os.path.join(bench_dir, "traffic", "tiny-open.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "limits", "tiny.open.json"), "w") as f:
        json.dump(TINY_LIMITS, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.open", "config": "tiny-pretrained-bge-base",
                               "traffic": "tiny-open", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "tiny.rerank" in m.get("workloads", []):
            m["workloads"].append("tiny.open")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell, out, line = run_line(root, "tiny.open", 2**31 + 3, False)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    assert "open_loop" in line["setup_split_s"]  # the driver's own set-up ran
    # open loop: about rate x seconds questions, whatever the program's speed
    assert 60 <= line["attempted"] <= 180
