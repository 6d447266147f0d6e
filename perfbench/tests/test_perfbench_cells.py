"""Every cell of BENCHMARK.json end to end at a tiny size on the CPU: the
entry, the window, the judge with its reference, the readers; the result
line carries the contract's keys and the cell's metrics."""

import json
import os

import pytest

from perfbench.common import harness
from perfbench.tests.tiny import run_tiny, tiny_job

SPEC = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [c["name"] for c in SPEC["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_perfbench_cell_untraced(cell, tmp_path):
    job = tiny_job(cell, str(tmp_path), world=min(
        2, harness.load_job(cell, 1, 1, False).world))
    rc, line = run_tiny(job)
    assert rc == 0
    assert KEYS <= set(line)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in job.end_to_end()}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "compared"
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_perfbench_cell_traced(cell, tmp_path):
    job = tiny_job(cell, str(tmp_path), trace=True, world=min(
        2, harness.load_job(cell, 1, 1, False).world))
    rc, line = run_tiny(job)
    assert rc == 0 and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: only host-clock and count metrics read
    names = {m["name"] for m in job.per_layer()}
    assert set(line["metrics"]) <= names


def test_perfbench_contract_shape():
    """BENCHMARK.json keeps the contract's keys and names."""
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic",
                                           w["traffic"] + ".json"))
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
