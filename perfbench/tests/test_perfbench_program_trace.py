"""The program's spans and counters as the benchmark reads them
(common/program_trace.py, idle_split.py): the idle split of a hand-built
Chrome trace, the per-batch host-to-device readers, and the split's script
on a tiny cell."""

import io
import json
import sys

import pytest

from perfbench.common import program_trace
from perfbench.common.trace import Trace
from perfbench.tests.tiny import tiny_job


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_perfbench_idle_split_by_the_fit_threads_innermost_span(tmp_path):
    """A 200 us window ending at the last CUDA call (160): kernels at
    10-20, 70-75 (launched from autograd's thread) and 140-150. The gap
    20-70 crosses ppo.step's and ppo.sweep's own time into ppo.update and
    optim.step; 100-130 waits for data; 130-140, 150-160 and the window
    before the first span are unspanned; a loader thread's span open all
    along takes nothing. The parts add up to the idle share, 87.5%."""
    ev = [
        _x("lr2ppo.ppo.step", "user_annotation", 0, 100),
        _x("lr2ppo.ppo.sweep", "user_annotation", 40, 60),
        _x("lr2ppo.ppo.update", "user_annotation", 50, 40),
        _x("lr2ppo.optim.step", "user_annotation", 60, 20),
        _x("lr2ppo.data.wait", "user_annotation", 100, 30),
        _x("lr2ppo.data.wait", "user_annotation", 0, 200, tid=2),
        _x("bench.update", "user_annotation", 50, 40),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 65, 1, tid=3, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 135, 1, correlation=3),
        _x("cudaDeviceSynchronize", "cuda_runtime", 150, 10),
        _x("k1", "kernel", 10, 10, tid=7, correlation=1),
        _x("k2", "kernel", 70, 5, tid=7, correlation=2),
        _x("k3", "kernel", 140, 10, tid=7, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace.load(str(path))
    spans = program_trace.load_spans(str(path))
    assert program_trace.fit_thread(spans) == 1
    end = program_trace.trace_end(str(path))
    assert end == 160
    got = program_trace.idle_split(tr.ops, spans, end, 200e-6)
    assert got["groups"] == pytest.approx(
        {"data": 15.0, "compute": 17.5, "trainer": 25.0, "unspanned": 30.0})
    idle = 100 * (1 - tr.kernel_busy_us() / 200)
    assert got["idle_pct"] == pytest.approx(idle) == pytest.approx(87.5)
    assert got["by_span"] == pytest.approx(
        {"(none)": 0.06, "data.wait": 0.03, "ppo.step": 0.03,
         "ppo.sweep": 0.02, "ppo.update": 0.02, "optim.step": 0.015})
    # the benchmark's own ranges are read as before
    assert tr.range_device_us("update") == [5.0]
    # no kernel, no split
    assert program_trace.idle_split([], spans, end, 200e-6) is None


def test_perfbench_h2d_readers_read_the_programs_counter(monkeypatch):
    from perfbench.common.harness import load_module
    import lr2ppo_torch.utils as utils

    mb = load_module("metrics", "host.h2d_mb.train")
    pageable = load_module("metrics", "host.h2d_pageable_mb.train")
    obs = [{"rollouts": 4}]
    monkeypatch.setattr(utils, "counters", lambda: {
        "h2d.bytes": 4 * 160_400_000, "h2d.pageable_bytes": 2 * 1_000_000})
    assert mb.read(obs, None) == 160.4
    assert pageable.read(obs, None) == 0.5
    # ranks in processes of their own: nothing counted in this one
    assert mb.read(obs * 2, None) is None
    monkeypatch.setattr(utils, "counters", lambda: {})
    assert mb.read(obs, None) is None
    # a program without the counters
    monkeypatch.setitem(sys.modules, "lr2ppo_torch.utils", None)
    assert mb.read(obs, None) is None


def test_perfbench_idle_split_script_on_a_tiny_cell(tmp_path, monkeypatch):
    """The script's run of a tiny ppo-b256 on the CPU: the result line as
    run.py prints it, then the split's line (no device trace on the CPU:
    no split) with the window's bytes a batch, equal in both counters."""
    import time

    from lr2ppo_torch.utils import guards
    from perfbench import idle_split

    monkeypatch.setattr(guards, "_counts", {})
    job = tiny_job("ppo-b256", str(tmp_path), trace=True)
    out = io.StringIO()
    assert idle_split.traced(job, time.time(), out=out) == 0
    result, split = [json.loads(x) for x in out.getvalue().splitlines()[-2:]]
    assert result["correct"] is True
    assert split["idle_split"] is None
    assert split["h2d.bytes_mb"] == split["h2d.pageable_bytes_mb"] > 0
    assert result["metrics"]["host.h2d_mb.train"]["value"] == \
        split["h2d.bytes_mb"]
