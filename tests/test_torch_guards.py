"""The port's profiling hooks (lr2ppo_torch/utils/guards.py, counterpart of
lr2ppo_tpu/utils/guards.py): TraceWindow against the JAX package's
semantics, and stage 1 with --profile_dir, whose window (steps 10 to 20,
JAX's defaults) writes a Chrome trace on the CPU here and on rank 0 only
under a mesh. The spans and counters: tests/test_torch_tracing.py."""

import json
import os

import torch

from lr2ppo_torch.utils.guards import TraceWindow
from test_torch_parallel import spawn

torch.set_num_threads(1)


def _work():
    a = torch.randn(16, 16)
    return (a @ a).sum()


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_window_starts_at_start_and_stops_steps_later(tmp_path):
    """JAX's window: tick(start) starts the trace, tick(start + steps)
    stops it and writes the file; ticks outside the window do nothing."""
    win = TraceWindow(str(tmp_path), start=2, steps=3)
    assert (win.start, win.stop_at) == (2, 5)
    for step in range(1, 8):
        _work()
        win.tick(step)
        assert (win.prof is not None) == (2 <= step < 5), step
        assert (win.path is not None) == (step >= 5), step
    assert win.path == str(tmp_path / "trace_steps_2-5.json")
    assert "aten::mm" in _names(win.path)
    win.close()                        # a second close writes nothing new
    assert os.listdir(tmp_path) == ["trace_steps_2-5.json"]


def test_trace_window_defaults_and_close_mid_window(tmp_path):
    """Start 10, 10 steps, as JAX's; close() inside the window stops the
    trace and writes it (a fit that ends in the window)."""
    win = TraceWindow(str(tmp_path))
    assert (win.start, win.stop_at) == (10, 20)
    win.tick(10)
    _work()
    win.close()
    assert win.prof is None and os.path.exists(win.path)


def test_trace_window_without_a_dir_does_nothing(tmp_path):
    win = TraceWindow(None, start=1, steps=1)
    for step in range(4):
        win.tick(step)
    win.close()
    assert win.prof is None and win.path is None


# -- stage 1 with --profile_dir ---------------------------------------------
def _fit_traced(profile_dir, epochs, **mesh):
    from test_torch_parallel import BS, TAGS, _DS, _pw_cfg
    from lr2ppo_torch.data import EvalLoader, Loader
    from lr2ppo_torch.train.pointwise import PointwiseTrainer

    cfg = _pw_cfg(epochs=epochs, **mesh).replace(profile_dir=profile_dir,
                                                 report_steps=100)
    tr = PointwiseTrainer(cfg, device="cpu")
    m = tr.ctx.mesh
    loader = Loader(_DS(), BS, shuffle=True, seed=5, num_workers=1,
                    shard=(m.dp_rank, m.dp) if m.dp > 1 else None)
    tr.fit(loader, EvalLoader(_DS(), buckets=[TAGS], batch_size=BS))
    return tr.trace_path


def _traced_rank(rank, world, url, profile_dir):
    return _fit_traced(f"{profile_dir}/rank{rank}", 11, dp=2)


def test_stage1_profile_dir_writes_the_window(tmp_path):
    """22 steps (11 epochs of 2): the window of steps 10 to 20 is written
    as one Chrome trace holding the step's products; the refusal of
    --profile_dir is gone."""
    path = _fit_traced(str(tmp_path), 11)
    assert path == str(tmp_path / "trace_steps_10-20.json")
    assert {"aten::mm", "aten::addmm"} & _names(path)


def test_stage1_profile_dir_traces_rank_0_only(tmp_path):
    """At dp 2 only rank 0 traces (JAX's process 0 writes the trace)."""
    paths = spawn(_traced_rank, 2, tmp_path, str(tmp_path), timeout=150)
    assert paths[0] == str(tmp_path / "rank0" / "trace_steps_10-20.json")
    assert os.path.exists(paths[0])
    assert paths[1] is None and not os.path.exists(tmp_path / "rank1")
