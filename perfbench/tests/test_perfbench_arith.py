"""The yardstick's arithmetic against hand counts at small shapes: the FLOP
counters, the roofline bounds, the span unions and the trace reader."""

import json
import math

import pytest

from perfbench.common import chipmath, readers
from perfbench.common.harness import load_module
from perfbench.common.trace import Trace


def test_perfbench_ppo_flops_by_hand():
    flops = load_module("flops", "lr2ppo-movienet")
    m = {"feat_size": 4, "seq_length": 3, "max_imgs": 2, "mlp_ratio": 2}
    d, s, i, h, t = 4, 3, 2, 8, 2
    text = 2 * t * s * (d * h + h * d)
    img = 2 * i * (d * h + h * d)
    xit = (2 * 2 * t * s * d * d + 2 * 2 * i * d * d + 2 * 2 * t * s * i * d
           + 2 * t * s * (d * h + h * d))
    out = 2 * t * ((s + i) * d * h + h * d)
    actor = text + img + xit + out + 2 * t * d
    assert flops.scorer_flops(m, t) == actor
    k = 4
    seq = (text + img + xit + out + 2 * 4 * k * d * d + 2 * 2 * k * k * d
           + 2 * k * (d * h + h * d) + 2 * k * d)
    assert flops.scorer_flops(m, t, k) == seq
    critic = flops.scorer_flops(m, t, t)
    got = flops.ppo_flops(m, 5, t, 3, 2)
    assert got == 5 * (3 * (actor + critic + seq) + 2 * 3 * (actor + critic))


def test_perfbench_mlm_flops_by_hand():
    flops = load_module("flops", "xlmr-base")
    c = {"hidden_size": 4, "feedforward_size": 8, "layers_num": 2,
         "vocab_size": 10}
    per_token = 2 * (8 * 16 + 4 * 3 * 4 + 4 * 4 * 8)
    head = 5 * (2 * 16 + 2 * 4 * 10)
    assert flops.mlm_flops(c, 2, 3, 5) == 3 * (6 * per_token + head)


def test_perfbench_bounds_by_hand():
    b = chipmath.bound(3.35e12, 0.0, 1.0)
    assert b["bound_ms"] == pytest.approx(1e3) and b["bound_by"] == "bytes"
    b = chipmath.bound(0.0, 989e12, chipmath.BF16_TENSOR_OPS_PER_S)
    assert b["bound_ms"] == pytest.approx(1e3)
    k1 = load_module("metrics", "int8_ffn_roofline")
    rows, d, h = 100352, 768, 3072
    ms = k1.bound_ms((rows, d, h, 2))
    assert ms == pytest.approx(4 * rows * d * h / 1979e12 * 1e3)
    hd = load_module("metrics", "hash_dropout_roofline.train")
    assert hd.bound_ms((1000, 4)) is None            # inside the L2
    n = 100352 * 3072
    assert hd.bound_ms((n, 2)) == pytest.approx(4 * n / 3.35e12 * 1e3)


def test_perfbench_union_and_overlap():
    assert chipmath.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert chipmath.overlap_us([(0, 4)], [(1, 2), (3, 6)]) == 2


def test_perfbench_trace_ranges(tmp_path):
    """Kernels belong to the range in which their launch lies, whatever
    thread launched them; idle gaps name the range open on the host."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.update",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 120, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 130, "dur": 10,
         "args": {"correlation": 2}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace.load(str(path))
    assert tr.range_device_us("update") == [30.0]
    assert tr.busy_us() == 40 and tr.window_us() == 120
    gaps = tr.idle_gaps()
    assert gaps[0][0] == "host in update" and gaps[0][1] == pytest.approx(
        80e-6)
    obs = [{"range_us": {"update": [30.0]}, "updates": 1}]
    assert readers.per_occurrence_ms(obs, "update", "updates") == 0.03


def test_perfbench_shares_stay_under_100():
    """A roofline share is bound / time, never clipped: a call faster than
    its bound reads above 100 and is caught, not hidden."""
    obs = [{"calls": {"x": [1.0]}, "range_us": {"x": [500.0]}}]
    assert readers.roofline_pct(obs, "x", lambda c: 1.0) == 200.0
    assert readers.roofline_pct(obs, "x", lambda c: None) is None
    obs = [{"model_flops": 989e12, "wall_s": 2.0, "peak_flops": 989e12}]
    assert readers.mfu_pct(obs) == 50.0
    assert math.isclose(readers.idle_pct([{"kernel_busy_s": 0.75,
                                           "wall_s": 1.0}]), 25.0)
