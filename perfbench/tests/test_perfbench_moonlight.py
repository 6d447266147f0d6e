"""The latent MoE cell's reference against the port at a tiny size: run in
float32 the program's steps and the reference's agree to rounding, and the
routes match; each planted fault (the shared experts left out, top 5
instead of 6, the correction bias never moved, RoPE left off k_pe, a step
that changes nothing) and the float8 control come out as not correct."""

import time

import pytest

from perfbench.common import harness
from perfbench.tests.test_perfbench_reference import float32_job
from perfbench.tests.tiny import run_tiny, tiny_job

CELL = "moe-lm-s8192"


def test_perfbench_moonlight_reference_matches_port(tmp_path):
    rc, line = run_tiny(float32_job(CELL, str(tmp_path)))
    assert rc == 0
    gaps = {k: v["value"] for k, v in line["compared"].items()}
    assert line["correct"] is True, gaps
    assert gaps["route_gap"] == 0.0


@pytest.mark.parametrize("fault", ["fault:no_shared", "fault:top5",
                                   "fault:bias_frozen", "fault:no_rope_k",
                                   "fault:state_unchanged"])
def test_perfbench_moonlight_fault_is_not_correct(fault, tmp_path):
    rc, line = run_tiny(float32_job(CELL, str(tmp_path), mode=fault))
    assert rc == 0 and line["correct"] is False


def test_perfbench_moonlight_control_is_not_correct(tmp_path):
    job = tiny_job(CELL, str(tmp_path), seconds=0.0)
    job.traffic["t_process"] = time.time()
    limits = harness.load_job(CELL, 1, 1, False).traffic["limits"]
    entry = harness.load_module("entries", job.traffic["entry"])
    got = entry.calibration(job, [entry.run(job)], True)
    failed = [k for k, v in got["control"].items() if not v <= limits[k]]
    assert failed, got["control"]
