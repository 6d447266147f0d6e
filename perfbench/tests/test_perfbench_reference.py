"""Each plain reference against the port at a small size: run in float32
(float32 moments) the program's steps and the reference's agree to
rounding, so the numbers the judge compares in bfloat16 measure the
program's precision and nothing else; the planted faults and the control
then come out as not correct."""

import time

import pytest

from perfbench.common import harness
from perfbench.tests.tiny import run_tiny, tiny_job

FLOAT32_LIMIT = 1e-4


def float32_job(cell, tmp, **kw):
    job = tiny_job(cell, tmp, **kw)
    job.config["compute_dtype"] = "float32"
    argv = [a if a != "bfloat16" else "float32" for a in job.traffic["argv"]]
    if job.traffic["entry"] == "ppo_fit":
        argv += ["--moment_dtype", "float32"]
    job.traffic["argv"] = argv
    job.traffic["limits"] = {k: FLOAT32_LIMIT for k in job.traffic["limits"]}
    return job


@pytest.mark.parametrize("cell", ["ppo-b256", "mlm-s512"])
def test_perfbench_reference_matches_port(cell, tmp_path):
    rc, line = run_tiny(float32_job(cell, str(tmp_path)))
    assert rc == 0
    gaps = {k: v["value"] for k, v in line["compared"].items()}
    assert line["correct"] is True, gaps


FAULTS = {"ppo-b256": ["fault:half_batch", "fault:state_unchanged",
                       "fault:answer"],
          "mlm-s512": ["fault:half_batch", "fault:state_unchanged"]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_perfbench_fault_is_not_correct(cell, fault, tmp_path):
    """A run with its timed path broken underneath reads as not correct."""
    rc, line = run_tiny(float32_job(cell, str(tmp_path), mode=fault))
    assert rc == 0 and line["correct"] is False


def test_perfbench_no_exchange_is_not_correct(tmp_path):
    """dp over 2 gloo ranks with the gradient all-reduce left out."""
    rc, line = run_tiny(float32_job("ppo-b256", str(tmp_path), world=2,
                                    mode="fault:no_exchange"))
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("cell", ["ppo-b256", "mlm-s512"])
def test_perfbench_control_is_not_correct(cell, tmp_path):
    """The reference at the next lower precision (float8 products, int4
    for int8) in the program's place fails one of the cell's limits, as it
    does on the chip at the cell's own size."""
    job = tiny_job(cell, str(tmp_path), seconds=0.0)
    job.traffic["t_process"] = time.time()
    limits = harness.load_job(cell, 1, 1, False).traffic["limits"]
    entry = harness.load_module("entries", job.traffic["entry"])
    got = entry.calibration(job, [entry.run(job)], True)
    failed = [k for k, v in got["control"].items() if not v <= limits[k]]
    assert failed, got["control"]
