"""Runs one cell of BENCHMARK.json traced, as `run.py --trace 1` does, and
prints after its result line one more JSON line: the traced window's idle
time split by the program's span its fit thread was in
(common/program_trace.py), and the host-to-device MB a batch.

    python3 perfbench/idle_split.py --workload ppo-b256 --seed 7 --seconds 15

The harness's readers do not see the program's spans: `Trace.load` keeps
only the benchmark's own ranges. This script wraps `Trace.load` and the
entry's `observe` for the length of the run to read them from the same
trace file. One-chip cells only (a rank in a process of its own is not
wrapped).
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile


def traced(job, t_process, out=sys.stdout) -> int:
    """run_cell(job) under --trace 1 with the split read; prints the split's
    line after the result line and returns the exit code."""
    from perfbench.common import harness, program_trace, trace

    job = dataclasses.replace(job, trace=True)
    load = trace.Trace.load.__func__
    entry = harness.load_module("entries", job.traffic["entry"])
    observe = entry.observe
    found = {}

    def load_with_spans(cls, path):
        tr = load(cls, path)
        found["spans"] = program_trace.load_spans(path)
        found["end_us"] = program_trace.trace_end(path)
        return tr

    def observe_with_split(window, *a, **k):
        obs = observe(window, *a, **k)
        found["split"] = program_trace.idle_split(
            window.trace.ops, found["spans"], found["end_us"],
            window.window_s)
        found["idle_share"] = 100.0 * (1.0 - obs["kernel_busy_s"]
                                       / obs["wall_s"])
        found["obs"] = obs
        return obs

    trace.Trace.load = classmethod(load_with_spans)
    entry.observe = observe_with_split
    try:
        rc = harness.run_cell(job, t_process, out=out)
    finally:
        trace.Trace.load = classmethod(load)
        entry.observe = observe
    line = {"idle_share": found.get("idle_share"),
            "idle_split": found.get("split")}
    if "obs" in found:
        for name in ("h2d.bytes", "h2d.pageable_bytes"):
            line[name + "_mb"] = program_trace.per_batch_mb(
                [found["obs"]], name)
    print(json.dumps(line), file=out, flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench.common import harness

    t_process = harness.process_start()
    harness.set_cache_dirs()
    job = harness.load_job(args.workload, args.seed, args.seconds, True)
    problem = harness.check_chips(job.world)
    if problem:
        print(problem, file=sys.stderr)
        return 3
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        return traced(dataclasses.replace(job, tmp=tmp), t_process)


if __name__ == "__main__":
    sys.exit(main())
