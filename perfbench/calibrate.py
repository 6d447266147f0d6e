"""Readings that a cell's limits are set from, on the chip: the program's
compared numbers over many seeds, the control's (the reference at the next
lower precision in the program's place) and each planted fault's, one JSON
line a reading. The benchmark's runs do not run this.

    python3 perfbench/calibrate.py --workload ppo-b256 --seeds 1:13 \\
        --control 1:4 --faults fault:half_batch,fault:answer --fault_seeds 1:4 \\
        --out calibration.jsonl

Seeds a:b are a .. b-1, offset by --base. Each reading runs the cell's
set-up and its first steps (no window) in this process.
"""

import argparse
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time


def seeds(spec: str, base: int):
    if not spec:
        return []
    a, b = (int(x) for x in spec.split(":"))
    return [base + s for s in range(a, b)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault_seeds", default="")
    p.add_argument("--base", type=int, default=2_200_000_000)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from perfbench.common import harness

    harness.set_cache_dirs()
    control = set(seeds(args.control, args.base))
    plan = [("program", s) for s in seeds(args.seeds, args.base)]
    plan += [(f, s) for f in filter(None, args.faults.split(","))
             for s in seeds(args.fault_seeds, args.base)]
    with open(args.out, "a") as out, tempfile.TemporaryDirectory() as tmp:
        for mode, seed in plan:
            t0 = time.time()
            job = harness.load_job(args.workload, seed, 0.0, False)
            job = dataclasses.replace(job, tmp=tmp, mode=mode)
            job.traffic["t_process"] = t0
            entry = harness.load_module("entries", job.traffic["entry"])
            results = ([entry.run(job)] if job.world == 1
                       else harness.run_ranks(job))
            got = entry.calibration(job, results,
                                    mode == "program" and seed in control)
            got.update(mode=mode, seed=seed, seconds=time.time() - t0,
                       setup_s=results[0].get("setup_s"))
            out.write(json.dumps(got) + "\n")
            out.flush()
            print(json.dumps({k: got[k] for k in ("mode", "seed", "numbers")}
                             | ({"control": got["control"]}
                                if "control" in got else {})), flush=True)
            del results, got
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
