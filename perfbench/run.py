"""The benchmark of lr2ppo_torch: runs one cell of BENCHMARK.json on the
GPUs of this machine and prints its result line (the last line of standard
output), each compared number beside its limit on standard error.

    python3 perfbench/run.py --workload ppo-b256 --seed 7 --seconds 10 --trace 0

--trace 1 reports the cell's per-layer metrics from a device trace of a few
steps instead of its end-to-end metrics. Run from the checkout's root; the
program's kernels build into the checkout at first use.
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench.common import harness

    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
