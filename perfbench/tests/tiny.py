"""Tiny versions of the benchmark's cells for the CPU tests: the same
entries, readers and references at widths a CPU runs in seconds."""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import time

from perfbench.common import harness

TINY_MODEL = {"feat_size": 32, "seq_length": 6, "max_imgs": 4,
              "visual_feat_dim": 32, "num_heads": 4, "mlp_ratio": 2}
TINY_STORE = {"items": 40, "eval_items": 6, "tags": [2, 6], "pool": 24,
              "images": 4}
TINY_TOWER = {"emb_size": 32, "hidden_size": 32, "feedforward_size": 64,
              "heads_num": 4, "layers_num": 2, "max_seq_length": 514,
              "vocab_size": 300}


def tiny_job(cell: str, tmp: str, seed: int = 11, trace: bool = False,
             mode: str = "program", seconds: float = 0.2,
             world: int = 0) -> harness.Job:
    job = harness.load_job(cell, seed, seconds, trace)
    config, traffic = copy.deepcopy(job.config), copy.deepcopy(job.traffic)
    if "model" in config:
        config["model"].update(TINY_MODEL)
        traffic["store"] = dict(TINY_STORE)
        traffic["batch_size"] = 8 * (world or job.world)
        traffic["argv"] = traffic["argv"] + ["--num_workers", "2"]
        traffic["item_dtype"] = "float32"
        traffic["warm_sweeps"] = 2
        traffic["trace_sweeps"] = 1
    else:
        config.update(TINY_TOWER)
        traffic["corpus"] = dict(traffic["corpus"], rows=48, vocab=300)
        traffic["argv"] = [a for a in traffic["argv"]]
        traffic["seq_length"] = 16
        traffic["batch_size"] = 4
        traffic["warm_steps"] = 2
        traffic["trace_steps"] = 1
    traffic["limits"] = {k: float("inf") for k in traffic["limits"]}
    return dataclasses.replace(job, config=config, traffic=traffic,
                               device="cpu", tmp=tmp, mode=mode,
                               world=world or job.world)


def run_tiny(job: harness.Job):
    """(exit code, the result line, the checks printed)."""
    out = io.StringIO()
    rc = harness.run_cell(job, time.time(), out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
