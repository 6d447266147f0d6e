"""The benchmark's runner: finds a cell's configuration, traffic, entry,
metric readers and FLOP counter by name, runs the cell on one chip or as one
process per chip, judges what the timed path produced, and prints the result
line.

Everything that belongs to one configuration, traffic mix, entry or metric
lives in a file of its own, found by its name:

  BENCHMARK.json            the cells and metrics
  configs/<file>            a configuration (the cell's `config` entry names it)
  traffic/<traffic>.json    a traffic mix; its "entry" names the entry file
  entries/<entry>.py        run(job) -> Result, judge(job, results) -> checks
  metrics/<metric>.py       read(obs, job) -> number or None
  flops/<config>.py         the model FLOPs a traced step needs
  reference/<family>.py     the plain PyTorch reference the judge runs

A later cell, mix, entry or metric adds files; none of these need an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lr2ppo_tpu")
# build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".perfbench_cache")


def load_module(kind: str, name: str):
    """perfbench/<kind>/<name>.py as a module (names may hold '-' and
    '.')."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"perfbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Job:
    """One run of one cell, as the command line asked for it."""

    cell: dict
    config: dict
    traffic: dict
    spec: dict
    seed: int
    seconds: float
    trace: bool
    world: int = 1
    rank: int = 0
    port: int = 0
    tmp: str = ""
    # set by a test or a calibration: the reference in the program's place
    # ("control"), or a named fault planted under the timed path
    mode: str = "program"
    # "cpu": the CPU tests' tiny runs, which skip the look for a chip
    device: str = "cuda"

    @property
    def name(self) -> str:
        return self.cell["name"]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those listing it, and
        those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]


def load_job(workload: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT) -> Job:
    spec = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = read_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    return Job(cell=cell, config=config, traffic=traffic, spec=spec,
               seed=seed, seconds=seconds, trace=trace,
               world=int(cell["chips"]))


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs() -> None:
    """The program's build and kernel caches at fixed paths in the
    checkout, so only the first run of a cell there builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    # keep libraries from loading JAX behind the program's back
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> List[str]:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_line(job: Job, peak: int) -> dict:
    import torch

    if job.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": job.world,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": job.world, "memory_peak_bytes": int(peak)}


def check_chips(world: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: this benchmark runs on a GPU"
    if torch.cuda.device_count() < world:
        return (f"the cell asks for {world} GPUs; torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


def _rank_main(rank: int, job: Job, queue) -> None:
    """A spawned rank: runs the entry and sends back its plain result."""
    job = dataclasses.replace(job, rank=rank)
    try:
        entry = load_module("entries", job.traffic["entry"])
        queue.put((rank, entry.run(job), None))
    except BaseException as e:       # reported by the parent, which exits
        import traceback

        queue.put((rank, None, traceback.format_exc()))
        if not isinstance(e, Exception):
            raise


def run_ranks(job: Job) -> List[Any]:
    """One process per chip (spawned), each running the entry with its rank;
    their results in rank order. Every process is joined."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    job = dataclasses.replace(job, port=port)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, job, queue))
             for r in range(job.world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors = []
    try:
        while len(results) + len(errors) < job.world:
            rank, res, err = queue.get(timeout=900)
            if err:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = res
    finally:
        deadline = time.time() + (60 if not errors else 5)
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 0.1))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in range(job.world)]


def metric_value(v: float, unit: str) -> dict:
    return {"value": float(v), "unit": unit}


def main(args) -> int:
    t_process = process_start()
    set_cache_dirs()
    job = load_job(args.workload, args.seed, args.seconds, bool(args.trace))
    problem = check_chips(job.world)
    if problem:
        print(problem, file=sys.stderr)
        return 3
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        job = dataclasses.replace(job, tmp=tmp)
        return run_cell(job, t_process)


def run_cell(job: Job, t_process: float, out=sys.stdout) -> int:
    """Runs the cell, judges it and prints the result line; the exit code."""
    entry = load_module("entries", job.traffic["entry"])
    job.traffic.setdefault("t_process", t_process)
    results = ([entry.run(job)] if job.world == 1 else run_ranks(job))
    checks = entry.judge(job, results)
    summary = entry.summarize(job, results)
    correct = all(c["ok"] for c in checks)
    if job.trace:
        metrics = {}
        for m in job.per_layer():
            v = load_module("metrics", m["name"]).read(summary["obs"], job)
            if v is not None:
                metrics[m["name"]] = metric_value(v, m["unit"])
    else:
        metrics = {m["name"]: metric_value(summary["e2e"][m["name"]],
                                           m["unit"])
                   for m in job.end_to_end()}
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    compared = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                for c in checks}
    line = {"correct": correct, "attempted": summary["attempted"],
            "failed": summary["failed"], "metrics": metrics,
            "device": summary["device"]}
    if job.trace:
        line["breakdown"] = summary["breakdown"]
    line["compared"] = compared
    for name, s in results[0].get("setup_parts", []):
        print(f"set-up: {name}: {s:.3f} s", file=sys.stderr)
    for c in checks:
        print(f"compared {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
