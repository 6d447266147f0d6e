"""Entry `pretrain_fit`: tower pretraining, `PretrainTrainer.fit`, built by
`cli/pretrain.py:build` from the traffic file's flags, on one GPU.

Set-up writes a vocabulary and a corpus made from the seed (synthetic words,
Zipf-distributed; one line a row of the sequence length) under the run's
temporary directory, has the CLI's `build` tokenize it, and makes the
tower's weights on the device from the seed, which the program loads as its
--pretrained_model_path. The fit's first `warm_steps` optimizer steps are
set-up: they warm every shape, and the judge's reference follows them. The
window then runs whole steps until the first step boundary at or past
--seconds. No checkpoint is written.

What the judge compares (perfbench/reference/<family>.py follows the same
steps in float32 from the same weights and batches): each step's loss, the
first gradient of every leaf as AdamW received it (its first moment after
one step, over 1 - beta1), and each leaf's change over the warm steps. The
batches are the ones the trainer was handed, checked first against the
corpus the benchmark wrote: each row's tokens, where not masked, are one
corpus row's.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import time
from typing import Dict, List

import numpy as np

from perfbench.common import checks, chipmath
from perfbench.common.harness import device_line, load_module
from perfbench.common.probes import Probes
from perfbench.common.trace import Profiler, breakdown
from perfbench.common.window import FitWindow

PREFIX = "perfbench:"


def corpus_ids(job) -> np.ndarray:
    """The corpus as token ids, (rows, seq - 2): words drawn by Zipf's law
    over the vocabulary past its specials."""
    c = job.traffic["corpus"]
    n_special = len(job.traffic["specials"])
    rng = np.random.default_rng(job.seed)
    n = c["rows"] * (job.traffic["seq_length"] - 2)
    words = np.empty(0, np.int64)
    while len(words) < n:
        r = rng.zipf(c["zipf"], size=2 * n)
        words = np.concatenate([words, r[r <= c["vocab"] - n_special]])
    ids = words[:n] - 1 + n_special
    return ids.reshape(c["rows"], -1)


def write_inputs(job) -> dict:
    c = job.traffic["corpus"]
    specials = job.traffic["specials"]
    paths = {k: os.path.join(job.tmp, f"{k}{job.rank}.txt")
             for k in ("vocab", "corpus")}
    with open(paths["vocab"], "w", encoding="utf-8") as f:
        f.write("\n".join(specials + [f"w{i}" for i in range(
            c["vocab"] - len(specials))]) + "\n")
    n_special = len(specials)
    with open(paths["corpus"], "w", encoding="utf-8") as f:
        for row in corpus_ids(job):
            f.write(" ".join(f"w{i - n_special}" for i in row) + "\n")
    paths["tower"] = os.path.join(job.tmp, f"tower{job.rank}.json")
    with open(paths["tower"], "w") as f:
        json.dump(job.config, f)
    return paths


def make_args(job, paths: dict):
    from lr2ppo_torch.cli.pretrain import parser

    argv = list(job.traffic["argv"]) + [
        "--seq_length", str(job.traffic["seq_length"]),
        "--corpus_path", paths["corpus"], "--tower_config", paths["tower"],
        "--vocab_path", paths["vocab"], "--seed", str(job.seed),
        "--output_model_path", "", "--pretrained_model_path",
        PREFIX + "tower",
        "--log_path", os.path.join(job.tmp, f"pretrain{job.rank}.log")]
    if job.device == "cpu":
        argv += ["--device", "cpu"]
    if "batch_size" in job.traffic:
        argv += ["--batch_size", str(job.traffic["batch_size"])]
    return parser().parse_args(argv)


def make_weights(tower_cfg, seed: int, device) -> Dict[str, object]:
    from lr2ppo_torch.towers.model import TowerModel
    from perfbench.common.weights import seeded

    return seeded({"tower": TowerModel(tower_cfg, device="meta",
                                       with_target=True)}, seed,
                  device)["tower"]


def run(job) -> dict:
    import torch

    from lr2ppo_torch.cli.pretrain import build
    from lr2ppo_torch.train import pretrain as pre_mod
    from lr2ppo_torch.train.optim import AdamW

    t = job.traffic
    warm = t["warm_steps"]
    marks = [("process start", t["t_process"])]

    def mark(name):
        marks.append((name, time.time()))

    paths = write_inputs(job)
    args = make_args(job, paths)
    mark("imports, vocabulary and corpus written")
    with Probes() as probes:
        weights: dict = {}
        got = {"loss": [], "g1": [], "batches": []}

        def loader_patch(original):
            def load(path, *a, **k):
                if str(path).startswith(PREFIX):
                    return weights.pop(path[len(PREFIX):])
                return original(path, *a, **k)
            return load

        probes.patch(pre_mod, "load_tower_checkpoint", loader_patch)
        trainer, loader = build(args, args.device)
        dev = trainer.device
        mark("trainer, vocabulary read, corpus tokenised")
        weights["tower"] = make_weights(trainer.tower_cfg, job.seed, dev)
        mark("seeded weights")
        models = {}
        init_model = trainer.init_model

        def init_and_keep():
            models["tower"] = init_model()
            mark("model loaded")
            return models["tower"]

        trainer.init_model = init_and_keep

        def step_maker(make):
            def made(*a, **k):
                step = make(*a, **k)

                def wrapped(state, generator, batch):
                    if job.mode == "fault:half_batch":
                        batch = {k2: v[:v.shape[0] // 2]
                                 for k2, v in batch.items()}
                    with probes.range("step"):
                        m = step(state, generator, batch)
                    if len(got["loss"]) < warm:
                        got["loss"].append(m["loss"])
                    return m
                return wrapped
            return made

        def adamw_maker(step):
            def adamw_step(self, *a, **k):
                if job.mode == "fault:state_unchanged":
                    return None
                with probes.range("adamw"):
                    out = step(self, *a, **k)
                if self.count == 1 and not got["g1"]:
                    got["g1"].append({n: float(v.detach().double().norm())
                                      / (1 - self.b1)
                                      for n, v in self.mu.items()})
                return out
            return adamw_step

        def dropout_maker(fn):
            def apply(x, *a, **k):
                probes.record("hash_dropout", (x.numel(), x.element_size()))
                with probes.range("hash_dropout"):
                    return fn(x, *a, **k)
            return apply

        probes.patch(pre_mod, "make_pretrain_step", step_maker)
        probes.patch(AdamW, "step", adamw_maker)
        probes.patch("lr2ppo_torch.ops.hash_dropout", "_apply",
                     dropout_maker)
        trainer.ctx.put = probes.timed("put", trainer.ctx.put)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        change: dict = {}

        def on_warm():
            mark("warm steps")
            init = make_weights(trainer.tower_cfg, job.seed, dev)
            params = dict(models["tower"].named_parameters())
            change.update({k: float((params[k].detach().float() - v)
                                    .double().norm())
                           for k, v in init.items()})

        masked: List[int] = []

        def on_batch(i, batch):
            if i == 0:
                mark("loader's first batch")
            if i < warm:
                got["batches"].append({k: np.array(v) for k, v in
                                       batch.items() if not
                                       k.startswith("_")})
            if probes.tracing:
                masked.append(int((np.asarray(batch["tgt"]) > 0).sum()))

        window = FitWindow(loader, 1, warm, job.seconds,
                           t["trace_steps"] if job.trace else None, probes,
                           sync, on_warm, on_batch, None,
                           Profiler(os.path.join(job.tmp,
                                                 f"trace{job.rank}.json")))
        trainer.fit(window, args.total_steps, 0)
        sync()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        setup_s = window.wall_open - t["t_process"]
        marks.append(("the change over the warm steps", window.wall_open))
        calls = dict(probes.calls)
        tokens = (window.steps_in_window * args.batch_size
                  * args.accumulation_steps * args.seq_length)
        out = {
            "setup_s": setup_s, "window_s": window.window_s,
            "setup_parts": [[n, b - a] for (_, a), (n, b)
                            in zip(marks, marks[1:])],
            "tokens": tokens, "steps": window.steps_in_window,
            "peak": int(peak),
            "capture": {"loss": [float(v) for v in got["loss"]],
                        # an optimizer that never stepped holds zero
                        # moments: a zero gradient
                        "g1": (got["g1"][0] if got["g1"]
                               else {k: 0.0 for k in change}),
                        "change": change, "batches": got["batches"]},
            "hyper": hyper(args, trainer),
        }
        if job.trace:
            out["obs"] = observe(window, calls, job, args, sum(masked))
    del trainer, loader, window, models
    gc.collect()
    if job.device != "cpu":
        torch.cuda.empty_cache()
    return out


def hyper(args, trainer) -> dict:
    o, c = trainer.cfg.optim, trainer.tower_cfg
    return {"seed": args.seed, "compute_dtype": args.compute_dtype,
            "heads_num": c.heads_num, "hidden_size": c.hidden_size,
            "layers_num": c.layers_num, "dropout": c.dropout,
            "learning_rate": o.learning_rate, "beta1": o.beta1,
            "beta2": o.beta2, "adam_eps": o.adam_eps,
            "weight_decay": o.weight_decay, "warmup": o.warmup,
            "total_steps": args.total_steps,
            "accumulation_steps": args.accumulation_steps}


def observe(window, calls, job, args, masked: int) -> dict:
    tr = window.trace
    steps = window.steps_in_window
    flops = load_module("flops", job.cell["config"])
    return {
        "wall_s": window.window_s,
        "busy_s": tr.busy_us() / 1e6,
        "kernel_busy_s": tr.kernel_busy_us() / 1e6,
        "range_us": {name: tr.range_device_us(name) for name in tr.ranges},
        "calls": calls,
        "optimizer_steps": steps,
        "model_flops": flops.mlm_flops(
            job.config, steps * args.batch_size * args.accumulation_steps,
            args.seq_length, masked),
        "peak_flops": chipmath.STEP_PEAKS[job.config["compute_dtype"]],
        "breakdown": breakdown([tr]),
    }


def summarize(job, results: List[dict]) -> dict:
    r = results[0]
    window = r["window_s"] or 0.0
    e2e = {"pretrain_tokens_per_s": r["tokens"] / window if window else 0.0,
           "setup_s": r["setup_s"]}
    dev = device_line(job, r["peak"])
    out = {"e2e": e2e, "attempted": r["steps"], "failed": 0, "device": dev}
    if job.trace:
        out["obs"] = [r["obs"]]
        dev["busy_s"] = r["obs"]["busy_s"]
        dev["window_s"] = r["obs"]["wall_s"]
        out["breakdown"] = r["obs"]["breakdown"]
    return out


# -- the judge ------------------------------------------------------------
def check_batches(job, batches: List[dict]) -> None:
    """Every row handed to the trainer is one corpus row (with [CLS] and
    [SEP] around it) where its target does not mask it, and holds masked
    positions; raises otherwise."""
    ids = corpus_ids(job)
    index = {row[:8].tobytes(): i for i, row in enumerate(ids)}
    for b in batches:
        src, tgt = b["src"].astype(np.int64), b["tgt"].astype(np.int64)
        orig = np.where(tgt > 0, tgt, src)
        for r in range(src.shape[0]):
            body = orig[r, 1:-1]
            i = index.get(body[:8].tobytes())
            if i is None or not np.array_equal(body, ids[i]):
                raise AssertionError("a batch row is no corpus row")
        if not (tgt > 0).any():
            raise AssertionError("a batch has no masked position")


def reference_obs(job, results, batches: List[dict], prec: str) -> dict:
    import torch

    from lr2ppo_torch.towers.model import TowerConfig

    ref = load_module("reference", job.config["family"])
    dev = (torch.device("cpu") if job.device == "cpu"
           else torch.device("cuda", 0))
    h = dict(results[0]["hyper"])
    tower_cfg = TowerConfig.from_dict(job.config)
    w = make_weights(tower_cfg, job.seed, dev)
    dev_batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in batches]
    return ref.follow(w, dev_batches, h, prec)


def numbers(prog: dict, ref: dict, detail: dict = None) -> Dict[str, float]:
    """Each step's loss, relative; the first gradient's and the change's
    norms by the worst leaf (common/checks.py), the change without leaves
    whose reference gradient is under a thousandth of the median leaf's."""
    detail = {} if detail is None else detail
    detail["loss"] = list(zip(prog["loss"], ref["loss"]))
    loss = max(abs(p - r) / max(abs(r), 1e-12)
               for p, r in zip(prog["loss"], ref["loss"]))
    gr = ref["g1"]
    med = statistics.median(gr.values())
    grad = checks.worst_leaf(prog["g1"], gr, med)
    moved = {k for k, v in gr.items() if v >= 1e-3 * med}
    detail["unmoved"] = sorted(set(gr) - moved)
    cr = {k: v for k, v in ref["change"].items() if k in moved}
    cp = {k: prog["change"][k] for k in cr}
    change = checks.worst_leaf(cp, cr, statistics.median(cr.values()))
    detail["worst.grad"] = checks.worst_leaves(prog["g1"], gr, med)
    detail["worst.change"] = checks.worst_leaves(
        cp, cr, statistics.median(cr.values()))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def judge(job, results: List[dict]) -> List[dict]:
    cap = results[0]["capture"]
    check_batches(job, cap["batches"])
    ref = reference_obs(job, results, cap["batches"], "float32")
    detail: dict = {}
    got = numbers(cap, ref, detail)
    checks.report(detail)
    return checks.against(got, job.traffic["limits"])


def calibration(job, results: List[dict], control: bool) -> dict:
    cap = results[0]["capture"]
    check_batches(job, cap["batches"])
    detail: dict = {}
    ref = reference_obs(job, results, cap["batches"], "float32")
    out = {"numbers": numbers(cap, ref, detail), "detail": detail}
    if control:
        ctl = reference_obs(job, results, cap["batches"], "fp8")
        cdetail: dict = {}
        out["control"] = numbers(ctl, ref, cdetail)
        out["control_detail"] = cdetail
    return out
