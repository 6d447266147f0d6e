"""Entry `lm_fit`: causal-LM pretraining of a latent MoE tower (the
DeepSeek-V3 block: multi-head latent attention, a sigmoid router over
fine-grained experts with shared experts), `PretrainTrainer.fit` built by
`cli/pretrain.py:build` from the traffic file's flags (`--data_processor
lm`), on one GPU.

Set-up writes a vocabulary and a corpus of documents made from the seed
(lognormal lengths, words drawn by Zipf's law over the vocabulary past its
specials; one line a document), has the CLI's `build` tokenize and pack it
(the lm processor packs the documents across row boundaries, [CLS] first in
each row), and makes the tower's weights on the device from the seed,
which the program loads as its --pretrained_model_path (the correction
biases start at 0). It raises at once where the tower it built holds no
latent attention or MoE layer: a program that reads no latent MoE keys
would build a dense tower instead. The fit's first `warm_steps` optimizer
steps are set-up; the judge's reference follows them. The window then runs
whole steps until the first step boundary at or past --seconds. No
checkpoint is written.

What the judge compares (reference/moonlight_lm.py follows the same steps
in float32 from the same weights and batches): each step's loss (the LM
loss plus the balance loss), the first gradient of every leaf as AdamW
received it, each leaf's change over the warm steps (common/checks.py, as
pretrain_fit; a MoE layer's held experts pooled into one leaf a
projection, `pooled`), `route_gap`: over the first step's first
micro-batch and every MoE layer, the share of (token, choice) pairs on held
experts, the program's and the reference's, that the other side did not
choose, and `bias_gap`: the worst MoE layer's correction bias after the
warm steps against the reference's, relative. The
batches are the ones the trainer was handed, checked first against the
corpus: each row's targets are one contiguous slice of the packed stream,
and its source the same slice one token later, after [CLS].

Under --trace 1 the observations hold the program's own spans
(`lr2ppo.<name>`, utils/guards.py) beside the benchmark's ranges, and its
counters; every attention call of the traced steps must have taken the
attention kernel.
"""

from __future__ import annotations

import gc
import json
import os
import time
from typing import Dict, List

import numpy as np

from perfbench.common import chipmath, program_trace
from perfbench.common.harness import load_module
from perfbench.common.probes import Probes
from perfbench.common.trace import Profiler, Trace, breakdown
from perfbench.common.window import FitWindow

pretrain_fit = load_module("entries", "pretrain_fit")
PREFIX = pretrain_fit.PREFIX
make_args = pretrain_fit.make_args
summarize = pretrain_fit.summarize
SPAN = "lr2ppo."


def documents(job) -> List[np.ndarray]:
    """The corpus's documents as token ids: lognormal word counts (median
    `doc_median`, sigma `doc_sigma`), words by Zipf's law over the ids past
    the specials, until the documents fill `rows` rows of seq + 1."""
    c = job.traffic["corpus"]
    n_special = len(job.traffic["specials"])
    rng = np.random.default_rng(job.seed)
    need = c["rows"] * (job.traffic["seq_length"] + 1)
    lens = np.empty(0, np.int64)
    while (lens + 1).sum() < need:
        drawn = rng.lognormal(np.log(c["doc_median"]), c["doc_sigma"], 256)
        lens = np.concatenate([lens, np.maximum(1, np.rint(drawn))
                               .astype(np.int64)])
    lens = lens[:int(np.searchsorted(np.cumsum(lens + 1), need)) + 1]
    n = int(lens.sum())
    words = np.empty(0, np.int64)
    while len(words) < n:
        r = rng.zipf(c["zipf"], size=n + n // 4)
        words = np.concatenate([words, r[r <= c["vocab"] - n_special]])
    ids = words[:n] - 1 + n_special
    return np.split(ids, np.cumsum(lens)[:-1])


def stream(job, sep_id: int) -> np.ndarray:
    """The packed stream: each document followed by [SEP]."""
    return np.concatenate([np.append(d, sep_id) for d in documents(job)])


def write_inputs(job) -> dict:
    c = job.traffic["corpus"]
    specials = job.traffic["specials"]
    paths = {k: os.path.join(job.tmp, f"{k}{job.rank}.txt")
             for k in ("vocab", "corpus")}
    with open(paths["vocab"], "w", encoding="utf-8") as f:
        f.write("\n".join(specials + [f"w{i}" for i in range(
            c["vocab"] - len(specials))]) + "\n")
    words = np.array([f"w{i - len(specials)}" if i >= len(specials)
                      else "" for i in range(c["vocab"])], dtype=object)
    with open(paths["corpus"], "w", encoding="utf-8") as f:
        for d in documents(job):
            f.write(" ".join(words[d]) + "\n")
    paths["tower"] = os.path.join(job.tmp, f"tower{job.rank}.json")
    with open(paths["tower"], "w") as f:
        json.dump(job.config, f)
    return paths


def make_weights(model_cfg, seed: int, device) -> Dict[str, object]:
    """The seeded parameters (pretrain_fit's rules) and the MoE layers'
    correction biases at 0."""
    import torch

    w = pretrain_fit.make_weights(model_cfg, seed, device)
    for i in range(model_cfg.first_k_dense_replace, model_cfg.layers_num):
        w[f"encoder.transformer.{i}.mlp.gate.e_score_correction_bias"] = \
            torch.zeros(model_cfg.n_router, device=device)
    return w


def check_tower(model) -> None:
    """Raises unless the tower holds latent attention and MoE layers."""
    kinds = {type(m).__name__ for m in model.modules()}
    if not {"LatentAttention", "MoeFeedForward"} <= kinds:
        raise SystemExit(
            "the program built no latent attention or MoE layer from the "
            "latent MoE configuration (it read none of its keys)")


class SpanProfiler(Profiler):
    """The benchmark's profiler, whose trace also keeps the program's own
    spans as ranges named `lr2ppo.<name>` (every thread's)."""

    def stop(self) -> Trace:
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            tr = Trace.load(self.path)
            for spans in program_trace.load_spans(self.path).values():
                for start, end, name in spans:
                    tr.ranges.setdefault(SPAN + name, []).append((start, end))
            for spans in tr.ranges.values():
                spans.sort()
            return tr
        finally:
            os.remove(self.path)


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
        got = {"loss": [], "g1": [], "batches": [], "routes": []}

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
        cfg = trainer.tower_cfg
        if not hasattr(cfg, "kv_lora_rank"):
            raise SystemExit("the program's tower config read no latent MoE "
                             f"key: {type(cfg).__name__}")
        weights["tower"] = make_weights(cfg, job.seed, dev)
        mark("seeded weights")
        models = {}
        init_model = trainer.init_model

        def init_and_keep():
            models["tower"] = init_model()
            check_tower(models["tower"])
            mark("model loaded")
            return models["tower"]

        trainer.init_model = init_and_keep
        from lr2ppo_torch.ops import mla_attention as attn_mod
        from lr2ppo_torch.towers import mla as mla_mod
        from lr2ppo_torch.towers import moe as moe_mod
        from lr2ppo_torch.utils.remat import recomputing

        n_moe = cfg.layers_num - cfg.first_k_dense_replace

        def route_maker(route):
            def chosen(scores, bias, k, *a, **kw):
                if job.mode == "fault:top5":
                    k = k - 1
                idx, w = route(scores, bias, k, *a, **kw)
                # the first step's first micro-batch, each MoE layer once
                if (not got["loss"] and not recomputing()
                        and len(got["routes"]) < n_moe):
                    got["routes"].append(idx.to(torch.uint8).cpu())
                return idx, w
            return chosen

        probes.patch(moe_mod, "route", route_maker)
        if job.mode == "fault:bias_frozen":
            probes.patch(moe_mod.MoeFeedForward, "update_bias",
                         lambda f: lambda self: self.load.zero_())
        if job.mode == "fault:no_rope_k":
            probes.patch(mla_mod, "apply_rope", lambda f: lambda x, c, s: (
                f(x, c, s) if x.dim() == 4 else x.float()))
        if job.mode == "fault:no_shared":
            probes.patch(moe_mod.MoeFeedForward, "__init__", shared_off)

        def step_maker(make):
            def made(*a, **k):
                step = make(*a, **k)

                def wrapped(state, generator, batch):
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

        def kernel_maker(rng):
            def made(launch_fn):
                def launch(q, k, v, *rest):
                    probes.record(rng, (q.shape[0], q.shape[1], q.shape[2],
                                        q.shape[3], v.shape[3]))
                    with probes.range(rng):
                        return launch_fn(q, k, v, *rest)
                return launch
            return made

        probes.patch(attn_mod, "_launch_fwd", kernel_maker("mla_fwd"))
        probes.patch(attn_mod, "_launch_bwd", kernel_maker("mla_bwd"))
        probes.patch(pre_mod, "make_pretrain_step", step_maker)
        probes.patch(AdamW, "step", adamw_maker)
        trainer.ctx.put = probes.timed("put", trainer.ctx.put)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        change: dict = {}
        biases: dict = {}

        def on_warm():
            mark("warm steps")
            init = make_weights(cfg, job.seed, dev)
            params = dict(models["tower"].named_parameters())
            change.update({k: float((params[k].detach().float() - v)
                                    .double().norm())
                           for k, v in init.items() if k in params})
            biases.update({k: v.detach().float().cpu().clone() for k, v in
                           models["tower"].state_dict().items()
                           if k.endswith("e_score_correction_bias")})

        def on_batch(i, batch):
            if i == 0:
                mark("loader's first batch")
            if i < warm:
                got["batches"].append({k: np.array(v) for k, v in
                                       batch.items() if not
                                       k.startswith("_")})

        window = FitWindow(loader, 1, warm, job.seconds,
                           t["trace_steps"] if job.trace else None, probes,
                           sync, on_warm, on_batch, None,
                           SpanProfiler(os.path.join(job.tmp,
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
                        "g1": (got["g1"][0] if got["g1"]
                               else {k: 0.0 for k in change}),
                        "change": change, "batches": got["batches"],
                        "routes": got["routes"], "biases": biases},
            "hyper": hyper(args, trainer),
        }
        if job.trace:
            out["obs"] = observe(window, calls, job, args,
                                 out["hyper"]["tower"])
    del trainer, loader, window, models
    gc.collect()
    if job.device != "cpu":
        torch.cuda.empty_cache()
    return out


def shared_off(init):
    """MoeFeedForward.__init__ whose shared experts return zeros (a planted
    fault)."""
    def build(self, *a, **k):
        import torch

        init(self, *a, **k)
        self.shared_experts.forward = torch.zeros_like
    return build


def hyper(args, trainer) -> dict:
    import dataclasses

    h = pretrain_fit.hyper(args, trainer)
    cfg = trainer.tower_cfg
    h["tower"] = dict(dataclasses.asdict(cfg), held_experts=cfg.held(),
                      router_experts=cfg.n_router)
    return h


def observe(window, calls, job, args, tower: dict) -> dict:
    from lr2ppo_torch.ops.mla_attention import mla_attention
    from lr2ppo_torch.utils import counters

    tr = window.trace
    steps = window.steps_in_window
    flops = load_module("flops", job.cell["config"])
    mla_calls = len(tr.ranges.get(SPAN + "attn.mla", []))
    kernel_calls = len(calls.get("mla_fwd", []))
    if job.device != "cpu" and mla_calls != kernel_calls:
        raise AssertionError(f"{mla_calls} attention calls traced, "
                             f"{kernel_calls} of them through the kernel")
    return {
        "wall_s": window.window_s,
        "busy_s": tr.busy_us() / 1e6,
        "kernel_busy_s": tr.kernel_busy_us() / 1e6,
        "range_us": {name: tr.range_device_us(name) for name in tr.ranges},
        "calls": calls,
        "optimizer_steps": steps,
        "model_flops": flops.lm_flops(
            tower, steps * args.batch_size * args.accumulation_steps,
            args.seq_length),
        "peak_flops": chipmath.STEP_PEAKS[job.config["compute_dtype"]],
        "attention_calls": mla_calls,
        "kernel_launches": mla_attention.launches,
        "counters": counters(),
        "breakdown": breakdown([tr]),
    }


# -- the judge ------------------------------------------------------------
def check_batches(job, batches: List[dict]) -> None:
    """Every row's targets (where > 0) are the packed stream's slice at a
    multiple of the row length, and its source is [CLS] then the same slice
    one token later; raises otherwise."""
    specials = job.traffic["specials"]
    sep = specials.index("</s>")
    ids = stream(job, sep)
    s = job.traffic["seq_length"]
    padded = np.concatenate([ids, np.zeros(s, ids.dtype)])
    for b in batches:
        src, tgt = b["src"].astype(np.int64), b["tgt"].astype(np.int64)
        for r in range(src.shape[0]):
            start = None
            for j in range(0, len(ids), s):
                if np.array_equal(padded[j:j + 8], tgt[r, :8]):
                    start = j
                    break
            want = padded[start:start + s] if start is not None else None
            mask = tgt[r] > 0
            if (want is None or not np.array_equal(tgt[r][mask], want[mask])
                    or not np.array_equal(src[r, 1:][mask[:-1]],
                                          want[:-1][mask[:-1]])):
                raise AssertionError("a batch row is no slice of the packed "
                                     "corpus")


def reference_obs(job, results, batches: List[dict], prec: str) -> dict:
    import torch

    from lr2ppo_torch.towers.model import TowerConfig

    ref = load_module("reference", job.config["family"])
    dev = (torch.device("cpu") if job.device == "cpu"
           else torch.device("cuda", 0))
    h = dict(results[0]["hyper"])
    model_cfg = TowerConfig.from_dict(h["tower"])
    w = make_weights(model_cfg, job.seed, dev)
    dev_batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in batches]
    return ref.follow(w, dev_batches, h, prec)


def route_gap(prog: List, ref: dict, held: List[int], n_exp: int) -> float:
    """The share of the held experts' (token, choice) pairs, the program's
    and the reference's over the first step's first micro-batch, that the
    other side did not choose (prog: each MoE layer's choices; ref: {layer:
    choices})."""
    import torch

    differ = total = 0
    held_t = torch.tensor(held, dtype=torch.long)
    if isinstance(prog, dict):
        prog = list(prog.values())
    for pi, ri in zip(prog, ref.values()):
        p, r = (torch.zeros(x.shape[0], n_exp, dtype=torch.bool).scatter_(
            1, x.long(), True)[:, held_t] for x in (pi.reshape(
                -1, pi.shape[-1]), ri))
        differ += int((p ^ r).sum())
        total += int(p.sum() + r.sum())
    return differ / max(total, 1)


def bias_gap(prog: Dict[str, object], ref: Dict[str, object]) -> float:
    """The worst MoE layer's gap between the program's correction bias
    after the warm steps and the reference's, over the reference's norm
    (0 where both are 0)."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None:
            return float("inf")
        diff, norm = float((p - r).norm()), float(r.norm())
        gap = diff / norm if norm else (0.0 if not diff else float("inf"))
        worst = gap if not gap <= worst else worst
    return worst


def pooled(norms: Dict[str, float]) -> Dict[str, float]:
    """The leaves' norms with each MoE layer's held experts pooled: one
    norm over all of a layer's `experts.<id>.<proj>.weight` leaves a
    projection. A token whose choice flips between near-tied experts (the
    routes' own gap, route_gap) moves its part of the gradient from one
    held expert to another; the pooled norm keeps what the layer's experts
    received together."""
    out: Dict[str, float] = {}
    for k, v in norms.items():
        parts = k.split(".")
        if "experts" in parts:
            i = parts.index("experts")
            k = ".".join(parts[:i + 1] + ["*"] + parts[i + 2:])
        out[k] = out.get(k, 0.0) + v * v
    return {k: v ** 0.5 for k, v in out.items()}


def numbers(prog: dict, ref: dict, h: dict, detail: dict = None
            ) -> Dict[str, float]:
    """pretrain_fit's numbers over the pooled leaves, and route_gap."""
    pool = {k: pooled(v) for k, v in (("g1", prog["g1"]),
                                      ("change", prog["change"]))}
    rpool = {k: pooled(v) for k, v in (("g1", ref["g1"]),
                                       ("change", ref["change"]))}
    got = pretrain_fit.numbers(dict(prog, **pool), dict(ref, **rpool),
                               detail)
    c = h["tower"]
    got["route_gap"] = route_gap(prog["routes"], ref["routes"],
                                 c["held_experts"], c["router_experts"])
    got["bias_gap"] = bias_gap(prog["biases"], ref["biases"])
    return got


def judge(job, results: List[dict]) -> List[dict]:
    from perfbench.common import checks

    cap = results[0]["capture"]
    check_batches(job, cap["batches"])
    ref = reference_obs(job, results, cap["batches"], "float32")
    detail: dict = {}
    got = numbers(cap, ref, results[0]["hyper"], detail)
    checks.report(detail)
    return checks.against(got, job.traffic["limits"])


def calibration(job, results: List[dict], control: bool) -> dict:
    cap = results[0]["capture"]
    h = results[0]["hyper"]
    check_batches(job, cap["batches"])
    detail: dict = {}
    ref = reference_obs(job, results, cap["batches"], "float32")
    out = {"numbers": numbers(cap, ref, h, detail), "detail": detail}
    if control:
        ctl = reference_obs(job, results, cap["batches"], "fp8")
        cdetail: dict = {}
        out["control"] = numbers(ctl, ref, h, cdetail)
        out["control_detail"] = cdetail
    return out
