"""Entry `ppo_fit`: the stage-3 LR2PPO fit, `PPOTrainer.fit`, configured as
`cli/ppo.py` configures it from the traffic file's flags, on one GPU or as
one rank per GPU (--dp).

Set-up makes the actor's and the stage-2 reward model's weights on the
device from the seed (the program loads them as its --pretrained_model_path
and --reward_model_path, the reward model starting the critic too, as a
stage-3 run does), the item store (common/items.py) behind the program's
MovieNet dataset and thread loader, and the trainer. The fit's first
`warm_sweeps` sweeps are set-up: they warm every shape, and the judge's
reference follows them. The window then runs whole sweeps until the first
sweep boundary at or past --seconds; the eval (64 items) runs after it. No
checkpoint is written.

What the judge compares (perfbench/reference/lr2ppo.py follows the same
sweeps in float32 from the same weights and rows): each rollout's actor
scores (the int8 twin, through K1), critic values and int8 rewards, and the
order the program chose; each update's policy and value losses; the first
gradient of each model as AdamW received it (its first moment after one
step, over 1 - beta1); and each parameter's change over the warm sweeps.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import statistics
import time
from typing import Dict, List

import numpy as np

from perfbench.common import chipmath, checks
from perfbench.common.harness import device_line, load_module
from perfbench.common.items import ItemStore
from perfbench.common.probes import Probes
from perfbench.common.trace import Profiler, breakdown
from perfbench.common.window import FitWindow

PREFIX = "perfbench:"


def make_config(job):
    from lr2ppo_torch.config import parse_config

    t = job.traffic
    argv = list(t["argv"]) + [
        "--seed", str(job.seed), "--batch_size", str(t["batch_size"]),
        "--item_dtype", t["item_dtype"],
        "--pretrained_model_path", PREFIX + "actor",
        "--reward_model_path", PREFIX + "reward",
        "--output_model_path", "",
        "--log_path", os.path.join(job.tmp, f"ppo{job.rank}.log")]
    if job.world > 1:
        argv += ["--distributed", "--coordinator", f"localhost:{job.port}",
                 "--num_processes", str(job.world), "--process_id",
                 str(job.rank), "--dp", str(job.world)]
    cfg = parse_config(argv)
    model = dataclasses.replace(cfg.model, **job.config["model"])
    # the loader pads every item to the model's image tokens
    data = dataclasses.replace(cfg.data, max_imgs=model.max_imgs)
    cfg = cfg.replace(model=model, data=data)
    cfg.mesh.compute_dtype = job.config["compute_dtype"]
    return cfg


def make_weights(mcfg, seed: int, device) -> Dict[str, dict]:
    """The actor's and the reward model's float32 weights."""
    from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
    from perfbench.common.weights import seeded

    return seeded({"actor": ScoreModel(mcfg, device="meta"),
                   "reward": SeqScoreModel(mcfg, device="meta")}, seed,
                  device)


def make_store(job, mcfg, device) -> ItemStore:
    return ItemStore(job.seed, job.traffic["store"], mcfg.seq_length,
                     mcfg.feat_size, job.traffic["item_dtype"], device)


def leaf_norms(tensors: Dict[str, object], scale: float = 1.0) -> dict:
    return {k: float(v.detach().double().norm()) * scale
            for k, v in tensors.items()}


def run(job) -> dict:
    """One rank's run; a plain dict (sent between processes)."""
    import torch

    from lr2ppo_torch.data import EvalLoader, Loader, MovieNetDataset
    from lr2ppo_torch.cli._common import pod_shard
    from lr2ppo_torch.train import ppo as ppo_mod
    from lr2ppo_torch.train.optim import AdamW

    t = job.traffic
    marks = [("process start", t["t_process"])]

    def mark(name):
        marks.append((name, time.time()))

    cfg = make_config(job)
    mark("imports, configuration")
    upd = cfg.ppo.update_timesteps
    warm = t["warm_sweeps"]
    capture_rollouts = warm * upd
    with Probes() as probes:
        weights: dict = {}
        got = {"rollout": [], "update": [], "g1": [], "rows": []}
        models = {}

        def load_any(original):
            def load(path):
                if str(path).startswith(PREFIX):
                    return weights.pop(path[len(PREFIX):])
                return original(path)
            return load

        probes.patch("lr2ppo_torch.train.checkpoints", "load_any", load_any)
        trainer = ppo_mod.PPOTrainer(cfg, "cpu" if job.device == "cpu"
                                     else None)
        dev = trainer.device
        mark("trainer, device")
        weights.update(make_weights(cfg.model, job.seed, dev))
        mark("seeded weights")
        store = make_store(job, cfg.model, dev)
        mark("item store")
        item_dtype = store.dtype
        ds = MovieNetDataset("", "", "ppo", max_tags=cfg.data.max_tags,
                             max_imgs=cfg.data.max_imgs, seed=cfg.seed,
                             data=store.train, h5_file=store,
                             item_dtype=item_dtype)
        loader = Loader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                        num_workers=cfg.data.num_workers,
                        prefetch_depth=cfg.data.prefetch_depth,
                        reuse_buffers=True, shard=pod_shard())
        ev = EvalLoader(MovieNetDataset(
            "", "", "eval", max_tags=cfg.data.max_tags,
            max_imgs=cfg.data.max_imgs, seed=cfg.seed, data=store.eval,
            h5_file=store, item_dtype=item_dtype),
            cfg.data.eval_tag_buckets, cfg.batch_size)

        # -- probes around the program's calls --------------------------
        init_params = trainer.init_params

        def init_and_keep(seed):
            out = init_params(seed)
            mark("models loaded, reward quantized")
            models["actor"], models["critic"] = out[0], out[1]
            return out

        trainer.init_params = init_and_keep

        def rollout_maker(make):
            def made(mode):
                step = make(mode)

                def rollout(*a):
                    with probes.range("rollout"):
                        out = step(*a)
                    if job.mode == "fault:answer":
                        # the order of a quarter of the items turned round
                        nxt = out[2].clone()
                        q = max(nxt.shape[0] // 4, 1)
                        nxt[:q, 2:] = nxt[:q, 2:].flip(1)
                        out = (out[0], out[1], nxt, out[3])
                    if len(got["rollout"]) < capture_rollouts:
                        got["rollout"].append([v.detach().clone()
                                               for v in out])
                    return out
                return rollout
            return made

        def update_maker(make):
            def made(c):
                step = make(c)

                def update(astate, cstate, generator, *arrays, **kw):
                    if job.mode == "fault:half_batch":
                        arrays = tuple(a[:a.shape[0] // 2] if
                                       torch.is_tensor(a) and a.dim() else a
                                       for a in arrays)
                    with probes.range("update"):
                        m = step(astate, cstate, generator, *arrays, **kw)
                    if len(got["update"]) < capture_rollouts:
                        got["update"].append({k: m[k] for k in
                                              ("policy_loss", "value_loss")})
                    return m
                return update
            return made

        def frozen_maker(fc):
            def frozen(*a, **k):
                with probes.range("requantize"):
                    return fc(*a, **k)
            return frozen

        def adamw_maker(step):
            def adamw_step(self, *a, **k):
                if job.mode == "fault:state_unchanged":
                    return None
                with probes.range("adamw"):
                    out = step(self, *a, **k)
                if self.count == 1 and len(got["g1"]) < 2:
                    # the first step from zero moments: m = (1 - b1) g
                    got["g1"].append(leaf_norms(self.mu, 1.0 / (1 - self.b1)))
                return out
            return adamw_step

        def int8_mlp_maker(fn):
            def int8_mlp(x, w1, *a, **k):
                probes.record("int8_mlp", (x.numel() // x.shape[-1],
                                           x.shape[-1], w1.shape[0],
                                           x.element_size()))
                with probes.range("int8_mlp"):
                    return fn(x, w1, *a, **k)
            return int8_mlp

        def dropout_maker(fn):
            def apply(x, *a, **k):
                probes.record("hash_dropout", (x.numel(), x.element_size()))
                with probes.range("hash_dropout"):
                    return fn(x, *a, **k)
            return apply

        probes.patch(ppo_mod, "make_rollout_step", rollout_maker)
        probes.patch(ppo_mod, "make_update_step", update_maker)
        probes.patch(ppo_mod, "frozen_copy", frozen_maker)
        probes.patch(AdamW, "step", adamw_maker)
        probes.patch("lr2ppo_torch.models.layers", "int8_mlp",
                     int8_mlp_maker)
        probes.patch("lr2ppo_torch.ops.hash_dropout", "_apply",
                     dropout_maker)
        if job.mode == "fault:no_exchange":
            from lr2ppo_torch.train.optim import DistributedOptimizer

            probes.patch(DistributedOptimizer, "_average_grads",
                         lambda f: lambda self: None)
        trainer.ctx.put = probes.timed("put", trainer.ctx.put)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        change: dict = {}

        def on_warm():
            mark("warm sweeps")
            # each parameter's change over the warm sweeps, against the
            # weights made again from the seed
            init = make_weights(cfg.model, job.seed, dev)
            for name, src in (("actor", "actor"), ("critic", "reward")):
                params = dict(models[name].named_parameters())
                change[name] = {k: float((params[k].detach().float()
                                          - v).double().norm())
                                for k, v in init[src].items()}
            del init

        def on_batch(i, batch):
            if i == 0:
                mark("loader's first batch")
            if i < capture_rollouts:
                got["rows"].append(store.identify(batch))

        agree = None
        if job.world > 1:
            import torch.distributed as dist

            def agree(flag):
                f = torch.tensor([1.0 if flag else 0.0], device=dev)
                dist.all_reduce(f, op=dist.ReduceOp.MAX)
                return bool(f.item() > 0)

        window = FitWindow(
            loader, upd, warm, job.seconds,
            t["trace_sweeps"] if job.trace else None, probes, sync, on_warm,
            on_batch, agree, Profiler(os.path.join(job.tmp,
                                                   f"trace{job.rank}.json")))
        trainer.fit(lambda epoch: window, ev)
        sync()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        setup_s = window.wall_open - t["t_process"]
        marks.append(("the change over the warm sweeps", window.wall_open))
        calls = dict(probes.calls)
        host_s = dict(probes.host_s)

    b_local = cfg.batch_size // job.world
    out = {
        "rank": job.rank,
        "setup_s": setup_s,
        "setup_parts": [[n, b - a] for (_, a), (n, b)
                        in zip(marks, marks[1:])],
        "window_s": window.window_s,
        "items": window.steps_in_window * upd * cfg.batch_size,
        "peak": int(peak),
        "capture": {
            "rows": got["rows"],
            "rollout": [[v.float().cpu().numpy() for v in r]
                        for r in got["rollout"]],
            "update": [{k: float(v) for k, v in u.items()}
                       for u in got["update"]],
            "g1": got["g1"], "change": change,
        },
        "hyper": hyper(cfg, len(loader)),
    }
    if job.trace:
        out["obs"] = observe(window, calls, host_s, cfg, job, b_local)
    del trainer, models, window, loader, ev, ds, store
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def hyper(cfg, steps_per_epoch: int) -> dict:
    """What the reference needs of the configuration."""
    o, p, m = cfg.optim, cfg.ppo, cfg.model
    return {
        "seed": cfg.seed, "compute_dtype": cfg.mesh.compute_dtype,
        "chips": max(cfg.mesh.dp, 1),
        # the reference's update takes the global batch a chip's rows at a
        # time
        "chunk_rows": cfg.batch_size // max(cfg.mesh.dp, 1),
        "feat_size": m.feat_size, "num_heads": m.num_heads,
        "drop_p": m.drop_p, "learning_rate": o.learning_rate,
        "critic_learning_rate": o.critic_learning_rate,
        "beta1": o.beta1, "beta2": o.beta2, "adam_eps": o.adam_eps,
        "weight_decay": o.weight_decay, "warmup": o.warmup,
        "train_steps": int(steps_per_epoch * cfg.epochs_num) + 1,
        "update_timesteps": p.update_timesteps,
        "kl_div_loss_weight": p.kl_div_loss_weight,
        "entropy_weight": p.entropy_weight, "value_clip": p.value_clip,
        "rank_margin": p.rank_margin, "advantage_eps": p.advantage_eps,
    }


def observe(window, calls, host_s, cfg, job, b_local) -> dict:
    """What the metric readers take from this rank's traced sweeps."""
    tr = window.trace
    kern = tr.kernels()
    nccl = [(o[1], o[2]) for o in kern if "nccl" in o[0].lower()]
    other = [(o[1], o[2]) for o in kern if "nccl" not in o[0].lower()]
    sweeps = window.steps_in_window
    upd = cfg.ppo.update_timesteps
    flops_mod = load_module("flops", job.cell["config"])
    fetch = window.fetch_s
    put = host_s.get("put", [])
    return {
        "wall_s": window.window_s,
        "busy_s": tr.busy_us() / 1e6,
        "kernel_busy_s": tr.kernel_busy_us() / 1e6,
        "range_us": {name: tr.range_device_us(name) for name in tr.ranges},
        "calls": calls,
        "nccl_us": chipmath.union_us(nccl),
        "nccl_exposed_us": (chipmath.union_us(nccl)
                            - chipmath.overlap_us(nccl, other)),
        "updates": sweeps * upd, "rollouts": sweeps * upd,
        "optimizer_steps": 2 * sweeps * upd,
        "host_batch_ms": [1e3 * (a + b) for a, b in zip(fetch, put)],
        "model_flops": flops_mod.ppo_flops(
            job.config["model"], b_local, 2, sweeps * upd, sweeps * upd),
        "peak_flops": chipmath.STEP_PEAKS[job.config["compute_dtype"]],
        "breakdown": breakdown([tr]),
    }


def summarize(job, results: List[dict]) -> dict:
    import torch

    first = results[0]
    window = max(r["window_s"] or 0.0 for r in results)
    items = first["items"]
    e2e = {"train_items_per_s": items / window if window else 0.0,
           "setup_s": max(r["setup_s"] for r in results)}
    peak = max(r["peak"] for r in results)
    dev = device_line(job, peak)
    out = {"e2e": e2e, "attempted": items, "failed": 0, "device": dev}
    if job.trace:
        obs = [r["obs"] for r in results]
        out["obs"] = obs
        busy = sum(o["busy_s"] for o in obs) / len(obs)
        dev["busy_s"] = busy
        dev["window_s"] = sum(o["wall_s"] for o in obs) / len(obs)
        out["breakdown"] = obs[0]["breakdown"]
    return out


# -- the judge ------------------------------------------------------------
def program_obs(results: List[dict]) -> dict:
    """The program's observations over all ranks: rows and rollout outputs
    concatenated in rank order (each rank's rows are its slice of the
    global batch), losses averaged over the equal shards."""
    caps = [r["capture"] for r in results]
    n = len(caps[0]["rollout"])
    cat = np.concatenate
    obs = {"rows": [{k: cat([c["rows"][i][k] for c in caps])
                     for k in ("text", "img")} for i in range(n)]}
    for j, name in enumerate(("scores", "value", "next_state", "reward")):
        obs[name] = [cat([c["rollout"][i][j] for c in caps])
                     for i in range(n)]
    for name in ("policy_loss", "value_loss"):
        obs[name] = [float(np.mean([c["update"][i][name] for c in caps]))
                     for i in range(len(caps[0]["update"]))]
    obs["change"] = caps[0]["change"]
    # an optimizer that never stepped holds zero moments: a zero gradient
    g1 = caps[0]["g1"] + [None] * 2
    obs["g1"] = {m: g1[i] or {k: 0.0 for k in obs["change"][m]}
                 for i, m in enumerate(("actor", "critic"))}
    return obs


def reference_obs(job, results, prog: dict, prec: str,
                  follow_actions: bool) -> dict:
    """The reference's observations on the chip the judge runs on, from
    the weights and rows made again from the seed."""
    import torch

    ref = load_module("reference", job.config["family"])
    dev = torch.device("cuda", 0) if job.device != "cpu" else torch.device(
        "cpu")
    from lr2ppo_torch.config import ModelConfig

    mcfg = dataclasses.replace(ModelConfig(), **job.config["model"])
    w = make_weights(mcfg, job.seed, dev)
    store = make_store(job, mcfg, dev)
    batches = [store.rebuild(rows, dev) for rows in prog["rows"]]
    h = dict(results[0]["hyper"])
    actions = ([torch.from_numpy(a) for a in prog["next_state"]]
               if follow_actions else None)
    out = ref.follow(w["actor"], w["reward"], batches, h, prec, actions)
    return out


def as_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def numbers(prog: dict, ref: dict, detail: dict = None) -> Dict[str, float]:
    """The numbers compared, each the worst over its parts: of the actor's
    scores and the rewards of each rollout, the root mean square of the gap
    against that of the reference's; the widest gap by which the order the
    program chose lies below the reference's best, against the rms of the
    reference's scores; the first gradient's and the change's norms by the
    worst leaf (common/checks.py), the change without leaves whose
    reference gradient is under a thousandth of the median leaf's.

    Read but not compared (`detail`; PERF.md gives why): the critic's
    values in the rollouts and each update's policy and value losses,
    which neither the control nor a planted fault separates from sound
    runs."""
    detail = {} if detail is None else detail
    out = {}

    def rms_gap(k: str) -> float:
        worst = 0.0
        for i in range(len(prog[k])):
            r = as_np(ref[k][i]).astype(np.float64)
            p = np.asarray(prog[k][i], np.float64)
            rms = max(float(np.sqrt(np.mean(r * r))), 1e-12)
            worst = max(worst, float(np.sqrt(np.mean((p - r) ** 2))) / rms)
        return worst

    out["scores_gap"] = rms_gap("scores")
    detail["value_gap"] = rms_gap("value")
    out["reward_gap"] = rms_gap("reward")
    order = 0.0
    for i, gap in enumerate(ref.get("order_gap", [])):
        r = as_np(ref["scores"][i]).astype(np.float64)
        rms = max(float(np.sqrt(np.mean(r * r))), 1e-12)
        order = max(order, float(as_np(gap).max()) / rms)
    out["order_gap"] = order
    for k in ("policy_loss", "value_loss"):
        detail[k] = [[p, r] for p, r in zip(prog[k], ref[k])]
        detail[k + "_gap"] = max(abs(p - r) / max(abs(r), 1e-12)
                                 for p, r in zip(prog[k], ref[k]))
    grad = change = 0.0
    for model in ("actor", "critic"):
        gr, gp = ref["g1"][model], prog["g1"][model]
        med = statistics.median(gr.values())
        grad = max(grad, checks.worst_leaf(gp, gr, med))
        moved = {k for k, v in gr.items() if v >= 1e-3 * med}
        cr = {k: v for k, v in ref["change"][model].items() if k in moved}
        cp = {k: prog["change"][model][k] for k in cr}
        change = max(change, checks.worst_leaf(
            cp, cr, statistics.median(cr.values())))
        detail[f"unmoved.{model}"] = sorted(set(gr) - moved)
        detail[f"worst.grad.{model}"] = checks.worst_leaves(gp, gr, med)
        detail[f"worst.change.{model}"] = checks.worst_leaves(
            cp, cr, statistics.median(cr.values()))
    out["grad_gap"], out["change_gap"] = grad, change
    return out


def judge(job, results: List[dict]) -> List[dict]:
    prog = program_obs(results)
    ref = reference_obs(job, results, prog, "float32", True)
    detail: dict = {}
    got = numbers(prog, ref, detail)
    checks.report(detail)
    return checks.against(got, job.traffic["limits"])


def as_program(obs: dict, rows: list) -> dict:
    """The reference's observations in the shape of the program's, so that
    the reference can stand in the program's place (the control)."""
    out = {"rows": rows}
    for k in ("scores", "value", "reward", "next_state"):
        out[k] = [as_np(v) for v in obs[k]]
    for k in ("policy_loss", "value_loss", "g1", "change"):
        out[k] = obs[k]
    return out


def calibration(job, results: List[dict], control: bool) -> dict:
    """The readings the limits are set from: the numbers of this run's
    program (or planted fault) against the reference, and with `control`
    those of the reference in float8 and int4 in the program's place."""
    prog = program_obs(results)
    detail: dict = {}
    ref = reference_obs(job, results, prog, "float32", True)
    out = {"numbers": numbers(prog, ref, detail), "detail": detail}
    if control:
        del ref
        ctl = as_program(reference_obs(job, results, prog, "fp8", False),
                         prog["rows"])
        ref = reference_obs(job, results, ctl, "float32", True)
        cdetail: dict = {}
        out["control"] = numbers(ctl, ref, cdetail)
        out["control_detail"] = cdetail
    return out
