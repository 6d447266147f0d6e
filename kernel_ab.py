#!/usr/bin/env python3
"""Time AdamW, the fused int8 FFN (K1), the narrow int8 GEMM (K2), the
tower attention kernel (K4) and hash dropout of one or more checkouts of
this repository on one CUDA card, in the order given:

    python3 kernel_ab.py [--only hash_dropout|adamw] _tree/parent . . \
        _tree/parent

Each tree must lie inside this checkout (unpack another commit with `git
archive` into a git-ignored directory such as `_tree/`). Each runs in a
process of its own, imports its own `chip_smoke.py` and calls its
`check_kernel` (phase 3), `check_k2` (phase 11), `check_attention` (phase
9) and `check_dropout` (phase 6), so its kernels build from its own sources
and the shapes, inputs and checks are that phase's: K1 at the rollout's
100,352 and a served batch's 200,704 rows (D 768, H 3072, bfloat16), K2 at
the rollout and serve fc2 sites (those rows x 3072 -> 768, bfloat16), K4 at
the text (32, 12, 196, 64) and image (32, 12, 197, 64) shapes in float32
and bfloat16, hash dropout at the update's 100,352 x 3072 site in
bfloat16. Only the timing is made alike for every tree: each timed run of
the tree's `cuda_ms` is n calls back to back (3 for K1, K2 and hash
dropout, 20 for K4), divided by n, so a time is the device's and not the
host's time to launch. Hash dropout is also timed back to back at the
update's site in float32 and at its dp shard (50,176 rows from row 50,176,
bfloat16), and one call between two events, so the wrapper's host path
counts, at a tabular site (512 x 3072, bfloat16) and at the tower sites
HASH_ONE_CALL names (XLM-R's, T5's context probabilities, the LSTM's at
rate 0.65, BEiT's, S2T's, the sp place), each also traced (the kernel's
device time a launch over 20 launches) with torch.nn.functional.dropout's
one call and traced time beside it. Then the wrapper's host path at the
(32, 128, 768) float32 site, part by part (`host_breakdown`).
`--only hash_dropout` times hash dropout alone.

AdamW (`--only adamw` times it alone): each tree's own AdamW.step, the
eager loop or the kernel, one step a timed run over CUDA events (the host's
launching included), at the `out_layer` weight (3,072 x 162,816, float32,
bfloat16 moments), XLM-R base's word table (250,002 x 768, float32,
float32 moments) and one update's whole set (the actor's and the critic's
steps at flagship width under --profile fast: float32 parameters,
bfloat16 moments); then, where the tree's
chip_smoke.py has phase 22 (`adamw_kernel`), that phase: the kernel against
its plain version bit for bit, its time beside the plain version's, the
fused library step's and the bound. Prints the card's name and power
limit, then each tree's name and its phases' JSON lines.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

REPS = {"int8_mlp": 3, "int8_matmul": 3, "fused_attention": 20,
        "hash_dropout": 3}
# hash dropout's sites beside the update's, timed one call a run and
# traced: name, shape, dtype, rate and the shard's place (None: whole)
HASH_ONE_CALL = (
    ("tabular", (512, 3072), "bfloat16", 0.1, None),
    ("xlmr_residual", (32, 128, 768), "float32", 0.1, None),
    ("xlmr_probs", (32, 12, 128, 128), "float32", 0.1, None),
    ("t5_context", (32, 12, 64, 128), "float32", 0.1, None),
    ("lstm", (20, 35, 1500), "float32", 0.65, None),
    ("beit_residual", (32, 197, 768), "float32", 0.1, None),
    ("beit_probs", (32, 12, 197, 197), "float32", 0.1, None),
    ("s2t", (16, 400, 256), "float32", 0.1, None),
    # a tp-2 rank's tokens of XLM-R's (32, 128, 768) residual under --sp
    ("sp_place", (32, 64, 768), "float32", 0.1,
     (0, 64 * 768, 128 * 768, 64 * 768)))
# host-path breakdown: calls a timed batch (the card runs them as the host
# queues them, so the queue never fills), batches a part
HOST_CALLS, HOST_BATCHES = 200, 15


def back_to_back(cuda_ms, n: int):
    """The tree's cuda_ms, each timed run n calls of fn, divided by n."""
    def timed(fn, iters: int = 10, warmup: int = 2, reps: int = 1) -> float:
        return cuda_ms(lambda: [fn() for _ in range(n)], iters, warmup) / n
    return timed


def library_trace_ms(cs, x, rate: float, n: int = 20) -> float:
    """torch.nn.functional.dropout's device time a call (its kernels' sum)
    over a trace of n calls on x."""
    import torch
    from torch.autograd import DeviceType

    prof = cs.steady_trace(lambda: [torch.nn.functional.dropout(
        x, rate, training=True) for _ in range(n)])
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n


def hash_trace(cs, x, place, n: int = 20):
    """The tree's hash dropout kernel's median device time a launch over a
    trace of n launches on x, and the launches the trace holds; a trace
    that kept no device record of them is taken again, up to three
    traces, then (None, 0)."""
    import torch

    for _ in range(3):
        prof = cs.steady_trace(lambda: [cs.hash_dropout(
            x, i, cs.DROP_RATE, place) for i in range(n)])
        torch.cuda.synchronize()
        times = cs.traced_ms(prof, "hash_dropout")
        if times:
            return statistics.median(times), len(times)
    return None, 0


def host_us(fn, sync) -> float:
    """Median host microseconds a call of fn over HOST_BATCHES batches of
    HOST_CALLS calls, the card synchronised between batches."""
    for _ in range(HOST_CALLS):
        fn()
    sync()
    times = []
    for _ in range(HOST_BATCHES):
        t0 = time.perf_counter_ns()
        for _ in range(HOST_CALLS):
            fn()
        times.append((time.perf_counter_ns() - t0) / HOST_CALLS / 1e3)
        sync()
    return statistics.median(times)


def host_breakdown(cs, dev, card_line: str) -> dict:
    """One hash dropout call's host time at the (32, 128, 768) float32
    tower site, part by part, in this tree's wrapper: the whole site
    (module_dropout, forward and backward), its parts (draw_seed,
    shard_place, the autograd Function, the launch path and the pieces of
    each) and torch.nn.functional.dropout beside it. A part the tree does
    not have is left out."""
    import torch

    from lr2ppo_torch.kernels import build
    from lr2ppo_torch.ops import hash_dropout as hd

    sync = torch.cuda.synchronize
    x = torch.randn(32, 128, 768, device=dev)
    g = torch.randn_like(x)
    xr = x.clone().requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    seed, rate = 12345, cs.DROP_RATE
    thr, scale = hd.threshold(rate), hd.scale_for(rate, x.dtype)
    key = hd.seed_mix(seed)
    y = torch.empty_like(x)
    parts = {}

    def grad(out):
        """The backward to x without accumulating into x.grad."""
        return torch.autograd.grad(out, xr, g)

    def part(name, fn):
        parts[name] = host_us(fn, sync)

    part("module_dropout forward", lambda: hd.module_dropout(
        xr, rate, False, gen, True))
    part("module_dropout forward + backward", lambda: grad(hd.module_dropout(
        xr, rate, False, gen, True)))
    part("hash_dropout forward, x requires grad",
         lambda: hd.hash_dropout(xr, seed, rate))
    part("hash_dropout forward + backward",
         lambda: grad(hd.hash_dropout(xr, seed, rate)))
    part("hash_dropout, no grad", lambda: hd.hash_dropout(x, seed, rate))
    part("draw_seed", lambda: hd.draw_seed(gen))
    part("shard_place", lambda: hd.shard_place(x))
    function = getattr(hd, "seeded_dropout", hd.SeededDropout.apply)
    # the Function's arguments: a shard's place or offset after the rate
    # where the tree's forward takes one
    fargs = (lambda t, *a: torch.empty_like(t), xr, seed, rate) + (
        (None,) if "where" in inspect.signature(
            hd.SeededDropout.forward).parameters else ())
    part("the autograd Function of empty_like, x requires grad",
         lambda: function(*fargs))
    if hasattr(hd, "seeded_dropout"):   # beside it, the Python layer
        part("SeededDropout.apply (Python layer) of empty_like, x requires "
             "grad", lambda: hd.SeededDropout.apply(*fargs))
    part("_apply (the launch path)", lambda: hd._apply(x, seed, rate))
    if hasattr(build, "function"):           # resolved once
        fn = build.function("lr2ppo_hash_dropout")
        args = (x.data_ptr(), y.data_ptr(), x.numel(), key, thr, scale, 0,
                torch._C._cuda_getCurrentRawStream(0))
        part("launch_elementwise", lambda: hd.launch_elementwise(
            "lr2ppo_hash_dropout", x, key, thr, scale))
        part("build.function", lambda: build.function("lr2ppo_hash_dropout"))
    else:                                    # the library and an f-string
        fn = getattr(build.library("hash_dropout"), "lr2ppo_hash_dropout")
        args = (x.data_ptr(), y.data_ptr(), x.numel(), key, thr, scale, 0,
                torch._C._cuda_getCurrentRawStream(0), 0, 0, 768, 768)
        part("launch_elementwise", lambda: hd.launch_elementwise(
            "hash_dropout", x, key, thr, scale, 0, 0, 768, 768))
        entry = "hash_dropout"
        part("build.library + getattr", lambda: getattr(
            build.library(entry), f"lr2ppo_{entry}"))
    part("check_elementwise", lambda: hd.check_elementwise(x, "hd"))
    part("torch.empty_like", lambda: torch.empty_like(x))
    part(f"the ctypes call ({len(args)} arguments)", lambda: fn(*args))
    part("torch._C._cuda_getCurrentRawStream",
         lambda: torch._C._cuda_getCurrentRawStream(0))
    part("torch.cuda.current_device", torch.cuda.current_device)
    part("threshold + scale_for + seed_mix", lambda: (
        hd.threshold(rate), hd.scale_for(rate, x.dtype), hd.seed_mix(seed)))
    part("F.dropout, no grad", lambda: torch.nn.functional.dropout(
        x, rate, training=True))
    part("F.dropout forward + backward", lambda: grad(
        torch.nn.functional.dropout(xr, rate, training=True)))
    res = {"phase": "hash_host_breakdown", "shape": [32, 128, 768],
           "dtype": "float32", "calls": HOST_CALLS * HOST_BATCHES,
           "us": parts, "card": card_line}
    print(json.dumps(res), flush=True)
    return res


# AdamW's tensors: shape, parameter dtype, moment dtype
ADAMW_AB = {"out_layer": ((3072, 162816), "float32", "bfloat16"),
            "xlmr_word": ((250002, 768), "float32", "float32")}


def adamw_ab(cs, dev, card_line: str, seed: int = 5) -> None:
    """The tree's AdamW.step (constant lr 1e-4, OptimConfig's other
    defaults) at each tensor of ADAMW_AB and over one update's whole set,
    on seeded tensors; one step a timed run."""
    import torch

    from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
    from lr2ppo_torch.train.optim import AdamW, no_decay_names

    def seeded(shapes: dict, dtype, gen) -> dict:
        return {k: (torch.randn(s, device=dev, generator=gen)
                    * 0.02).to(dtype) for k, s in shapes.items()}

    def timed(name: str, sets: list, extra: dict) -> None:
        def step():
            for opt, grads in sets:
                opt.step(grads)
        ms = cs.cuda_ms(step, iters=5, warmup=1)
        numel = sum(p.numel() for o, _ in sets for p in o.params.values())
        nbytes = sum(p.numel() * (3 * p.element_size()
                                  + 4 * o.mu[k].element_size())
                     for o, _ in sets for k, p in o.params.items())
        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "phase": "adamw_step", "set": name, "params": numel,
            "tensors": sum(len(o.params) for o, _ in sets), **extra,
            "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
            "card": card_line}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, (shape, p_dtype, m_dtype) in ADAMW_AB.items():
        p_dt, m_dt = getattr(torch, p_dtype), getattr(torch, m_dtype)
        params = seeded({name: shape}, p_dt, gen)
        opt = AdamW(params, lambda t: 1e-4, moment_dtype=m_dt)
        timed(name, [(opt, seeded({name: shape}, p_dt, gen))],
              {"dtype": p_dtype, "moment_dtype": m_dtype})
        del params, opt
        torch.cuda.empty_cache()
    cfg = cs.train_config("", seed)
    sets = []
    for cls in (ScoreModel, SeqScoreModel):
        model = cls(cfg.model, torch.bfloat16, device="meta")
        shapes = {k: p.shape for k, p in model.named_parameters()}
        opt = AdamW(seeded(shapes, torch.float32, gen), lambda t: 1e-4,
                    moment_dtype=torch.bfloat16,
                    no_decay=no_decay_names(model))
        sets.append((opt, seeded(shapes, torch.float32, gen)))
    timed("update", sets, {"dtype": "float32",
                           "moment_dtype": "bfloat16"})
    del sets
    torch.cuda.empty_cache()
    if hasattr(cs, "adamw_kernel"):
        cs.adamw_kernel(seed, dev, card_line)


def child(tree: str, only: str = "") -> None:
    """Time one tree's kernels through its own chip_smoke.py."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA device")
    print(json.dumps({"tree": tree, "chip_smoke": cs.__file__}), flush=True)
    dev = torch.device("cuda", 0)
    card_line = cs.card()
    own = cs.cuda_ms
    if only not in ("", "hash_dropout", "adamw"):
        raise SystemExit(f"--only {only}: only hash_dropout or adamw is "
                         "selectable")
    if only in ("", "adamw"):
        adamw_ab(cs, dev, card_line)
        if only:
            return
    if not only:
        cs.cuda_ms = back_to_back(own, REPS["int8_mlp"])
        for rows in (cs.ROLLOUT_ROWS, cs.SERVE_ROWS):
            cs.check_kernel(rows, torch.bfloat16, 0, dev, True, card_line)
            torch.cuda.empty_cache()
        cs.cuda_ms = back_to_back(own, REPS["int8_matmul"])
        for name in ("rollout", "serve"):
            cs.check_k2(name, 0, dev, card_line)
            torch.cuda.empty_cache()
        cs.cuda_ms = back_to_back(own, REPS["fused_attention"])
        for name in ("text", "image"):
            for dtype in (torch.float32, torch.bfloat16):
                cs.check_attention(name, dtype, 0, dev, card_line)
    cs.cuda_ms = back_to_back(own, REPS["hash_dropout"])
    rows = cs.ROLLOUT_ROWS // 2
    for dtype, shape, extra in (
            (torch.bfloat16, (cs.ROLLOUT_ROWS, cs.H), ()),
            (torch.float32, (cs.ROLLOUT_ROWS, cs.H), ()),
            (torch.bfloat16, (rows, cs.H), ((rows, 0, cs.H, cs.H),))):
        cs.check_dropout("hash_dropout", shape, dtype, 1, dev, True,
                         card_line, extra)
        # the card's own copy of the same bytes, a yardstick of its rate
        x = torch.randn(shape, device=dev).to(dtype)
        y = torch.empty_like(x)
        print(json.dumps({"phase": "copy_yardstick", "shape": list(shape),
                          "dtype": str(dtype), "copy_ms": cs.cuda_ms(
                              lambda: y.copy_(x)), "card": card_line}),
              flush=True)
        del x, y
        torch.cuda.empty_cache()
    cs.cuda_ms = own
    for name, shape, dtype, rate, place in HASH_ONE_CALL:
        extra = () if place is None else (place,)
        res = cs.check_dropout("hash_dropout", shape, getattr(torch, dtype),
                               2, dev, True, card_line, extra, rate=rate)
        x = torch.randn(shape, device=dev, dtype=getattr(torch, dtype))
        trace_ms, launches = hash_trace(cs, x, place)
        print(json.dumps({
            "phase": "hash_site", "site": name, "shape": list(shape),
            "dtype": dtype, "rate": rate, "place": place, "ms": res["ms"],
            "library_ms": res["library_ms"], "trace_ms": trace_ms,
            "traced_launches": launches,
            "library_trace_ms": library_trace_ms(cs, x, rate),
            "bound_ms": res["bound_ms"],
            "bound_share_trace": trace_ms and res["bound_ms"] / trace_ms,
            "card": card_line}), flush=True)
    host_breakdown(cs, dev, card_line)


def main(argv: list) -> None:
    if argv[:1] == ["--child"]:
        child(*argv[1:])
        return
    only = ""
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    if not argv:
        raise SystemExit(__doc__)
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [os.path.realpath(t) for t in argv]
    for tree in trees:
        if os.path.commonpath([tree, here]) != here:
            raise SystemExit(f"{tree} lies outside this checkout ({here})")
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            raise SystemExit(f"{tree} holds no chip_smoke.py")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree, only], check=True, cwd=tree)


if __name__ == "__main__":
    main(sys.argv[1:])
