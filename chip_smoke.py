#!/usr/bin/env python3
"""Drive the PyTorch port's ranking service once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (exit code other than 0):
  1. device: torch and CUDA versions, the card's name and power limit;
  2. build: compile the CUDA kernels from lr2ppo_torch/kernels/csrc;
  3. the fused int8 FFN kernel against its plain PyTorch version at a ragged
     row count and at the serve shape (200,704 rows, D 768, H 3072), in
     float32 and bfloat16, with both times from CUDA events;
  4. the main path: the flagship-width int8 ScoreModel (seeded weights,
     saved as a reference `.bin` and loaded back), served over synthetic
     EvalLoader batches through lr2ppo_torch.cli.serve.serve_batches; the
     kernel's launch count, the rankings' schema and the int8 scores
     against the same weights served in bfloat16 are checked;
  5. breakdown: where a batch's time goes, for the int8 and the bfloat16
     model (host-to-device copy, forward on device-resident inputs, a
     torch.profiler trace summed by kernel, the device's idle share).

Prints JSON lines; the line before the last lists the kernels, and the last
is {"ok": true, "device": {...}}. Without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lr2ppo_torch.cli import serve
from lr2ppo_torch.device import require_cuda
from lr2ppo_torch.kernels import build
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import ModelConfig, ScoreModel
from lr2ppo_torch.ops.int8 import quantize_weight
from lr2ppo_torch.ops.int8_mlp import int8_mlp, int8_mlp_reference
from lr2ppo_torch.train.checkpoints import load_any
from lr2ppo_torch.train.evaluate import scores_and_ndcg

D, H = 768, 3072
SERVE_ROWS = 32 * 32 * 196            # items x tag bucket x text tokens
ITEMS, BUCKET, TAGS = 32, 32, (5, 20)
BATCHES = 4                           # served on the main path


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of `fn` over `iters` timed runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ffn_inputs(rows: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, D), dtype=np.float32)
    w1 = rng.standard_normal((H, D), dtype=np.float32) * 0.05
    b1 = rng.standard_normal(H, dtype=np.float32) * 0.01
    w2 = rng.standard_normal((D, H), dtype=np.float32) * 0.05
    b2 = rng.standard_normal(D, dtype=np.float32) * 0.01
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(dev)
                         for a in (x, w1, b1, w2, b2))
    q1, s1 = quantize_weight(w1)
    q2, s2 = quantize_weight(w2)
    # one step of the second quantization through a w2 row bounds a
    # round-tie flip (the CPU test's bound, tests/test_torch_int8_mlp.py)
    h = torch.nn.functional.gelu(x @ (q1.float() * s1[:, None]).t() + b1)
    step = float(h.abs().max()) / 127.0 * float(
        (q2.float() * s2[:, None]).abs().max())
    return (x, q1, s1, b1, q2, s2, b2), step


def check_kernel(rows: int, out_dtype, seed: int, dev, time_it: bool,
                 card_line: str) -> dict:
    (x, *w), step = ffn_inputs(rows, seed, dev)
    x = x.to(out_dtype)
    got = int8_mlp(x, *w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = int8_mlp_reference(x, *w, out_dtype=out_dtype)
    diff = (got.float() - ref.float()).abs()
    res = {"rows": rows, "dtype": str(out_dtype).replace("torch.", ""),
           "bit_equal": float((got == ref).float().mean()),
           "max_abs_err": float(diff.max()),
           "mean_abs_err": float(diff.mean()),
           "within_2e-5": float((diff <= 2e-5).float().mean()),
           "step_bound": step}
    if not (res["within_2e-5"] > 0.99 and res["max_abs_err"] < 4.0 * step
            and res["mean_abs_err"] < 1e-4):
        emit(phase="kernel_vs_plain", failed=True, **res)
        raise AssertionError(f"int8_mlp disagrees with its plain version: "
                             f"{res}")
    if time_it:
        res["ms"] = cuda_ms(lambda: int8_mlp(x, *w, out_dtype=out_dtype))
        res["plain_ms"] = cuda_ms(
            lambda: int8_mlp_reference(x, *w, out_dtype=out_dtype))
        ops = 2 * 2 * rows * D * H
        res["kernel_tops"] = ops / (res["ms"] * 1e-3) / 1e12
        res["card"] = card_line
    emit(phase="kernel_vs_plain", **res)
    return res


class SyntheticItems:
    """What serve_batches reads of a dataset: examples and tag names."""

    def __init__(self, tag_counts):
        self.examples = [(f"item{i}", list(range(t)))
                         for i, t in enumerate(tag_counts)]
        self.tag_names = {f"item{i}": [f"tag{j}" for j in range(t)]
                          for i, t in enumerate(tag_counts)}


def synthetic_batches(n: int, mcfg: ModelConfig, seed: int):
    """EvalLoader-format batches: 32 items of 5-20 tags each, padded to the
    32-tag bucket (zero text, masked out), made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(TAGS[0], TAGS[1] + 1, size=n * ITEMS)
    batches = []
    for b in range(n):
        text = np.zeros((ITEMS, BUCKET, mcfg.seq_length, mcfg.feat_size),
                        np.float32)
        tgts = np.zeros((ITEMS, BUCKET), np.int32)
        mask = np.zeros((ITEMS, BUCKET), bool)
        for i in range(ITEMS):
            t = counts[b * ITEMS + i]
            text[i, :t] = rng.standard_normal(
                (t, mcfg.seq_length, mcfg.feat_size), dtype=np.float32)
            tgts[i, :t] = rng.integers(0, 3, size=t)
            tgts[i, 0] = 2                     # every item has gold labels
            mask[i, :t] = True
        img = rng.standard_normal((ITEMS, mcfg.max_imgs, mcfg.feat_size),
                                  dtype=np.float32)
        idx = np.arange(b * ITEMS, (b + 1) * ITEMS, dtype=np.int64)
        batches.append({"text": text, "img": img, "tgts": tgts,
                        "mask": mask, "_idx": idx})
    return batches, SyntheticItems(counts.tolist())


def read_rankings(path: str, ds: SyntheticItems) -> dict:
    """Parse and check the jsonl; returns {id: scores in tag order}."""
    out = {}
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    for ln in lines:
        n = len(ds.tag_names[ln["id"]])
        order, s = ln["pred_order"], ln["pred_scores"]
        if not (set(ln) >= {"id", "pred_order", "pred_scores", "tags",
                            "tags_rearranged", "ndcg"}
                and sorted(order) == list(range(n))
                and s == sorted(s, reverse=True)
                and np.isfinite(s).all()
                and [ln["tags"][j] for j in order] == ln["tags_rearranged"]
                and len(ln["ndcg"]) == 6
                and all(0.0 <= v <= 1.0 + 1e-6 for v in ln["ndcg"])):
            raise AssertionError(f"malformed ranking line: {ln}")
        tag_scores = np.empty(n)
        tag_scores[order] = s
        out[ln["id"]] = tag_scores
    if len(out) != len(lines) or len(out) != len(ds.examples):
        raise AssertionError(f"{len(lines)} ranking lines for "
                             f"{len(ds.examples)} items")
    return out


def main_path(args, dev, card_line: str) -> int:
    mcfg = ModelConfig()                       # flagship widths, one XiT
    dtype = torch.bfloat16                     # the CLI's --profile fast
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = ScoreModel(mcfg, dtype, device=dev)
    init_weights(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "actor.bin")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        del model
        state = load_any(ckpt)
        int8_model = serve.load_model(dataclasses.replace(mcfg, int8=True),
                                      state, dtype, dev)
        bf16_model = serve.load_model(mcfg, state, dtype, dev)
        del state
        batches, ds = synthetic_batches(BATCHES, mcfg, args.seed + 1)
        # one warm-up batch (cuBLAS handles, allocator), then the run
        serve.serve_batches(int8_model, batches[:1], ds, None, dev)
        torch.cuda.synchronize()

        int8_mlp.launches = 0
        path_int8 = os.path.join(tmp, "rankings_int8.jsonl")
        t0 = time.perf_counter()
        with open(path_int8, "w") as sink:
            res = serve.serve_batches(int8_model, batches, ds, sink, dev)
        wall = time.perf_counter() - t0
        launches = int8_mlp.launches

        if launches != 2 * len(batches):
            raise AssertionError(f"int8_mlp launched {launches} times for "
                                 f"{len(batches)} batches, expected 2 each")
        path_bf16 = os.path.join(tmp, "rankings_bf16.jsonl")
        with open(path_bf16, "w") as sink:
            serve.serve_batches(bf16_model, batches, ds, sink, dev)
        got, ref = read_rankings(path_int8, ds), read_rankings(path_bf16, ds)
    spread = max(float(np.abs(v).max()) for v in ref.values())
    err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
    emit(phase="main_path", params=n_params, batches=len(batches),
         items=res["items"], kernel_launches=launches,
         int8_vs_bf16_max_err=err, score_spread=spread,
         items_per_s=res["items"] / wall,
         p50_batch_ms=1e3 * statistics.median(res["batch_seconds"]),
         batch_ms=[1e3 * s for s in res["batch_seconds"]],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         card=card_line)
    # tests/test_int8.py's bound for int8 against float scores
    if not err < 0.05 * spread:
        raise AssertionError(f"int8 scores off the bf16 scores by {err}, "
                             f"spread {spread}")
    breakdown({"int8": int8_model, "bfloat16": bf16_model}, mcfg,
              args.seed + 2, dev, card_line)
    return launches


def _union_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def breakdown(models: dict, mcfg: ModelConfig, seed: int, dev,
              card_line: str) -> None:
    """Phase 5: where a 32-item batch's time goes, for each model, on
    batches made anew for it (host arrays never copied before):
      * h2d_ms: copying one batch's four arrays to the card, host clock;
        h2d_text16_ms: the same text in a 16-bit type;
      * forward_ms: scores_and_ndcg on device-resident inputs, CUDA events;
      * p50_batch_ms, items_per_s: serve_batches over BATCHES batches;
      * a torch.profiler trace of serve_batches over 2 more batches: device
        time summed by kernel name, host-to-device copy time, and the share
        of the traced device window in which no compute kernel ran.
    Emits one line per model, with the ten kernels that took longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, model in models.items():
        batches, ds = synthetic_batches(BATCHES + 4, mcfg, seed)
        keys = ("text", "img", "tgts", "mask")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_in = [serve._tensor(batches[0][k], dev) for k in keys]
        torch.cuda.synchronize()
        h2d_ms = 1e3 * (time.perf_counter() - t0)
        text16 = batches[1]["text"].astype(np.float16)
        t0 = time.perf_counter()
        torch.from_numpy(text16).to(dev)
        torch.cuda.synchronize()
        h2d_text16_ms = 1e3 * (time.perf_counter() - t0)
        forward_ms = cuda_ms(lambda: scores_and_ndcg(model, *dev_in),
                             iters=5, warmup=1)
        del dev_in, text16

        served = serve.serve_batches(model, batches[2:2 + BATCHES], ds, None,
                                     dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve.serve_batches(model, batches[2 + BATCHES:], ds, None, dev)
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if not device:
            raise AssertionError("the profiler traced no device activity")
        copies = [e for e in device if e.name.startswith("Memcpy")]
        kernels = [e for e in device if not e.name.startswith(("Memcpy",
                                                               "Memset"))]
        by_kernel: dict = {}
        for e in kernels:
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        window = (max(e.time_range.end for e in device)
                  - min(e.time_range.start for e in device))
        busy = _union_us([(e.time_range.start, e.time_range.end)
                          for e in kernels])
        h2d = [e for e in copies if "HtoD" in e.name]
        batch_s = served["batch_seconds"]
        res = {
            "h2d_ms": h2d_ms, "h2d_text16_ms": h2d_text16_ms,
            "forward_ms": forward_ms,
            "p50_batch_ms": 1e3 * statistics.median(batch_s),
            "items_per_s": served["items"] / sum(batch_s),
            "traced_batches": len(batches) - 2 - BATCHES,
            "traced_window_ms": window / 1e3,
            "traced_h2d_ms": sum(e.time_range.elapsed_us() for e in h2d) / 1e3,
            "traced_kernel_ms": sum(ms for ms, _ in by_kernel.values()),
            "traced_int8_mlp_ms": sum(ms for k, (ms, _) in by_kernel.items()
                                      if "int8_mlp" in k),
            "idle_share": 1.0 - busy / window,
            "top_kernels": sorted(([k[:100], ms, n]
                                   for k, (ms, n) in by_kernel.items()),
                                  key=lambda r: -r[1])[:10],
        }
        emit(phase="breakdown", model=name, card=card_line, **res)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = require_cuda()                       # raises without a card
    card_line = card()
    print(card_line, flush=True)
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=card_line,
         count=torch.cuda.device_count())

    b = build.build()
    ptxas = [ln.strip() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=b["seconds"], library=b["path"],
         ptxas=ptxas)
    build.library()

    results = [check_kernel(1000, dt, args.seed, dev, False, card_line)
               for dt in (torch.float32, torch.bfloat16)]
    serve_shape = {dt: check_kernel(SERVE_ROWS, dt, args.seed, dev, True,
                                    card_line)
                   for dt in (torch.float32, torch.bfloat16)}
    results += serve_shape.values()

    launches = main_path(args, dev, card_line)

    main_k1 = serve_shape[torch.bfloat16]       # the main path's dtype
    print(card_line, flush=True)
    emit(kernels=[{
        "name": "int8_mlp", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/int8_mlp.cu",
        "replaces": "lr2ppo_tpu/ops/pallas_int8_mlp.py:139",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"]}])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
