"""Ranking service entry point (counterpart of lr2ppo_tpu/cli/serve.py):

    python -m lr2ppo_torch.cli.serve --pretrained_model_path CKPT \\
        --test_path data.json --ranking_path rankings.jsonl [--int8 false]

Loads an actor checkpoint (a JAX package pickle or a reference `.bin`),
quantizes it to int8 at load unless `--int8 false`, scores every item of the
MovieNet json + h5 store in bucketed `EvalLoader` batches, and writes one
JSON line per item:

    {"id", "pred_order", "pred_scores"[, "tags", "tags_rearranged"][, "ndcg"]}

It takes the JAX package's flags (lr2ppo_torch/config.py, the port's copy
of its flag table) and runs on one GPU, or on one process per GPU under
torchrun or --distributed with --dp and --tp, as the JAX service serves at
dp (serve.py:84-124): the model is quantized whole first and only then split
over tp, so a row-split layer keeps the global per-channel scales; each
rank scores its dp slice of every batch (DeviceCtx.put_eval), the scores
are gathered in rank order, and rank 0 alone writes the rankings. The fused
int8 FFN runs per rank at dp and not under tp (models/layers.py:
fused_int8_ffn_ok).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from lr2ppo_torch.cli._common import movienet_eval_loader
from lr2ppo_torch.config import ModelConfig, parse_config
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.models.scorer import ScoreModel
from lr2ppo_torch.ops.int8 import quantize_state_dict
from lr2ppo_torch.parallel.mesh import active, fetch_global
from lr2ppo_torch.train.checkpoints import load_any
from lr2ppo_torch.train.common import device_ctx
from lr2ppo_torch.train.evaluate import scores_and_ndcg
from lr2ppo_torch.utils import init_logger

def int8_flag(argv, cfg_int8: bool) -> bool:
    """Serving defaults to int8. parse_config cannot tell an absent flag from
    its default, so an explicit `--int8` or `--int8=...` decides, and
    nothing else does (not a prefix such as `--int8_extra`)."""
    given = any(a == "--int8" or a.startswith("--int8=") for a in argv)
    return cfg_int8 if given else True


def load_model(mcfg: ModelConfig, state: dict, dtype: torch.dtype,
               device: torch.device) -> ScoreModel:
    """A ScoreModel holding `state` on `device`, quantized to int8 first
    when `mcfg.int8` (once, at load). The module is built without storage
    and takes the state's tensors as they are (strict keys)."""
    state = {k: v.to(device) for k, v in state.items()}
    if mcfg.int8:
        state = quantize_state_dict(state, dtype)
    model = ScoreModel(mcfg, dtype, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


def serving_model(cfg, state: dict, int8: bool, ctx) -> ScoreModel:
    """The service's model on `ctx` (train/common.py:device_ctx): `state`
    quantized whole to int8 where `int8`, and only then split over the mesh,
    so a row-split layer keeps the global per-channel scales (the JAX
    service's quantize_tree, then place)."""
    dtype = compute_dtype(cfg.mesh.compute_dtype)
    model = load_model(dataclasses.replace(cfg.model, int8=int8), state,
                       dtype, ctx.device)
    return ctx.place(model, fsdp=False)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes arrays from the loader
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def serve_batches(model: ScoreModel, batches, ds, sink,
                  device: torch.device, put=None) -> dict:
    """Score EvalLoader batches (`text`, `img`, `tgts`, `mask`, `_idx`) and
    write one ranking line per real item to `sink` (None writes nothing).
    `ds.examples[i]` is (item id, tag indices); `ds.tag_names`, where
    present, maps an id to its tag names. `put` (DeviceCtx.put_eval) moves
    this dp rank's rows of a batch to the device, and the scores of every
    rank are gathered (every rank calls it); without it the whole batch
    goes to `device`. Returns the item count and each batch's seconds, host
    to host."""
    n_items, seconds = 0, []
    mesh = active()
    for batch in batches:
        if "_idx" not in batch:
            raise ValueError("serve needs an EvalLoader batch "
                             "(with '_idx' row indices)")
        t0 = time.perf_counter()
        inputs = {k: batch[k] for k in ("text", "img", "tgts", "mask")}
        b = (put(inputs) if put is not None
             else {k: _tensor(v, device) for k, v in inputs.items()})
        scores, rows = scores_and_ndcg(model, b["text"], b["img"], b["tgts"],
                                       b["mask"])
        mask = np.asarray(batch["mask"])
        scores = fetch_global(scores.float(), mesh)[:mask.shape[0]]
        rows = fetch_global(rows, mesh)[:mask.shape[0]]
        seconds.append(time.perf_counter() - t0)
        idx = np.asarray(batch["_idx"])
        tgts = np.asarray(batch["tgts"])
        for b in range(mask.shape[0]):
            if not mask[b].any() or idx[b] < 0:
                continue
            t = int(mask[b].sum())
            s = np.asarray(scores[b, :t], np.float64)
            order = np.argsort(-s)
            iid, tag_ids = ds.examples[int(idx[b])][:2]
            line = {"id": str(iid), "pred_order": order.tolist(),
                    "pred_scores": s[order].tolist()}
            names = getattr(ds, "tag_names", {}).get(iid)
            if names is not None:
                line["tags"] = [names[j] for j in tag_ids]
                line["tags_rearranged"] = [line["tags"][j]
                                           for j in order.tolist()]
            if tgts[b, :t].any():
                line["ndcg"] = np.asarray(rows[b], np.float64).tolist()
            n_items += 1
            if sink is not None:
                sink.write(json.dumps(line) + "\n")
    return {"items": n_items, "batch_seconds": seconds}


def main(argv=None, device=None):
    """`device` defaults to the GPU (raising where there is none); the CPU
    parity tests pass torch.device("cpu"). Under a mesh every rank serves
    and rank 0 writes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_config(argv, "lr2ppo-torch ranking service")
    ctx = device_ctx(cfg, device)
    logger = init_logger(cfg.log_path, main=ctx.is_main)

    int8 = int8_flag(argv, cfg.model.int8)
    ckpt = load_any(cfg.pretrained_model_path, kind="actor_critic")
    model = serving_model(cfg, ckpt["actor"] if "actor" in ckpt else ckpt,
                          int8, ctx)
    device = ctx.device

    path = cfg.data.test_path or cfg.data.dev_path
    ev = movienet_eval_loader(cfg, path=path)
    out_path = cfg.data.ranking_path
    if ctx.is_main and os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    t0 = time.perf_counter()
    sink = open(out_path, "w") if ctx.is_main else None
    try:
        res = serve_batches(model, ev, ev.ds, sink, device,
                            put=ctx.put_eval if ctx.mesh.world > 1 else None)
    finally:
        if sink is not None:
            sink.close()
    dt = time.perf_counter() - t0
    n_items = res["items"]
    logger.info("served %d items in %.2fs (%.1f items/s, int8=%s, %s) -> %s",
                n_items, dt, n_items / max(dt, 1e-9), int8, device, out_path)
    return {"items": n_items, "items_per_s": n_items / max(dt, 1e-9),
            "int8": int8, "ranking_path": out_path}


if __name__ == "__main__":
    main()
