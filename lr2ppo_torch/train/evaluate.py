"""NDCG evaluation and the ppo_eval case dump (counterpart of
lr2ppo_tpu/train/evaluate.py: _scores_and_ndcg, evaluate_ndcg,
evaluate_cases and format_ndcg).

Under dp every rank holds the whole eval batch (the eval loaders are not
sharded) and `put` (DeviceCtx.put_eval) gives it its slice; each rank
scores its slice, the scores and NDCG rows are all-gathered in rank order,
and the meter runs on the host over the whole batch, as the JAX package
fetches its dp-sharded rows (evaluate.py:53-54). The result is world 1's."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from lr2ppo_torch.ops.losses import cls_expected_scores
from lr2ppo_torch.ops.ndcg import (NDCG_AT_K_DEFAULT, AverageNDCGMeter,
                                   ndcg_from_scores)
from lr2ppo_torch.parallel.mesh import active, fetch_global


def _model_inputs(batch: dict) -> dict:
    """What the eval moves to the device: a LETOR batch has no "img"."""
    return {k: batch[k] for k in ("text", "img", "tgts", "mask")
            if k in batch}


@torch.inference_mode()
def scores_and_ndcg(model, text: torch.Tensor, img: Optional[torch.Tensor],
                    tgts: torch.Tensor, mask: torch.Tensor):
    """(B, T) scores and (B, len(NDCG_AT_K_DEFAULT)) NDCG rows; cls-mode
    logits become expected relevance first."""
    scores = model(text, img)
    if scores.ndim == 3:
        scores = cls_expected_scores(scores)
    rows = ndcg_from_scores(scores, tgts, tuple(NDCG_AT_K_DEFAULT), mask)
    return scores, rows


def evaluate_ndcg(model, eval_loader, put,
                  meter: Optional[AverageNDCGMeter] = None) -> Dict[int, float]:
    """{k: ndcg@k} over an EvalLoader's items; `put` moves a host batch to
    the model's device. Key 100000000 is NDCG@full (the reference's
    model-selection metric, ppo.py:679)."""
    meter = meter or AverageNDCGMeter()
    mesh = active()
    for batch in eval_loader:
        b = put(_model_inputs(batch))
        _, rows = scores_and_ndcg(model, b["text"], b.get("img"), b["tgts"],
                                  b["mask"])
        if mesh.dp > 1:
            n = np.asarray(batch["mask"]).shape[0]
            rows = fetch_global(rows, mesh)[:n]
            keep = np.asarray(batch["mask"]).any(axis=1)
            if keep.any():
                meter.extend(rows[keep])
            continue
        keep = b["mask"].any(dim=1)
        if bool(keep.any()):
            meter.extend(rows[keep].cpu().numpy())
    return meter.value()


def evaluate_cases(model, dataset, eval_loader, out_path: str,
                   put) -> Dict[int, float]:
    """ppo_eval's evaluation (reference ppo_eval.py:401-471): NDCG plus a
    per-item JSON case dump at `out_path` (ppo_eval.py:457-459): the
    predicted order with its scores, the gold targets as given and
    rearranged, the NDCG row, and the item's id and tag strings where the
    dataset has them. Needs an EvalLoader, whose batches carry `_idx`.
    Under a mesh rank 0 writes the dump."""
    meter = AverageNDCGMeter()
    mesh = active()
    cases = []
    for batch in eval_loader:
        if "_idx" not in batch:
            raise ValueError(
                "evaluate_cases needs per-row dataset indices; use an "
                "EvalLoader (it emits '_idx'): a plain Loader would "
                "silently produce an empty case dump")
        idx = np.asarray(batch["_idx"])
        b = put(_model_inputs(batch))
        scores, rows = scores_and_ndcg(model, b["text"], b.get("img"),
                                       b["tgts"], b["mask"])
        mask = np.asarray(batch["mask"])
        scores = fetch_global(scores.float(), mesh)[:mask.shape[0]]
        rows = fetch_global(rows.float(), mesh)[:mask.shape[0]]
        for r in range(mask.shape[0]):
            if not mask[r].any() or idx[r] < 0:
                continue
            t = int(mask[r].sum())
            s = scores[r, :t]
            gold = np.asarray(batch["tgts"][r, :t])
            order = np.argsort(-s)
            meter.extend(rows[r: r + 1])
            case = {
                "pred_order": order.tolist(),
                "pred_scores": s[order].astype(float).tolist(),
                "gold": gold.astype(int).tolist(),
                "gold_rearranged": gold[order].astype(int).tolist(),
                "ndcg": rows[r].astype(float).tolist(),
            }
            if dataset is not None and hasattr(dataset, "examples"):
                iid = dataset.examples[int(idx[r])][0]
                case["id"] = str(iid)
                names = getattr(dataset, "tag_names", {}).get(iid)
                if names:
                    case["tags"] = [names[j] for j in
                                    dataset.examples[int(idx[r])][1]]
                    case["tags_rearranged"] = [case["tags"][j]
                                               for j in order.tolist()]
            cases.append(case)
    if out_path and mesh.is_main:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".",
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(cases, f)
    return meter.value()


def format_ndcg(vals: Dict[int, float]) -> str:
    return "".join(
        "\nNDCG@{}={:.4f}".format(k, vals[k]) for k in sorted(vals))
