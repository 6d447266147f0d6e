"""NDCG evaluation (counterpart of lr2ppo_tpu/train/evaluate.py:
_scores_and_ndcg, evaluate_ndcg and format_ndcg)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lr2ppo_torch.ops.losses import cls_expected_scores
from lr2ppo_torch.ops.ndcg import (NDCG_AT_K_DEFAULT, AverageNDCGMeter,
                                   ndcg_from_scores)


@torch.inference_mode()
def scores_and_ndcg(model, text: torch.Tensor, img: torch.Tensor,
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
    for batch in eval_loader:
        b = put({k: batch[k] for k in ("text", "img", "tgts", "mask")})
        _, rows = scores_and_ndcg(model, b["text"], b["img"], b["tgts"],
                                  b["mask"])
        keep = b["mask"].any(dim=1)
        if bool(keep.any()):
            meter.extend(rows[keep].cpu().numpy())
    return meter.value()


def format_ndcg(vals: Dict[int, float]) -> str:
    return "".join(
        "\nNDCG@{}={:.4f}".format(k, vals[k]) for k in sorted(vals))
