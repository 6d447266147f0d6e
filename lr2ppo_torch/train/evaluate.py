"""Scores and NDCG rows for one eval batch (counterpart of
lr2ppo_tpu/train/evaluate.py:_scores_and_ndcg)."""

from __future__ import annotations

import torch

from lr2ppo_torch.ops.losses import cls_expected_scores
from lr2ppo_torch.ops.ndcg import NDCG_AT_K_DEFAULT, ndcg_from_scores


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
