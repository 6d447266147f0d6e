"""Batched, masked NDCG@k on the device (counterpart of the batched path of
lr2ppo_tpu/ops/ndcg.py; its host-side meter is numpy and is used as it is).

Gain is 2^rel - 1, discount 1/log2(pos + 2), and an all-irrelevant ideal
(true DCG <= 1e-6) scores 1. The sorts are stable, like jnp.argsort, so
tied scores rank in the same order in both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NDCG_AT_K_DEFAULT = [1, 3, 5, 10, 20, 100000000]


def ndcg_from_scores(scores: torch.Tensor, gold: torch.Tensor,
                     ks: Sequence[int] = tuple(NDCG_AT_K_DEFAULT),
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., T) scores, integer gold relevances and an optional bool mask of
    real tags -> (..., len(ks)) NDCG@k. Padded tags score float32's minimum
    and gain 0, so they never displace a real tag."""
    scores = scores.float()
    gold = gold.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
        gold = torch.where(mask, gold, 0.0)
    t = gold.shape[-1]
    order = torch.argsort(-scores, dim=-1, stable=True)
    pred_rel = torch.gather(gold, -1, order)
    ideal_rel = -torch.sort(-gold, dim=-1, stable=True).values
    pos = torch.arange(t, dtype=torch.float32, device=scores.device)
    discount = 1.0 / torch.log2(pos + 2.0)
    gains_pred = (torch.exp2(pred_rel) - 1.0) * discount
    gains_ideal = (torch.exp2(ideal_rel) - 1.0) * discount
    out = []
    for k in ks:
        within = (pos < k).float()
        dcg = (gains_pred * within).sum(-1)
        idcg = (gains_ideal * within).sum(-1)
        out.append(torch.where(idcg <= 1e-6, 1.0, dcg / idcg))
    return torch.stack(out, dim=-1)
