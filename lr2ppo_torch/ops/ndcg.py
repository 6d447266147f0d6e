"""Batched, masked NDCG@k on the device, and the host-side meter that
averages it (counterpart of lr2ppo_tpu/ops/ndcg.py; the meter is a copy of
its numpy class).

Gain is 2^rel - 1, discount 1/log2(pos + 2), and an all-irrelevant ideal
(true DCG <= 1e-6) scores 1. The sorts are stable, like jnp.argsort, so
tied scores rank in the same order in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
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


class AverageNDCGMeter:
    """Host accumulator mirroring the reference API (ndcg.py:9-65)."""

    def __init__(self, ndcg_at_k: Sequence[int] = tuple(NDCG_AT_K_DEFAULT)):
        self.ndcg_at_k = list(ndcg_at_k)
        self.ndcg: Dict[int, list] = {}
        self.reset()

    def reset(self) -> None:
        for k in self.ndcg_at_k:
            self.ndcg[k] = []

    def value(self) -> Dict[int, float]:
        # NOTE: mutates state like the reference (ndcg.py:21-25)
        for k in self.ndcg:
            vals = self.ndcg[k]
            self.ndcg[k] = (float(np.mean(np.asarray(vals))) if len(vals)
                            else float("nan"))
        return self.ndcg

    def extend(self, ndcg_rows: np.ndarray) -> None:
        """Append a (N, len(ks)) matrix of per-list NDCG vectors (the
        device-side batched path feeding the host meter)."""
        rows = np.asarray(ndcg_rows).reshape(-1, len(self.ndcg_at_k))
        for row in rows:
            for i, k in enumerate(self.ndcg_at_k):
                self.ndcg[k].append(float(row[i]))
