"""Batched, masked NDCG@k on the device, and the host-side meter that
averages it, and the host's dcg_at_k / ndcg_at_k (counterpart of
lr2ppo_tpu/ops/ndcg.py; the meter and the host functions are copies of its
numpy code).

Gain is 2^rel - 1, discount 1/log2(pos + 2), and an all-irrelevant ideal
(true DCG <= 1e-6) scores 1. The sorts are stable, like jnp.argsort, so
tied scores rank in the same order in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

NDCG_AT_K_DEFAULT = [1, 3, 5, 10, 20, 100000000]


def dcg_at_k(relevances: np.ndarray, k: int) -> float:
    """DCG@k of one ranked list of relevances, on the host, in float64
    (reference ndcg.py:28-32)."""
    rel = np.asarray(relevances, dtype=np.float64)
    n = min(len(rel), k)
    if n == 0:
        return 0.0
    idx = np.arange(n)
    return float(np.sum((2.0 ** rel[:n] - 1.0) / np.log2(idx + 2.0)))


def ndcg_at_k(predicted_relevance: np.ndarray, true_relevances: np.ndarray,
              k: int) -> float:
    """NDCG@k on the host: 1 where the ideal DCG is <= 1e-6 (ndcg.py:40-41)."""
    true = dcg_at_k(true_relevances, k)
    if true <= 1e-6:
        return 1.0
    return dcg_at_k(predicted_relevance, k) / true


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

    def compute_ndcg_at_k(self, predicted_relevance, true_relevances
                          ) -> None:
        """Append one list's NDCG at every k (relevances in predicted and
        in ideal order)."""
        for k in self.ndcg_at_k:
            self.ndcg[k].append(ndcg_at_k(np.asarray(predicted_relevance),
                                          np.asarray(true_relevances), k))

    def return_ndcg_at_k(self, predicted_relevance, true_relevances
                         ) -> np.ndarray:
        """One list's NDCG at every k as float32, without recording it."""
        return np.asarray([ndcg_at_k(np.asarray(predicted_relevance),
                                     np.asarray(true_relevances), k)
                           for k in self.ndcg_at_k], dtype=np.float32)

    def extend(self, ndcg_rows: np.ndarray) -> None:
        """Append a (N, len(ks)) matrix of per-list NDCG vectors (the
        device-side batched path feeding the host meter)."""
        rows = np.asarray(ndcg_rows).reshape(-1, len(self.ndcg_at_k))
        for row in rows:
            for i, k in enumerate(self.ndcg_at_k):
                self.ndcg[k].append(float(row[i]))
