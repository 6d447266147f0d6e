"""Loss-side helpers (counterpart of lr2ppo_tpu/ops/losses.py). The eval
path needs only `cls_expected_scores`; the training losses are not ported
yet."""

from __future__ import annotations

import torch


def cls_expected_scores(logits: torch.Tensor) -> torch.Tensor:
    """'cls'-mode scores = expected relevance over the 3 classes,
    softmax(p)[1] * 1 + softmax(p)[2] * 2 (reference ppo.py:855-859)."""
    p = torch.softmax(logits, dim=-1)
    return p[..., 1] * 1.0 + p[..., 2] * 2.0
