"""Loss functions with the reference's semantics (counterpart of
lr2ppo_tpu/ops/losses.py). Each names the reference source it reproduces;
the tests hold each against the JAX function at float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lr2ppo_torch.parallel.tp import dp_sum


def safe_log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """log(max(t, eps)) — reference finetune/ppo.py:431-432."""
    return torch.log(torch.clamp(t, min=eps))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 0.3) -> torch.Tensor:
    """SmoothL1 (Huber) with beta, mean reduction (finetune/pointwise.py:229):
    0.5*d^2/beta for |d| < beta else |d| - 0.5*beta."""
    d = torch.abs(pred.reshape(-1) - target.reshape(-1).to(pred.dtype))
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return loss.mean()


def nll_3way_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """NLLLoss(LogSoftmax(logits)) — finetune/pointwise.py:233 ('cls')."""
    logp = F.log_softmax(logits, dim=-1).reshape(-1, logits.shape[-1])
    picked = torch.gather(logp, 1, targets.reshape(-1, 1).long())
    return -picked.mean()


def rank_hinge_loss(scores: torch.Tensor, indices: torch.Tensor,
                    margin: float) -> torch.Tensor:
    """RankLoss — finetune/ppo.py:38-55.

    Gathers `scores` (B, T) by `indices` (B, K), the order to enforce (best
    first), and averages the hinge violations relu(margin - (s_i - s_j))
    over the upper-triangular pairs over the count of *violating* pairs of
    the whole batch (a sum of sign(hinge), not a per-row count). 0 when no
    pair violates. Under dp the batch is global, as in JAX: the hinge sum
    and the count are summed over the dp ranks before the division, so the
    loss is not a mean of per-rank ratios."""
    s = torch.gather(scores, 1, indices.long())                 # (B, K)
    diff = margin - (s[:, :, None] - s[:, None, :])            # (B, K, K)
    hinge = torch.relu(torch.triu(diff, diagonal=1))
    # sign() passes no gradient: the count is a constant of the loss
    cnt = dp_sum(torch.sign(hinge).sum().detach())
    return dp_sum(hinge.sum()) / torch.clamp(cnt, min=1.0)


def reward_pair_hinge_loss(chosen: torch.Tensor, rejected: torch.Tensor,
                           margin: float = 1.0) -> torch.Tensor:
    """Stage-2 reward loss relu(m - (s_chosen - s_rejected)).mean()
    (reward_pair_dataloader.py:355-357, reward_trad.py:273)."""
    return torch.relu(margin - (chosen - rejected)).mean()


def clipped_value_loss(values: torch.Tensor, rewards: torch.Tensor,
                       old_values: torch.Tensor, clip: float) -> torch.Tensor:
    """PPO-style clipped value loss — finetune/ppo.py:494-498."""
    value_clipped = old_values + torch.clamp(values - old_values, -clip, clip)
    l1 = (value_clipped.reshape(-1) - rewards) ** 2
    l2 = (values.reshape(-1) - rewards) ** 2
    return torch.maximum(l1, l2).mean()


def categorical_kl(old_scores: torch.Tensor, new_scores: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """KL(softmax(old) || softmax(new)) summed over `dim`, no reduction
    (ppo.py:544-548, logs clamped at 1e-20)."""
    p_old = torch.softmax(old_scores, dim=dim)
    p_new = torch.softmax(new_scores, dim=dim)
    return (p_old * (safe_log(p_old) - safe_log(p_new))).sum(dim=dim)


def categorical_entropy(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """-(p * log p).sum(dim) with p = softmax(scores) — ppo.py:550-553."""
    p = torch.softmax(scores, dim=dim)
    return -(p * safe_log(p)).sum(dim=dim)


def log_sig_loss(chosen: torch.Tensor, rejected: torch.Tensor) -> torch.Tensor:
    """-log(sigmoid(chosen - rejected) + 1e-10).mean() (pointwise.py:62-66)."""
    return -torch.log(torch.sigmoid(chosen - rejected) + 1e-10).mean()


def cls_expected_scores(logits: torch.Tensor) -> torch.Tensor:
    """'cls'-mode scores = expected relevance over the 3 classes,
    softmax(p)[1] * 1 + softmax(p)[2] * 2 (reference ppo.py:855-859)."""
    p = torch.softmax(logits, dim=-1)
    return p[..., 1] * 1.0 + p[..., 2] * 2.0


def pl_log_prob(scores: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Plackett-Luce log-probability of picking `order` (B, K) under `scores`
    (B, T): sum_i [s_{o_i} - logsumexp(s_{o_i..o_K})] (the improved-PPO
    clipped surrogate, ppo.surrogate_clip)."""
    s = torch.gather(scores, 1, order.long())
    lse = torch.logcumsumexp(s.flip(1), dim=1).flip(1)
    return (s - lse).sum(dim=1)


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor,
                   cont: torch.Tensor, gamma: float, lam: float):
    """Generalized Advantage Estimation over a stacked memory window.

    rewards/values: (N, B), the sweep's memories in rollout order; cont:
    (N,) 1.0 where memory i+1 continues memory i's trajectory, 0.0 at
    trajectory/sweep boundaries (bootstrap V=0). Returns (advantages,
    returns), each (N, B). The JAX version's reverse `scan` is a loop over
    the window."""
    v_next = torch.cat([values[1:], torch.zeros_like(values[-1:])])
    delta = rewards + gamma * cont[:, None] * v_next - values
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for i in range(delta.shape[0] - 1, -1, -1):
        carry = delta[i] + gamma * lam * cont[i] * carry
        adv[i] = carry
    return adv, adv + values
