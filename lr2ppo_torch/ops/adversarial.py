"""Adversarial training (counterpart of lr2ppo_tpu/ops/adversarial.py;
reference tencentpretrain/utils/adversarial.py: FGM and PGD embedding
perturbation), over a dict of named tensors.

The reference mutates `param.data` in place and restores a backup; here a
perturbed dict is made from (params, grads), and the adversarial gradient is
taken at it, as the JAX package does:

  FGM:  p' = p + eps * g / ||g||          on leaves whose name holds emb_name
        total grad = grad(p) + grad(p')
  PGD:  K steps of p' = proj_{||p'-p||<=eps}(p' + alpha * g'/||g'||),
        total grad = grad(p) + grad(p'_K)

A gradient whose norm is zero or not finite leaves its leaf as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _step(g: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * g / ||g||, or zero where ||g|| is zero or not finite."""
    norm = torch.linalg.vector_norm(g)
    ok = (norm > 0) & torch.isfinite(norm)
    safe = torch.where(ok, norm, torch.ones_like(norm))
    return torch.where(ok, scale * g / safe, torch.zeros_like(g))


def fgm_perturb(params: Params, grads: Params, epsilon: float = 1e-6,
                emb_name: str = "embedding") -> Params:
    """p + eps * g / ||g|| on the leaves whose name contains emb_name
    (adversarial.py:14-21); the other leaves as they are."""
    return {k: p + _step(grads[k], epsilon) if emb_name in k else p
            for k, p in params.items()}


def pgd_perturb(params: Params, ref_params: Params, grads: Params,
                epsilon: float = 1.0, alpha: float = 0.3,
                emb_name: str = "embedding") -> Params:
    """One PGD ascent step on the embedding leaves, projected onto the L2
    ball of radius epsilon around ref_params (adversarial.py:42-64)."""

    def step(p, p0, g):
        r = p + _step(g, alpha) - p0
        rn = torch.linalg.vector_norm(r)
        r = torch.where(rn > epsilon, epsilon * r / torch.clamp_min(rn, 1e-12),
                        r)
        return p0 + r

    return {k: step(p, ref_params[k], grads[k]) if emb_name in k else p
            for k, p in params.items()}


def _value_and_grad(loss_fn: Callable, params: Params
                    ) -> Tuple[torch.Tensor, Params]:
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def adversarial_grads(loss_fn: Callable, params: Params, mode: str = "fgm",
                      epsilon: float = 1e-6, alpha: float = 0.3,
                      pgd_k: int = 3, emb_name: str = "embedding"
                      ) -> Tuple[torch.Tensor, Params]:
    """(the clean loss, the clean gradient plus the adversarial one):
    `loss_fn(params)` is a scalar; the gradients are torch.autograd.grad's,
    zero where a leaf does not reach the loss (as jax.grad gives)."""
    loss, g_clean = _value_and_grad(loss_fn, params)
    if mode == "fgm":
        p_adv = fgm_perturb(params, g_clean, epsilon, emb_name)
        _, g_adv = _value_and_grad(loss_fn, p_adv)
    elif mode == "pgd":
        p_adv, g_adv = params, g_clean
        for _ in range(pgd_k):
            p_adv = pgd_perturb(p_adv, params, g_adv, epsilon, alpha,
                                emb_name)
            _, g_adv = _value_and_grad(loss_fn, p_adv)
    else:
        raise ValueError(f"unknown adversarial mode: {mode}")
    return loss, {k: g_clean[k] + g_adv[k] for k in g_clean}
