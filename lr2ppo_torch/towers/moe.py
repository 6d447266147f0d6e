"""The mixture-of-experts feed-forward of the DeepSeek-V3 block (arXiv:
2412.19437 §2.1.2), as Moonlight-16B-A3B runs it: a sigmoid router over the
routed experts with the aux-loss-free correction bias (`noaux_tc`, one
group), fine-grained SwiGLU experts and shared experts.

Per token x (the router in float32):

  s = sigmoid(W_r x), one score an expert;
  the top k of s + b, where b is the correction bias (a buffer, moved only
      by `update_bias`, never by the optimizer);
  g_j = s_j / sum of the chosen s x routed_scaling_factor;
  y = sum_j g_j E_j(x) + S(x), each E_j SwiGLU of the expert width, S the
      shared SwiGLU of n_shared x that width.

The layer is told which experts it holds (`held`, global ids from the
config's first_held_expert and n_routed_experts): it routes over all of the
router's (router_experts) and computes only its own experts' part of the
sum, plus the shared expert, as one rank of an expert-parallel deployment computes its
share before the exchange. Held experts of several layers that together
hold every expert add up to the whole layer. One card exchanges nothing.

The dispatch sorts the (token, choice) pairs that go to held experts by
expert, so each expert's rows are contiguous, and each expert's three
products are plain matrix products over its rows, differentiated by
autograd; `_BackwardSpan` marks their backward as `moe.experts` too. Splitting
the rows by expert needs the counts on the host: one host sync a layer a
forward (the counter `moe.host_syncs`, which counts a recomputed forward's
sync too, because it happens).

Balance (training passes only):
  * the complementary sequence-wise balance loss alpha sum_i f_i P_i per
    sequence, averaged over the batch's sequences: f_i = n_experts / (k S)
    times the sequence's choices of expert i, P_i the mean over its tokens
    of s_i / sum_j s_j; the caller adds it to the LM loss;
  * the load of each expert over the step's tokens accumulates on the
    device (not in a recomputed forward, utils/remat.py), and after the
    optimizer step `update_bias` moves b_i by gamma sign(mean load -
    load_i) and clears the load. The bias is unchanged between a layer's
    forward and its recompute.

Module keys are the published checkpoint's: `mlp.gate.weight`,
`mlp.gate.e_score_correction_bias`, `mlp.experts.<id>.{gate,up,down}_proj`,
`mlp.shared_experts.*`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.utils import count, recording, span
from lr2ppo_torch.utils.remat import recomputing


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x), no biases (the dense layer, an expert,
    the shared experts)."""

    def __init__(self, d: int, width: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.gate_proj = Linear(d, width, bias=False, dtype=dtype,
                                device=device)
        self.up_proj = Linear(d, width, bias=False, dtype=dtype,
                              device=device)
        self.down_proj = Linear(width, d, bias=False, dtype=dtype,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(Linear):
    """The float32 router W_r with its correction bias b (a buffer)."""

    def __init__(self, d: int, n_experts: int, device=None):
        super().__init__(d, n_experts, bias=False, dtype=torch.float32,
                         device=device)
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(n_experts, device=device))


def route(scores: torch.Tensor, bias: torch.Tensor, k: int,
          scaling: float, norm_topk: bool = True) -> tuple:
    """(chosen expert ids (N, k), their weights (N, k) float32) from the
    sigmoid scores (N, E) and the correction bias."""
    idx = torch.topk(scores + bias, k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def balance_loss(scores: torch.Tensor, idx: torch.Tensor, batch: int,
                 alpha: float) -> torch.Tensor:
    """alpha sum_i f_i P_i per sequence, averaged over the `batch`
    sequences; scores (N, E), idx (N, k), N = batch x S."""
    n_exp, k = scores.shape[1], idx.shape[1]
    s = scores.shape[0] // batch
    probs = (scores / scores.sum(-1, keepdim=True)).view(batch, s, n_exp)
    choices = torch.zeros(batch, n_exp, device=scores.device).scatter_add_(
        1, idx.view(batch, s * k), torch.ones(batch, s * k,
                                              device=scores.device))
    f = choices * (n_exp / (k * s))
    return alpha * (f * probs.mean(1)).sum(1).mean()


class _BackwardSpan(torch.autograd.Function):
    """The identity, marking a block's output (`name` given) or its input
    (`name` None) for the backward: the output's node opens `span(name)`
    and the input's node closes it, and autograd runs the block's backward
    between the two, so its kernels lie in the span. `box` carries the
    open span from one node to the other."""

    @staticmethod
    def forward(ctx, x, name, box):
        ctx.name, ctx.box = name, box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.name is not None:
            ctx.box.append(span(ctx.name))
            ctx.box[-1].__enter__()
        elif ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return grad, None, None


class MoeFeedForward(nn.Module):
    """The MoE feed-forward of one layer over (B, S, d): the router over
    the layer's experts, the experts held here and the shared experts. In
    a training pass (`deterministic` False) it returns the balance loss
    beside its output and counts the load."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        d, n = cfg.hidden_size, cfg.n_router
        self.k = cfg.num_experts_per_tok
        self.scaling = cfg.routed_scaling_factor
        self.norm_topk = cfg.norm_topk_prob
        self.alpha, self.gamma = cfg.aux_loss_alpha, cfg.bias_update_speed
        self.dtype = dtype
        self.held = cfg.held()
        self.gate = Router(d, n, device)
        self.experts = nn.ModuleDict({
            str(e): SwiGLU(d, cfg.moe_intermediate_size, dtype, device)
            for e in self.held})
        self.shared_experts = SwiGLU(
            d, cfg.moe_intermediate_size * cfg.n_shared_experts, dtype,
            device)
        slot = torch.full((n,), -1, dtype=torch.long)
        slot[torch.tensor(self.held, dtype=torch.long)] = torch.arange(
            len(self.held))
        self.register_buffer("slot", slot.to(device), persistent=False)
        self.register_buffer("load", torch.zeros(n, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        """(y (B, S, d), the balance loss or None)."""
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        dt = self.dtype or x.dtype
        train = not deterministic
        with span("moe.route"):
            scores = torch.sigmoid(self.gate(xf))
            idx, w = route(scores, self.gate.e_score_correction_bias, self.k,
                           self.scaling, self.norm_topk)
            aux = (balance_loss(scores, idx, b, self.alpha) if train
                   else None)
        with span("moe.dispatch"):
            local = self.slot[idx.reshape(-1)]
            held = local >= 0
            if train and not recomputing():
                self.load += torch.bincount(idx.reshape(-1),
                                            minlength=self.load.numel())
                if recording():
                    count("moe.assignments", held.sum())
            order = torch.argsort(torch.where(held, local, len(self.held)),
                                  stable=True)
            sizes = torch.bincount(local[held],
                                   minlength=len(self.held)).tolist()
            count("moe.host_syncs", 1)
            order = order[:sum(sizes)]
            tok = order // self.k
            xs = xf[tok].to(dt)
            ws = w.reshape(-1)[order]
        with span("moe.experts"):
            box: List = []
            rows = _BackwardSpan.apply(xs, None, box).split(sizes)
            ys = _BackwardSpan.apply(torch.cat([
                self.experts[str(e)](r) for e, r in zip(self.held, rows)]),
                "moe.experts", box)
        with span("moe.dispatch"):
            routed = torch.zeros(b * s, d, device=x.device).index_add_(
                0, tok, ys.float() * ws[:, None])
        with span("moe.shared"):
            y = routed + self.shared_experts(xf).float()
        return y.view(b, s, d), aux

    @torch.no_grad()
    def update_bias(self) -> None:
        """b_i += gamma sign(mean load - load_i) over the load counted since
        the last call, then the load is cleared."""
        self.gate.e_score_correction_bias.add_(
            torch.sign(self.load.mean() - self.load) * self.gamma)
        self.load.zero_()
