"""Multi-head latent attention (MLA) of the DeepSeek-V3 block (arXiv:
2412.19437 §2.1.1), without query compression, as Moonlight-16B-A3B runs
it. The towers' other attention is towers/layers.py:MultiHeadedAttention.

Per token x, all products without bias:

  q = W_q x, per head a 128-wide part without position (q_nope) and a
      64-wide rotary part (q_pe);
  [c, k_pe] = W_kva x: the 512-wide latent c and one 64-wide rotary key
      shared by every head; c = RMSNorm(c);
  [k_nope, v] = W_kvb c, per head 128 + 128;
  RoPE (theta from the config) on q_pe and k_pe;
  q = [q_nope, q_pe], k = [k_nope, k_pe], both 192 wide;
  o = W_o causal_softmax(q kᵀ / sqrt(192)) v.

RoPE pairs dimension i with i + 32 after de-interleaving the 64 dims (even
ones first), as DeepSeek-V3's published modeling code does (`apply_rotary_
pos_emb`'s view/transpose before `rotate_half`). The attention itself is
ops/mla_attention.py: the hand-written kernels on a card, the plain version
on the CPU; the causal mask is the kernel's, no mask tensor exists.

The module keys are the published checkpoint's (`self_attn.q_proj`,
`kv_a_proj_with_mqa`, `kv_a_layernorm`, `kv_b_proj`, `o_proj`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.ops.mla_attention import mla_attention
from lr2ppo_torch.towers.layers import T5LayerNorm
from lr2ppo_torch.utils import span


def rope_tables(s: int, dim: int, theta: float, device) -> tuple:
    """(cos, sin), each (s, dim) float32, for positions 0..s-1: frequency
    theta^(-2i/dim) for i < dim/2, the table repeated over both halves."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(s, device=device, dtype=torch.float32),
                        inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, dim) rotated in float32 after de-interleaving its last
    dim, in x's dtype."""
    d = x.shape[-1]
    x = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


class LatentAttention(nn.Module):
    """MLA over (B, S, hidden), causal; returns (B, S, hidden)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.heads = cfg.heads_num
        self.nope, self.rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        self.theta = cfg.rope_theta
        self.scale = 1.0 / math.sqrt(self.nope + self.rope)
        d, h = cfg.hidden_size, self.heads
        self.q_proj = Linear(d, h * (self.nope + self.rope), bias=False,
                             dtype=dtype, device=device)
        self.kv_a_proj_with_mqa = Linear(d, self.rank + self.rope,
                                         bias=False, dtype=dtype,
                                         device=device)
        self.kv_a_layernorm = T5LayerNorm(self.rank, cfg.rms_norm_eps,
                                          dtype=dtype, device=device)
        self.kv_a_layernorm.no_decay = True       # train/optim.py
        self.kv_b_proj = Linear(self.rank, h * (self.nope + self.v_dim),
                                bias=False, dtype=dtype, device=device)
        self.o_proj = Linear(h * self.v_dim, d, bias=False, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.heads
        with span("attn.mla"):
            q = self.q_proj(x).view(b, s, h, self.nope + self.rope)
            c, k_pe = self.kv_a_proj_with_mqa(x).split(
                [self.rank, self.rope], dim=-1)
            kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(
                b, s, h, self.nope + self.v_dim)
            k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
            cos, sin = rope_tables(s, self.rope, self.theta, x.device)
            dt = q.dtype
            q_pe = apply_rope(q[..., self.nope:].transpose(1, 2), cos, sin)
            k_pe = apply_rope(k_pe, cos, sin).to(dt)
            q = torch.cat([q[..., :self.nope],
                           q_pe.transpose(1, 2).to(dt)], dim=-1)
            k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, h,
                                                           self.rope)],
                          dim=-1)
            o = mla_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), self.scale)
            return self.o_proj(o.transpose(1, 2).reshape(b, s,
                                                         h * self.v_dim))
