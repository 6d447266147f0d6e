"""Transformer layers of the towers (counterpart of
lr2ppo_tpu/towers/layers.py).

The modules carry the TencentPretrain key layout (`self_attn.linear_layers.
{0,1,2}`, `self_attn.final_linear`, `feed_forward.linear_1`, `layer_norm_1.
gamma`, ...), so a reference tower `.bin` loads with
`load_state_dict(strict=True)`. The numerics are the reference's and the
JAX package's:

  * RefLayerNorm divides by (std + eps) with eps outside the square root and
    a Bessel-corrected std; it is neither nn.LayerNorm nor the flax-numerics
    LayerNorm of models/layers.py;
  * attention masks are additive -10000 biases; the plain path adds the T5
    position bias to the raw scores, divides by sqrt(dh), adds the mask and
    then the previous layer's chained scores (residual attention), in the
    JAX layer's order (layers.py:164-170);
  * T5's relative position buckets are computed on the host in float32,
    once per (query, key) length, so every device reads JAX's buckets (a
    one-ulp change of the float32 log flips a bucket).

Under --sp the layers compute on a sequence shard (TransformerLayer).

Training mode (`deterministic=False`) applies the JAX layer's dropout sites
through `module_dropout` (ops/hash_dropout.py): the attention probabilities
and the two residual branches of each layer. Every active site draws its seed
from the caller's CPU `torch.Generator`, in forward order.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.ops.attention import fused_attention
from lr2ppo_torch.ops.hash_dropout import SEQ, module_dropout
from lr2ppo_torch.parallel.tp import seq_param, split_from_tp

ACTS: dict = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_fast": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "linear": lambda x: x,
    "tanh": torch.tanh,
}


class RefLayerNorm(nn.Module):
    """gamma * (x - mean) / (std + eps) + beta with a Bessel-corrected std,
    taken as sqrt(max(var, 1e-20)); float32 statistics; weights named gamma
    and beta (reference layer_norm.py:5-21). Under --sp (`sp_mesh` set by
    shard_tp) it normalizes a sequence shard, and gamma and beta take the
    whole sequence's gradient (parallel/tp.py:seq_param)."""

    seq_parallel = False
    sp_mesh = None

    def __init__(self, d: int, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.gamma = nn.Parameter(torch.ones(d, device=device))
        self.beta = nn.Parameter(torch.zeros(d, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        centered = xf - mean
        var = (centered * centered).mean(-1, keepdim=True)
        var = var * (d / max(d - 1, 1))                # unbiased
        std = torch.sqrt(torch.clamp_min(var, 1e-20))
        gamma = seq_param(self.gamma, centered, self.sp_mesh)
        beta = seq_param(self.beta, centered, self.sp_mesh)
        out = gamma * centered / (std + self.eps) + beta
        return out.to(self.dtype or x.dtype)


class T5LayerNorm(nn.Module):
    """RMS norm with float32 statistics (reference layer_norm.py:24-39);
    under --sp as RefLayerNorm."""

    seq_parallel = False
    sp_mesh = None

    def __init__(self, d: int, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(d, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(-1, keepdim=True)
        out = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return seq_param(self.weight.to(self.dtype or x.dtype), out,
                         self.sp_mesh) * out


def make_layer_norm(kind: str, d: int, dtype=None, device=None) -> nn.Module:
    if kind == "t5":
        return T5LayerNorm(d, dtype=dtype, device=device)
    return RefLayerNorm(d, dtype=dtype, device=device)


def additive_mask_from_seg(seg: torch.Tensor, mask_kind: str) -> torch.Tensor:
    """seg (B, S) -> additive attention bias (B, 1, S, S), float32, 0 where
    visible and -10000 where hidden (transformer_encoder.py:62-90)."""
    b, s = seg.shape
    if mask_kind == "fully_visible":
        vis = (seg > 0)[:, None, None, :].expand(b, 1, s, s)
    elif mask_kind == "causal":
        vis = torch.ones(s, s, dtype=torch.bool, device=seg.device).tril()
        vis = vis[None, None].expand(b, 1, s, s)
    elif mask_kind == "causal_with_prefix":
        mask_a = (seg == 1)[:, None, None, :].float()
        mask_b = (seg > 0)[:, None, None, :].float()
        tril = torch.ones(s, s, device=seg.device).tril()[None, None]
        vis = ((mask_a + mask_b + tril) >= 2).expand(b, 1, s, s)
    else:
        raise ValueError(f"unknown mask: {mask_kind}")
    zero = torch.zeros((), device=seg.device)
    return torch.where(vis, zero, zero - 10000.0)


class MultiHeadedAttention(nn.Module):
    """Reference MHA (multi_headed_attn.py:6-76): separate q/k/v linears
    `linear_layers.{0,1,2}` and the output linear `final_linear`.

    With a `key_bias` (the encoder's gate, on deterministic passes only, never
    with a position bias or chained scores), attention runs through the fused
    kernel (ops/attention.py), as the JAX layer takes the Pallas kernel; the
    plain path drops the probabilities in training mode. `position_bias`
    (1, h, Sq, Sk) and `prev_attn` (B, h, Sq, Sk) hold this rank's heads.
    Returns (out, scores): the chained scores, before the softmax, that a
    residual-attention stack hands to its next layer (None on the fused
    path)."""

    def __init__(self, hidden_size: int, heads_num: int,
                 attention_head_size: int, has_bias: bool = True,
                 with_scale: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None, dropout: float = 0.0,
                 hash_dropout: bool = False):
        super().__init__()
        self.heads_num, self.head_size = heads_num, attention_head_size
        self.with_scale, self.dtype = with_scale, dtype
        self.dropout, self.hash_dropout = dropout, hash_dropout
        inner = heads_num * attention_head_size
        self.linear_layers = nn.ModuleList([
            Linear(hidden_size, inner, bias=has_bias, dtype=dtype,
                   device=device) for _ in range(3)])
        self.final_linear = Linear(inner, hidden_size, bias=has_bias,
                                   dtype=dtype, device=device)

    @property
    def heads_mesh(self):
        """The tp mesh over which this attention's heads are split, or
        None."""
        q = self.linear_layers[0]
        return q.mesh if q.tp_dim == 0 else None

    def forward(self, key: torch.Tensor, value: torch.Tensor,
                query: torch.Tensor, mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor] = None,
                prev_attn: Optional[torch.Tensor] = None,
                key_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        dh = self.head_size
        q = self.linear_layers[0](query)
        k = self.linear_layers[1](key)
        v = self.linear_layers[2](value)
        # under tp this rank holds heads_num / tp heads
        h = q.shape[-1] // dh
        b, sq = q.shape[:2]
        sk = k.shape[1]
        q = q.reshape(b, sq, h, dh).transpose(1, 2)
        k = k.reshape(b, sk, h, dh).transpose(1, 2)
        v = v.reshape(b, sk, h, dh).transpose(1, 2)

        scores = None
        if (key_bias is not None and position_bias is None
                and prev_attn is None and self.with_scale):
            # the JAX gate (towers/layers.py:145-146): q, k, v as strided
            # (B, H, S, dh) views, read by the kernel in place
            out = fused_attention(q, k, v, key_bias.float(),
                                  1.0 / math.sqrt(float(dh)))
        else:
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
            if position_bias is not None:
                scores = scores + position_bias
            if self.with_scale:
                # a tensor divisor: a true division on every device, as JAX
                scores = scores / scores.new_tensor(math.sqrt(float(dh)))
            scores = scores + mask
            if prev_attn is not None:
                scores = scores + prev_attn
            probs = torch.softmax(scores, dim=-1).to(self.dtype or q.dtype)
            probs = module_dropout(
                probs, self.dropout, deterministic, generator,
                self.hash_dropout,
                tp_from=None if self.heads_mesh is None else 1)
            out = torch.matmul(probs, v.to(probs.dtype))
            out = out.to(self.dtype or torch.float32)
        out = out.transpose(1, 2).reshape(b, sq, h * dh)
        return self.final_linear(out), scores


class PositionwiseFeedForward(nn.Module):
    """linear_1 -> act -> linear_2 (position_ffn.py:4-15)."""

    def __init__(self, hidden_size: int, feedforward_size: int,
                 hidden_act: str = "gelu", has_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.act = ACTS[hidden_act]
        self.linear_1 = Linear(hidden_size, feedforward_size, bias=has_bias,
                               dtype=dtype, device=device)
        self.linear_2 = Linear(feedforward_size, hidden_size, bias=has_bias,
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(self.act(self.linear_1(x)))


class GatedFeedForward(nn.Module):
    """act(W_g x) * (W_1 x) -> W_2 (position_ffn.py:18-35)."""

    def __init__(self, hidden_size: int, feedforward_size: int,
                 hidden_act: str = "gelu", has_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.act = ACTS[hidden_act]
        self.linear_gate = Linear(hidden_size, feedforward_size,
                                  bias=has_bias, dtype=dtype, device=device)
        self.linear_1 = Linear(hidden_size, feedforward_size, bias=has_bias,
                               dtype=dtype, device=device)
        self.linear_2 = Linear(feedforward_size, hidden_size, bias=has_bias,
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(self.act(self.linear_gate(x)) * self.linear_1(x))


def t5_relative_buckets(relative_position: torch.Tensor, bidirectional: bool,
                        num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5 bucketing (relative_position_embedding.py:45-92), in the JAX
    function's float32 steps: exact up to num_buckets // 4 (// 2 one-way),
    logarithmic up to max_distance, the last bucket beyond."""
    rel = relative_position
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets = buckets + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp_max(rel, 0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_large = max_exact + (
        torch.log(rel.float() / max_exact + 1e-20)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(rel.dtype)
    rel_large = torch.clamp_max(rel_large, num_buckets - 1)
    return buckets + torch.where(is_small, rel, rel_large)


@lru_cache(maxsize=64)
def _bucket_table(query_length: int, key_length: int, bidirectional: bool,
                  num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """(Sq, Sk) int64 buckets of key - query, computed on the host and kept
    on `device`."""
    ctx = torch.arange(query_length, dtype=torch.int32)[:, None]
    mem = torch.arange(key_length, dtype=torch.int32)[None, :]
    return t5_relative_buckets(mem - ctx, bidirectional, num_buckets,
                               max_distance).long().to(device)


class RelativePositionEmbedding(nn.Module):
    """T5's binned relative position bias (relative_position_embedding.py):
    a (num_buckets, heads) table under `relative_attention_bias.weight`,
    N(0, 1) at init, read as the (1, heads, Sq, Sk) bias of every layer.
    `mesh` (an attention's `heads_mesh`) keeps this rank's heads, the whole
    table's gradient gathered back (parallel/tp.py:split_from_tp), as GSPMD
    slices the bias in JAX."""

    def __init__(self, heads_num: int, bidirectional: bool = True,
                 num_buckets: int = 32, max_distance: int = 128,
                 device=None):
        super().__init__()
        self.bidirectional, self.num_buckets = bidirectional, num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads_num,
                                                    device=device)

    def forward(self, query_length: int, key_length: int,
                mesh=None) -> torch.Tensor:
        table = self.relative_attention_bias.weight
        bucket = _bucket_table(query_length, key_length, self.bidirectional,
                               self.num_buckets, self.max_distance,
                               table.device)
        bias = table[bucket].permute(2, 0, 1)[None]
        return bias if mesh is None else split_from_tp(bias, 1, mesh)


class TransformerLayer(nn.Module):
    """Pre- or post-LN encoder block (transformer.py:8-74). In training mode
    it has three dropout sites, in the order their seeds are drawn: the
    attention probabilities, the attention branch and the FFN branch.
    Returns (out, scores), the attention's chained scores (MultiHeadedAttention).

    Under --sp (`sp_mesh` set by shard_tp) `hidden` is this tp rank's S/tp
    tokens: the column-parallel products gather the sequence, the
    row-parallel ones reduce-scatter it, and the branch dropout sites draw
    the global mask at the shard's place (dims 1.. split over tp)."""

    seq_parallel = False
    sp_mesh = None

    def __init__(self, hidden_size: int, heads_num: int,
                 feedforward_size: int, hidden_act: str = "gelu",
                 layernorm_positioning: str = "post",
                 layernorm: str = "normal", feed_forward: str = "dense",
                 attention_head_size: Optional[int] = None,
                 has_bias: bool = True, with_scale: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 dropout: float = 0.0, hash_dropout: bool = False):
        super().__init__()
        dh = attention_head_size or hidden_size // heads_num
        self.pre = layernorm_positioning == "pre"
        self.dropout, self.hash_dropout = dropout, hash_dropout
        self.self_attn = MultiHeadedAttention(hidden_size, heads_num, dh,
                                              has_bias, with_scale, dtype,
                                              device, dropout, hash_dropout)
        ffn_cls = (GatedFeedForward if feed_forward == "gated"
                   else PositionwiseFeedForward)
        self.feed_forward = ffn_cls(hidden_size, feedforward_size, hidden_act,
                                    has_bias, dtype, device)
        self.layer_norm_1 = make_layer_norm(layernorm, hidden_size, dtype,
                                            device)
        self.layer_norm_2 = make_layer_norm(layernorm, hidden_size, dtype,
                                            device)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor] = None,
                prev_attn: Optional[torch.Tensor] = None,
                key_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        seq = SEQ if self.sp_mesh is not None else None

        def drop(x):
            return module_dropout(x, self.dropout, deterministic, generator,
                                  self.hash_dropout, tp_from=seq)

        if not self.pre:
            inter, scores = self.self_attn(hidden, hidden, hidden, mask,
                                           position_bias, prev_attn, key_bias,
                                           deterministic, generator)
            inter = self.layer_norm_1(drop(inter) + hidden)
            out = self.layer_norm_2(drop(self.feed_forward(inter)) + inter)
            return out, scores
        normed = self.layer_norm_1(hidden)
        inter, scores = self.self_attn(normed, normed, normed, mask,
                                       position_bias, prev_attn, key_bias,
                                       deterministic, generator)
        hidden = hidden + drop(inter)
        out = drop(self.feed_forward(self.layer_norm_2(hidden))) + hidden
        return out, scores


def pooling(memory_bank: torch.Tensor, seg: torch.Tensor,
            pooling_type: str) -> torch.Tensor:
    """first/mean/max/last pooling under the seg mask (utils/misc.py:23-35;
    lr2ppo_tpu/towers/layers.py:pooling)."""
    segf = seg[..., None].to(memory_bank.dtype)
    masked = memory_bank * segf
    if pooling_type == "mean":
        return masked.sum(1) / segf.sum(1)
    if pooling_type == "last":
        last = seg.to(torch.int64).sum(1) - 1
        return masked[torch.arange(masked.shape[0]), last]
    if pooling_type == "max":
        neg = (segf - 1.0) * torch.finfo(torch.float32).max
        return (masked + neg).max(1).values
    return memory_bank[:, 0]
