"""Fusion building blocks: Linear, Mlp and the XiT cross-attention block
(counterpart of lr2ppo_tpu/models/layers.py).

The modules hold their weights in the reference's torch key layout
(lr2ppo_tpu/train/checkpoints.py:17-22), so a reference `.bin` or a bridged
JAX checkpoint loads with `load_state_dict(strict=True)`.

Faithful attention keeps the reference's quirks: no scaling before the
softmax, the probabilities divided by sqrt(feat_size) after it, and a causal
mask that is a no-op. Fast mode (`faithful=False`) is scaled dot-product
attention with a real causal mask.

Training (`deterministic=False`) draws each active dropout site's seed from
the caller's CPU `torch.Generator` (ops/hash_dropout.py:module_dropout);
the fused int8 FFN runs on the deterministic path only, where the dropout
between fc1 and fc2 is inactive.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.ops import int8 as int8_ops
from lr2ppo_torch.ops.hash_dropout import module_dropout
from lr2ppo_torch.ops.int8_mlp import int8_mlp, supported
from lr2ppo_torch.parallel.tp import (copy_to_tp, gather_seq, reduce_from_tp,
                                      reduce_scatter_seq, seq_param)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """dtype None keeps x's dtype."""
    return x if dtype is None else x.to(dtype)


class Linear(nn.Module):
    """torch.nn.Linear's keys (`weight` (out, in), `bias`) with the JAX
    TorchDense's init styles, compute dtype and int8 flag.

    With `int8`, a weight that passes `should_quantize` is an int8 tensor
    with a float32 `weight_scale` sibling (the layout quantize_state_dict
    writes); smaller weights stay float, as in JAX.

    A layer marked `seq_parallel` (a tower layer's, under --sp) gets its tp
    mesh as `sp_mesh` from shard_tp: split over tp, it reads and writes the
    sequence-split stream (parallel/tp.py: gather_seq, reduce_scatter_seq).
    """

    seq_parallel = False
    sp_mesh = None

    def __init__(self, in_features: int, out_features: int,
                 init_style: str = "torch_default", bias: bool = True,
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.init_style = init_style
        self.dtype = dtype
        self.use_int8 = int8 and int8_ops.should_quantize(
            (in_features, out_features))
        if self.use_int8:
            self.weight = nn.Parameter(
                torch.empty(out_features, in_features, dtype=torch.int8,
                            device=device), requires_grad=False)
            self.weight_scale = nn.Parameter(
                torch.ones(out_features, device=device), requires_grad=False)
        else:
            self.weight = nn.Parameter(
                torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)
        # set by split_tp: the weight dim split over tp (0 column, 1 row)
        # and the mesh whose tp group holds the other parts
        self.tp_dim: Optional[int] = None
        self.mesh = None

    @torch.no_grad()
    def split_tp(self, dim: int, mesh) -> None:
        """Keep this tp rank's part of a full-width layer: rows of the
        (out, in) weight for a column split (dim 0, with the bias and the
        int8 scale), columns for a row split (dim 1; the bias and the
        per-output scale stay whole). in_features and out_features stay the
        global widths."""
        from lr2ppo_torch.parallel.mesh import shard_slice

        def part(p):
            return nn.Parameter(
                shard_slice(p, dim, mesh.tp_rank, mesh.tp).clone(),
                requires_grad=p.requires_grad)

        self.weight = part(self.weight)
        if dim == 0:
            if self.bias is not None:
                self.bias = part(self.bias)
            if self.use_int8:
                self.weight_scale = part(self.weight_scale)
        self.tp_dim, self.mesh = dim, mesh

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """'torch_default': U(+-1/sqrt(fan_in)) for weight and bias (torch's
        kaiming_uniform(a=sqrt(5))); 'normal_0.02': N(0, 0.02) for both."""
        if self.weight.dtype == torch.int8:
            raise ValueError("initialize the float model, then quantize")
        params = [self.weight] + ([self.bias] if self.bias is not None else [])
        for p in params:
            if self.init_style == "normal_0.02":
                p.normal_(0.0, 0.02, generator=generator)
            else:
                bound = 1.0 / math.sqrt(self.in_features)
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        sp = self.sp_mesh is not None and self.tp_dim is not None
        if self.tp_dim == 0:
            x = gather_seq(x, self.mesh) if sp else copy_to_tp(x, self.mesh)
        if self.use_int8:
            # the route gates see the global shape, as in JAX; a row split
            # quantizes x per row over the whole row (amax over tp) and
            # comes back summed over tp
            y = int8_ops.int8_linear(
                x.to(dt), self.weight, self.weight_scale, dt,
                shape=(self.out_features, self.in_features),
                mesh=self.mesh if self.tp_dim == 1 else None)
        else:
            y = torch.matmul(x.to(dt), self.weight.to(dt).t())
            if self.tp_dim == 1:
                y = (reduce_scatter_seq(y, self.mesh) if sp
                     else reduce_from_tp(y, self.mesh))
        if self.bias is not None:
            bias = self.bias.to(y.dtype)
            y = y + (seq_param(bias, y, self.mesh)
                     if sp and self.tp_dim == 1 else bias)
        return y


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm numerics: float32 statistics by E[x^2] - E[x]^2 and a
    result in the promoted dtype of x and the parameters."""

    def __init__(self, d: int, device=None):
        super().__init__(d, eps=1e-5, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                              0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mu) * mul + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def fused_int8_ffn_ok(fc1: Linear, fc2: Linear, x_shape,
                      deterministic: bool = True) -> bool:
    """Route fc1 -> GELU -> fc2 through the fused int8 kernel? The JAX gate
    (models/layers.py:_fused_int8_ffn_ok) in its order: the deterministic
    path, both weights int8, the site compute-bound, and shapes the kernel
    takes.

    Where it runs under a mesh: the JAX gate turns the kernel off in every
    multi-device program, because a pallas_call has no partitioning rule.
    In the port each rank is one device running its own program, so under
    dp alone the kernel runs on every rank, gated on the rank's own rows.
    Under tp it never runs: fc1 is column-split, and the kernel's second
    quantization takes each hidden row's amax over the whole row, which tp
    splits; the unfused route takes that amax as a max over tp instead."""
    d, hdn, out = fc1.in_features, fc1.out_features, fc2.out_features
    rows = math.prod(x_shape[:-1])
    return (deterministic and fc1.use_int8 and fc2.use_int8
            and fc1.tp_dim is None and fc2.tp_dim is None
            and int8_ops.FUSED_FFN
            and int8_ops.should_quantize((d, hdn))
            and int8_ops.should_quantize((hdn, out))
            and 2 * rows * d * hdn >= int8_ops.INT8_DYNQUANT_MIN_FLOPS
            and supported(x_shape, (hdn, d), (out, hdn)))


def gelu_ffn(fc1: Linear, fc2: Linear, x: torch.Tensor, dtype,
             drop=None) -> torch.Tensor:
    """fc2(drop(GELU(fc1(x)))), exact GELU; `drop` is the dropout between
    the two (None on the deterministic path). Where fused_int8_ffn_ok routes
    it, the whole int8 FFN runs in one kernel (ops/int8_mlp.py)."""
    if not fused_int8_ffn_ok(fc1, fc2, x.shape, drop is None):
        h = F.gelu(fc1(x), approximate="none")
        if drop is not None:
            # the hidden is column-split over tp where fc1 is
            h = drop(h, -1 if fc1.tp_dim == 0 else None)
        return fc2(h)
    out_dtype = dtype or x.dtype
    return int8_mlp(x.to(out_dtype), fc1.weight, fc1.weight_scale.float(),
                    fc1.bias.float(), fc2.weight, fc2.weight_scale.float(),
                    fc2.bias.float(), out_dtype=out_dtype)


class Mlp(nn.Module):
    """fc1 -> GELU(exact) -> drop -> fc2 -> drop (reference ppo.py:154-170);
    `drop` is 0.0 in the fusion trunk. Its dropout is canonical (the JAX
    Mlp's nn.Dropout)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, init_style: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 device=None, drop: float = 0.0):
        super().__init__()
        self.dtype, self.drop = dtype, drop
        self.fc1 = Linear(in_features, hidden_features, init_style,
                          dtype=dtype, int8=int8, device=device)
        self.fc2 = Linear(hidden_features, out_features, init_style,
                          dtype=dtype, int8=int8, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic:
            return gelu_ffn(self.fc1, self.fc2, x, self.dtype)

        def drop(t, tp_from=None):
            return module_dropout(t, self.drop, False, generator, False,
                                  tp_from=tp_from)

        return drop(gelu_ffn(self.fc1, self.fc2, x, self.dtype, drop))


class XiTAttention(nn.Module):
    """Multi-head cross attention, queries from x, keys and values from y
    (reference xit.py:113-148)."""

    def __init__(self, feat_size: int = 768, num_heads: int = 8,
                 causal: bool = False, faithful: bool = True,
                 init_style: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 device=None):
        super().__init__()
        self.feat_size, self.num_heads = feat_size, num_heads
        self.causal, self.faithful, self.dtype = causal, faithful, dtype
        for name in ("queries", "keys", "values", "projection"):
            setattr(self, name, Linear(feat_size, feat_size, init_style,
                                       dtype=dtype, int8=int8, device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d, h = self.feat_size, self.num_heads
        dh = d // h
        # (..., heads, tokens, dh); y's leading dims broadcast against x's
        q = self.queries(x)
        # under tp this rank holds h / tp heads; the faithful scale below
        # stays the global sqrt(feat_size)
        h = q.shape[-1] // dh
        *bq, nq, _ = q.shape
        q = q.reshape(*bq, nq, h, dh).transpose(-3, -2)
        k = self.keys(y)
        *bk, nk, _ = k.shape
        k = k.reshape(*bk, nk, h, dh).transpose(-3, -2)
        v = self.values(y).reshape(*bk, nk, h, dh).transpose(-3, -2)
        # JAX computes the energies in the compute dtype, float32 if none
        edt = self.dtype or torch.float32
        energy = torch.matmul(q.to(edt), k.to(edt).transpose(-1, -2))
        if self.faithful:
            # reference quirk: softmax of unscaled energies, then divide the
            # probabilities by sqrt(feat_size); the causal mask is a no-op
            att = torch.softmax(energy, dim=-1) / math.sqrt(d)
        else:
            energy = energy / math.sqrt(dh)
            if self.causal:
                mask = torch.ones(nq, nk, dtype=torch.bool,
                                  device=energy.device).tril()
                energy = torch.where(mask, energy,
                                     torch.finfo(energy.dtype).min)
            att = torch.softmax(energy, dim=-1)
        out = torch.matmul(att, v.to(edt)).transpose(-3, -2)
        return self.projection(out.reshape(*bq, nq, h * dh))


class _Residual(nn.Module):
    """The reference's ResidualAdd: its sublayers are indexed under `fn`."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.fn = nn.ModuleList(layers)


class _NormPair(nn.Module):
    """Pre-attention LayerNorms of the queries' and the keys' stream."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.ln_x = LayerNorm(d, device=device)
        self.ln_y = LayerNorm(d, device=device)


class XiT(nn.Module):
    """One pre-LN cross-attention block, an FFN and a final LayerNorm
    (reference xit.py:9-42), under the reference's keys:
      0.0.0.fn.0.ln_x / ln_y    0.0.0.fn.1.{queries,keys,values,projection}
      0.0.1.fn.0 (LayerNorm)    0.0.1.fn.1.0 (fc1), 0.0.1.fn.1.3 (fc2)
      1.0 (final LayerNorm)
    Positions 1 and 2 of the FFN list are the reference's GELU and Dropout,
    which hold no weights.

    Three dropout sites, in this order: after attention (drop_p), inside
    the FFN (forward_drop_p) and after it (drop_p). `hash_dropout`,
    `fast_dropout` and `pallas_dropout` pick the backend
    (ops/hash_dropout.py:module_dropout); the Philox kernel takes only
    sites of at least PALLAS_DROPOUT_MIN_ELEMENTS elements."""

    # the JAX package's gate (models/layers.py:277): only the FFN-inner
    # site of the trunk reaches it at batch 256
    PALLAS_DROPOUT_MIN_ELEMENTS = 128 * 1024 * 1024

    def __init__(self, feat_size: int = 768, num_heads: int = 8,
                 causal: bool = False, faithful: bool = True,
                 forward_expansion: int = 4, init_style: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 device=None, drop_p: float = 0.1,
                 forward_drop_p: float = 0.1, hash_dropout: bool = False,
                 fast_dropout: bool = False, pallas_dropout: bool = False):
        super().__init__()
        d, hdn = feat_size, forward_expansion * feat_size
        self.dtype = dtype
        self.drop_p, self.forward_drop_p = drop_p, forward_drop_p
        self.backends = (hash_dropout, fast_dropout, pallas_dropout)
        attn = _Residual(
            _NormPair(d, device),
            XiTAttention(d, num_heads, causal, faithful, init_style, dtype,
                         int8, device))
        ffn = nn.ModuleList([
            Linear(d, hdn, init_style, dtype=dtype, int8=int8, device=device),
            nn.Identity(), nn.Identity(),
            Linear(hdn, d, init_style, dtype=dtype, int8=int8, device=device)])
        block = nn.ModuleList([attn, _Residual(LayerNorm(d, device), ffn)])
        self.add_module("0", nn.ModuleList([block]))
        self.add_module("1", nn.ModuleList([LayerNorm(d, device)]))

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(rate):
            return lambda t, tp_from=None: module_dropout(
                t, rate, deterministic, generator, *self.backends,
                self.PALLAS_DROPOUT_MIN_ELEMENTS, tp_from=tp_from)

        attn_res, ffn_res = self._modules["0"][0]
        norms, attn = attn_res.fn
        x = x + drop(self.drop_p)(attn(norms.ln_x(x), norms.ln_y(y)))
        ln_ffn, ffn = ffn_res.fn
        inner = None if deterministic else drop(self.forward_drop_p)
        h = gelu_ffn(ffn[0], ffn[3], ln_ffn(x), self.dtype, inner)
        x = x + drop(self.drop_p)(h)
        return self._modules["1"][0](x)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Initialize every Linear, LayerNorm and position embedding of a float
    model from one explicit generator (the JAX package's init styles; an
    embedding is N(0, 1), torch's nn.Embedding default)."""
    for m in model.modules():
        if isinstance(m, (Linear, LayerNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
