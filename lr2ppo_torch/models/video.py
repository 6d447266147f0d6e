"""CLIP-style frame transformer and projection head (counterpart of
lr2ppo_tpu/models/video.py; reference finetune/video_transformer.py:8-93 and
finetune/project_embedding.py:5-26).

The reference's stage-1/2 scripts import VideoTransformer but never build it
(SURVEY §2.2); the modules are here for the API. They hold the reference's
keys: `class_embedding`, `positional_embedding`, `proj`, `ln_pre`,
`transformer.resblocks.<i>.{ln_1,attn,ln_2,mlp.c_fc,mlp.c_proj}`,
`ln_post` (attn as torch's nn.MultiheadAttention, `in_proj_weight` (3d, d),
`in_proj_bias`, `out_proj`), and `projection`, `fc`, `layer_norm`. The
attention computes what the JAX package's flax MultiHeadDotProductAttention
does: separate query, key and value projections with biases, the query
scaled by 1/sqrt(head_dim), a softmax, the output projection. Layer norms
are flax's (eps 1e-5, float32 statistics). `video_params_from_flax` bridges
a JAX tree into those keys.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.models.layers import LayerNorm, Linear
from lr2ppo_torch.ops.hash_dropout import module_dropout


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Self-attention under nn.MultiheadAttention's keys, batch-major."""

    def __init__(self, d: int, heads: int, dtype=None, device=None):
        super().__init__()
        self.d, self.heads, self.dtype = d, heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d, device=device))
        self.out_proj = Linear(d, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dt = self.dtype or x.dtype
        qkv = torch.matmul(x.to(dt), self.in_proj_weight.to(dt).t()) \
            + self.in_proj_bias.to(dt)
        q, k, v = (t.reshape(b, s, self.heads, d // self.heads)
                   .transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        q = q / math.sqrt(d // self.heads)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(out)


class _Mlp(nn.Module):
    def __init__(self, d: int, dtype=None, device=None):
        super().__init__()
        self.c_fc = Linear(d, 4 * d, dtype=dtype, device=device)
        self.c_proj = Linear(4 * d, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """CLIP's block: pre-LN attention, then a pre-LN QuickGELU MLP."""

    def __init__(self, d_model: int, n_head: int, dtype=None, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(d_model, device=device)
        self.attn = MultiheadAttention(d_model, n_head, dtype, device)
        self.ln_2 = LayerNorm(d_model, device=device)
        self.mlp = _Mlp(d_model, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Resblocks(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype=None,
                 device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, device)
            for _ in range(layers))


class VideoTransformer(nn.Module):
    """[CLS] + learned positions + blocks + ln_post + projection
    (video_transformer.py:8-42): (B, frames, emb) -> (B, frames + 1,
    output_dim)."""

    def __init__(self, frame_size: int, emb_size: int, layers: int,
                 heads: int, output_dim: int, dtype=None, device=None):
        super().__init__()
        self.emb_size, self.dtype = emb_size, dtype
        self.class_embedding = nn.Parameter(torch.zeros(emb_size,
                                                        device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(frame_size + 1, emb_size, device=device))
        self.proj = nn.Parameter(torch.zeros(emb_size, output_dim,
                                             device=device))
        self.ln_pre = LayerNorm(emb_size, device=device)
        self.transformer = _Resblocks(emb_size, layers, heads, dtype, device)
        self.ln_post = LayerNorm(emb_size, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init styles: the class embedding, positions and proj
        N(0, emb^-1/2); the attention's projections lecun normal with zero
        biases; the MLP's torch's U(+-1/sqrt(fan_in)); norms at one and
        zero."""
        scale = self.emb_size ** -0.5
        for p in (self.class_embedding, self.positional_embedding,
                  self.proj):
            p.normal_(0.0, scale, generator=generator)
        for m in self.modules():
            if isinstance(m, MultiheadAttention):
                m.in_proj_weight.normal_(0.0, m.d ** -0.5,
                                         generator=generator)
                m.in_proj_bias.zero_()
                m.out_proj.weight.normal_(0.0, m.d ** -0.5,
                                          generator=generator)
                m.out_proj.bias.zero_()
            elif isinstance(m, _Mlp):
                m.c_fc.reset_parameters(generator)
                m.c_proj.reset_parameters(generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_post(x)
        return torch.matmul(x, self.proj.to(x.dtype))


class ProjectionLayer(nn.Module):
    """Linear -> exact GELU -> Linear -> dropout -> + the first linear's
    output -> LayerNorm (project_embedding.py:5-26). In training mode
    (`deterministic=False`) the dropout draws its seed from `generator`."""

    def __init__(self, embedding_dim: int, projection_dim: int,
                 dropout: float = 0.2, dtype=None, device=None):
        super().__init__()
        self.dropout = dropout
        self.projection = Linear(embedding_dim, projection_dim, dtype=dtype,
                                 device=device)
        self.fc = Linear(projection_dim, projection_dim, dtype=dtype,
                         device=device)
        self.layer_norm = LayerNorm(projection_dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.projection.reset_parameters(generator)
        self.fc.reset_parameters(generator)
        self.layer_norm.reset_parameters()

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        projected = self.projection(x)
        h = self.fc(F.gelu(projected, approximate="none"))
        h = module_dropout(h, self.dropout, deterministic, generator, False)
        return self.layer_norm(h + projected)


def _np(arr) -> np.ndarray:
    return np.asarray(arr, np.float32)


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, copy=True, order="C"))


def video_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A JAX VideoTransformer or ProjectionLayer param tree (optionally
    under "params") of numpy arrays -> the reference-keyed state dict: dense
    kernels (in, out) to (out, in) weights, layer-norm scales to `weight`,
    the attention's (E, H, Dh) query/key/value kernels and (H, Dh) biases
    packed into `in_proj_weight` / `in_proj_bias`, its (H, Dh, E) output
    kernel to `out_proj.weight`."""
    tree = tree.get("params", tree)
    out = {}

    def dense(prefix, node):
        out[f"{prefix}.weight"] = _t(_np(node["kernel"]).T)
        out[f"{prefix}.bias"] = _t(node["bias"])

    def norm(prefix, node):
        out[f"{prefix}.weight"] = _t(node["scale"])
        out[f"{prefix}.bias"] = _t(node["bias"])

    for name, node in tree.items():
        if name in ("class_embedding", "positional_embedding", "proj"):
            out[name] = _t(node)
        elif name in ("ln_pre", "ln_post", "layer_norm"):
            norm(name, node)
        elif name in ("projection", "fc"):
            dense(name, node)
        elif name.startswith("resblock_"):
            prefix = f"transformer.resblocks.{name[len('resblock_'):]}"
            norm(f"{prefix}.ln_1", node["ln_1"])
            norm(f"{prefix}.ln_2", node["ln_2"])
            dense(f"{prefix}.mlp.c_fc", node["c_fc"])
            dense(f"{prefix}.mlp.c_proj", node["c_proj"])
            attn = node["attn"]
            e = _np(attn["query"]["kernel"]).shape[0]
            out[f"{prefix}.attn.in_proj_weight"] = _t(np.concatenate(
                [_np(attn[p]["kernel"]).reshape(e, -1).T
                 for p in ("query", "key", "value")]))
            out[f"{prefix}.attn.in_proj_bias"] = _t(np.concatenate(
                [_np(attn[p]["bias"]).reshape(-1)
                 for p in ("query", "key", "value")]))
            kernel = _np(attn["out"]["kernel"])
            out[f"{prefix}.attn.out_proj.weight"] = _t(
                kernel.reshape(-1, kernel.shape[-1]).T)
            out[f"{prefix}.attn.out_proj.bias"] = _t(attn["out"]["bias"])
        else:
            raise KeyError(f"flax path {name!r} is not a VideoTransformer "
                           "or ProjectionLayer leaf")
    return out
