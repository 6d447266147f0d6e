"""Tower embeddings (counterpart of lr2ppo_tpu/towers/embeddings.py): word,
pos, seg, sinusoidal positions and the ViT patch embedding, summed, then an
optional RefLayerNorm (embedding.py:19-34).

The patch projection keeps the reference Conv2d's key and shape,
`embedding.patch.projection.weight` (E, C, P, P) without a bias, but is
computed as the JAX package computes it: the image is cut into patches by a
reshape and a transpose to (c, ph, pw) order, then one matmul. (A float32
convolution would also run through cuDNN in TF32 unless that is turned off.)

The sinusoidal table is a constant, computed once on the host in float32 by
the reference's own torch recipe (sinusoidalpos_embedding.py:26-44) and
copied to each device it is read on; JAX's float32 exp, sin and cos round
some entries differently (within one ulp of the largest angle). The
constructors' gates read the global embedding list (`gate_embedding`, which
TowerModel threads into the decoder side's config), as in JAX.

The other kinds (word_patch, masked_patch, speech) raise (ROADMAP A5: image
and speech pretraining).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from lr2ppo_torch.ops.hash_dropout import module_dropout
from lr2ppo_torch.towers.layers import NOT_PORTED, RefLayerNorm


class _Table(nn.Module):
    """A lookup table under the key `embedding.weight`, N(0, 1) at init."""

    def __init__(self, rows: int, emb_size: int, device=None):
        super().__init__()
        self.embedding = nn.Embedding(rows, emb_size, device=device)


class WordEmbedding(_Table):
    """Token lookup, times sqrt(emb_size) under sinusoidal positions
    (word_embedding.py)."""

    def __init__(self, vocab_size: int, emb_size: int,
                 sinusoidalpos: bool = False, device=None):
        super().__init__(vocab_size, emb_size, device)
        self.scale = math.sqrt(emb_size) if sinusoidalpos else None

    def forward(self, src: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        emb = self.embedding.weight[src]
        return emb if self.scale is None else emb * self.scale


class PosEmbedding(_Table):
    """Learned absolute positions 0..S-1, no padding offset
    (pos_embedding.py)."""

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        b, s = seg.shape
        return self.embedding.weight[:s][None].expand(b, s, -1)


class SegEmbedding(_Table):
    """Three-way segment lookup (seg_embedding.py)."""

    def __init__(self, emb_size: int, device=None):
        super().__init__(3, emb_size, device)

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        return self.embedding.weight[seg]


def sinusoid_table(rows: int, emb_size: int,
                   interleaved: bool = True) -> torch.Tensor:
    """(rows, emb_size) float32 sin/cos table on the host: interleaved sin
    and cos channels, or [sin || cos] (the speech layout); an odd width ends
    in a zero column."""
    half = emb_size // 2
    value = math.log(10000.0) / (half - 1)
    half_exp = torch.exp(torch.arange(half, dtype=torch.float32) * -value)
    half_mat = (torch.arange(rows, dtype=torch.float32)[:, None]
                * half_exp[None, :])
    if interleaved:
        emb = torch.stack([torch.sin(half_mat), torch.cos(half_mat)],
                          dim=-1).reshape(rows, 2 * half)
    else:
        emb = torch.cat([torch.sin(half_mat), torch.cos(half_mat)], dim=1)
    if emb_size % 2:
        emb = torch.cat([emb, torch.zeros(rows, 1)], dim=1)
    return emb


class SinusoidalposEmbedding(nn.Module):
    """Fixed sin/cos positions (sinusoidalpos_embedding.py:26-68): token i
    reads row i + 2 of a max_seq_length + 2 row table, zero past the first
    seg.sum(-1) tokens (the reference's no_pad count, which counts a
    segment-2 token twice). No parameters."""

    def __init__(self, max_seq_length: int, emb_size: int,
                 interleaved: bool = True):
        super().__init__()
        self.table = sinusoid_table(max_seq_length + 2, emb_size,
                                    interleaved)
        self._on = {}

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        table = self._on.get(seg.device)
        if table is None:
            table = self._on[seg.device] = self.table.to(seg.device)
        s = seg.shape[1]
        no_pad = seg.sum(-1)
        pos = torch.arange(s, device=seg.device)[None, :]
        keep = (pos < no_pad[:, None])[..., None]
        return torch.where(keep, table[2:s + 2][None], 0.0)


class PatchEmbedding(nn.Module):
    """ViT patchify: (B, C, H, W) -> [CLS] ++ patch tokens
    (patch_embedding.py:5-31), as reshape + matmul. `projection` is an
    nn.Conv2d only for its key and layout; forward never convolves."""

    def __init__(self, emb_size: int, image_height: int = 224,
                 image_width: int = 224, patch_size: int = 16,
                 channels_num: int = 3, device=None):
        super().__init__()
        self.image_height, self.image_width = image_height, image_width
        self.patch_size, self.channels_num = patch_size, channels_num
        self.projection = nn.Conv2d(channels_num, emb_size, patch_size,
                                    stride=patch_size, bias=False,
                                    device=device)
        self.cls_emb = nn.Parameter(torch.zeros(1, 1, emb_size,
                                                device=device))

    def forward(self, src: torch.Tensor, seg) -> torch.Tensor:
        p, c = self.patch_size, self.channels_num
        b, _, h, w = src.shape
        if (h, w) != (self.image_height, self.image_width):
            raise ValueError(f"input {h}x{w} != model "
                             f"{self.image_height}x{self.image_width}")
        gh, gw = h // p, w // p
        x = src.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, gh * gw, c * p * p)
        weight = self.projection.weight
        kernel = weight.reshape(weight.shape[0], -1).t().to(x.dtype)
        tokens = torch.matmul(x, kernel)
        cls_tok = self.cls_emb.to(x.dtype).expand(b, 1, -1)
        return torch.cat([cls_tok, tokens], dim=1)


def _gates(cfg) -> Sequence[str]:
    """The embedding list the constructors' gates read: the global one
    (`gate_embedding`, set on the decoder side's config), else the side's
    own."""
    return cfg.gate_embedding or cfg.embedding


def _pos_rows(cfg) -> int:
    """Position tables' rows: speech configs count audio frames too."""
    if "speech" in _gates(cfg):
        return max(cfg.max_seq_length, cfg.max_audio_frames)
    return cfg.max_seq_length


_EMB_KINDS = {
    "word": lambda cfg, device: WordEmbedding(
        cfg.vocab_size, cfg.emb_size, "sinusoidalpos" in _gates(cfg),
        device),
    "pos": lambda cfg, device: PosEmbedding(_pos_rows(cfg), cfg.emb_size,
                                            device),
    "seg": lambda cfg, device: SegEmbedding(cfg.emb_size, device),
    "sinusoidalpos": lambda cfg, device: SinusoidalposEmbedding(
        _pos_rows(cfg), cfg.emb_size,
        interleaved="speech" not in _gates(cfg)),
    "patch": lambda cfg, device: PatchEmbedding(
        cfg.emb_size, cfg.image_height, cfg.image_width, cfg.patch_size,
        cfg.channels_num, device),
}


class CompositeEmbedding(nn.Module):
    """The sum of the configured kinds, each a submodule named by its kind
    (`embedding.word...`, `embedding.patch...`), then `layer_norm` unless
    `remove_embedding_layernorm`, then the dropout site of embedding.py:
    19-34 in training mode (its seed drawn from the caller's generator)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.kinds = list(cfg.embedding)
        self.dropout, self.hash_dropout = cfg.dropout, cfg.hash_dropout
        for kind in self.kinds:
            if kind not in _EMB_KINDS:
                raise NotImplementedError(f"the {kind!r} embedding is "
                                          f"{NOT_PORTED}")
            self.add_module(kind, _EMB_KINDS[kind](cfg, device))
        self.layer_norm: Optional[RefLayerNorm] = (
            None if cfg.remove_embedding_layernorm
            else RefLayerNorm(cfg.emb_size, device=device))

    def forward(self, src, seg: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = None
        for kind in self.kinds:
            cur = getattr(self, kind)(src, seg)
            emb = cur if emb is None else emb + cur
        if self.layer_norm is not None:
            emb = self.layer_norm(emb)
        return module_dropout(emb, self.dropout, deterministic, generator,
                              self.hash_dropout)
