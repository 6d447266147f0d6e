"""Pointwise scorer (counterpart of lr2ppo_tpu/models/scorer.py).

`ScoreModel` is the reference Classifier/Actor. Its state_dict keys are the
reference's: `text_proj.*`, `img_proj.*`, `xit.*`, `out_layer.*`, `head.*`,
with no `trunk.` prefix, because the JAX package's `trunk` scope is its own
and the reference has none (lr2ppo_tpu/train/checkpoints.py:148-187).

As in JAX, image embeddings stay (B, I, D): img_proj runs once per item and
its output broadcasts over the tag axis.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lr2ppo_tpu.config import ModelConfig
from lr2ppo_torch.models.layers import Linear, Mlp, XiT, cast, eval_only


class FusionTrunk(nn.Module):
    """text_proj and img_proj MLPs -> XiT cross-attention -> concat with the
    image tokens -> the wide out_layer MLP -> one D-wide feature per tag.

    Multimodal family: text (B, T, S, D) and img (B, I, D). Text and image
    embeddings both come at feat_size wide, as the data loaders emit them."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        if cfg.family != "multimodal":
            raise NotImplementedError(
                f"lr2ppo_torch ports the multimodal family only, not "
                f"{cfg.family!r}")
        self.cfg, self.dtype = cfg, dtype
        d = cfg.feat_size
        hidden = cfg.mlp_ratio * d

        def mlp(fan_in):
            return Mlp(fan_in, hidden, d, cfg.init_style, dtype, cfg.int8,
                       device)

        self.text_proj = mlp(d)
        self.img_proj = mlp(d)
        self.xit = XiT(d, cfg.num_heads, faithful=cfg.faithful_attention,
                       init_style=cfg.init_style, dtype=dtype, int8=cfg.int8,
                       device=device)
        self.out_layer = mlp(cfg.fusion_tokens * d)

    def forward(self, text_emb: torch.Tensor, img_emb: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        eval_only(deterministic)
        b, t = text_emb.shape[:2]
        tfeat = self.text_proj(cast(text_emb, self.dtype))
        ifeat = self.img_proj(cast(img_emb, self.dtype))[:, None]  # (B,1,I,D)
        x = self.xit(tfeat, ifeat)
        ib = ifeat.expand(b, t, *ifeat.shape[2:])
        x = torch.cat([x, ib], dim=2)                   # (B, T, S+I, D)
        return self.out_layer(x.reshape(b, t, -1))       # (B, T, D)


class ScoreModel(FusionTrunk):
    """Per-tag scores: (B, T) in 'reg' mode, (B, T, labels_num) logits in
    'cls' mode (reference ppo.py:196-244)."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(cfg, dtype, device)
        out = 1 if cfg.mode == "reg" else cfg.labels_num
        self.head = Linear(cfg.feat_size, out, cfg.init_style, dtype=dtype,
                           int8=cfg.int8, device=device)

    def forward(self, text_emb: torch.Tensor, img_emb: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        logits = self.head(super().forward(text_emb, img_emb, deterministic))
        return logits[..., 0] if self.cfg.mode == "reg" else logits
