"""Task models (counterpart of lr2ppo_tpu/models/scorer.py): the pointwise
scorer `ScoreModel` (reference Classifier/Actor), the sequence scorer
`SeqScoreModel` (reference Critic/Reward), the `ActorCritic` pair and the
2-data feature-unification scorer `TwoDataScoreModel`, for the multimodal
family (LRMovieNet) and the tabular one (LETOR).

State_dict keys are the reference's: `text_proj.*`, `img_proj.*`, `xit.*`,
`out_layer.*`, `head.*`, and for the sequence scorer `pos_emb.weight` and
`xitt.*`, with no `trunk.` prefix, because the JAX package's `trunk` scope
is its own and the reference has none (lr2ppo_tpu/train/checkpoints.py).

As in JAX, image embeddings stay (B, I, D): img_proj runs once per item and
its output broadcasts over the tag axis. Training (`deterministic=False`)
takes the caller's CPU `torch.Generator`, from which every active dropout
site draws its seed in forward order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lr2ppo_torch.config import ModelConfig
from lr2ppo_torch.models.layers import Linear, Mlp, XiT, cast
from lr2ppo_torch.utils.remat import remat


def _xit(cfg: ModelConfig, dtype, device, causal: bool = False) -> XiT:
    return XiT(cfg.feat_size, cfg.num_heads, causal=causal,
               faithful=cfg.faithful_attention, init_style=cfg.init_style,
               dtype=dtype, int8=cfg.int8, device=device, drop_p=cfg.drop_p,
               forward_drop_p=cfg.forward_drop_p,
               hash_dropout=cfg.hash_dropout, fast_dropout=cfg.fast_dropout,
               pallas_dropout=cfg.pallas_dropout)


class FusionTrunk(nn.Module):
    """Projections -> XiT attention -> concat -> the wide out_layer MLP ->
    one D-wide feature per tag (or document).

    multimodal: text (B, T, S, D) through text_proj, cross-attending img
                (B, I, D) through img_proj (ppo.py:214-227); the XiT output
                is concatenated with the image tokens.
    tabular:    text (B, T, D), one doc vector a token, self-attended
                (ppo_trad.py:157-167); the XiT output is concatenated with
                the token itself. There are no projections: `tokens=` takes
                pre-projected (B, T, 1, D) tokens (the 2-data model's).

    With `cfg.remat`, a trunk pass that records gradients runs under
    utils/remat.py: its activations are recomputed in the backward with the
    dropout seeds of the forward (the JAX package's nn.remat of the
    trunk)."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        if cfg.family not in ("multimodal", "tabular"):
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg, self.dtype = cfg, dtype
        d = cfg.feat_size
        hidden = cfg.mlp_ratio * d

        def mlp(fan_in):
            return Mlp(fan_in, hidden, d, cfg.init_style, dtype, cfg.int8,
                       device)

        if cfg.family == "multimodal":
            self.text_proj = mlp(d)
            self.img_proj = mlp(d)
        self.xit = _xit(cfg, dtype, device)
        self.out_layer = mlp(cfg.fusion_tokens * d)

    def trunk(self, text_emb: Optional[torch.Tensor],
              img_emb: Optional[torch.Tensor] = None,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cfg.remat and torch.is_grad_enabled():
            return remat(self._trunk, text_emb, img_emb, deterministic,
                         tokens, generator=generator)
        return self._trunk(text_emb, img_emb, deterministic, tokens,
                           generator)

    def _trunk(self, text_emb: Optional[torch.Tensor],
               img_emb: Optional[torch.Tensor], deterministic: bool,
               tokens: Optional[torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.cfg.family == "tabular":
            if tokens is None:
                tokens = cast(text_emb, self.dtype)[:, :, None, :]
            b, t = tokens.shape[:2]
            x = self.xit(tokens, tokens, deterministic, generator)
            x = torch.cat([x, tokens], dim=2)               # (B, T, 2, D)
            return self.out_layer(x.reshape(b, t, -1), deterministic,
                                  generator)                # (B, T, D)
        b, t = text_emb.shape[:2]
        tfeat = self.text_proj(cast(text_emb, self.dtype), deterministic,
                               generator)
        ifeat = self.img_proj(cast(img_emb, self.dtype), deterministic,
                              generator)[:, None]           # (B, 1, I, D)
        x = self.xit(tfeat, ifeat, deterministic, generator)
        ib = ifeat.expand(b, t, *ifeat.shape[2:])
        x = torch.cat([x, ib], dim=2)                       # (B, T, S+I, D)
        return self.out_layer(x.reshape(b, t, -1), deterministic,
                              generator)                    # (B, T, D)

    forward = trunk


class ScoreModel(FusionTrunk):
    """Per-tag scores: (B, T) in 'reg' mode, (B, T, labels_num) logits in
    'cls' mode (reference ppo.py:196-244)."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(cfg, dtype, device)
        out = 1 if cfg.mode == "reg" else cfg.labels_num
        self.head = Linear(cfg.feat_size, out, cfg.init_style, dtype=dtype,
                           int8=cfg.int8, device=device)

    def forward(self, text_emb: torch.Tensor,
                img_emb: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        logits = self.head(self.trunk(text_emb, img_emb, deterministic,
                                      generator))
        return logits[..., 0] if self.cfg.mode == "reg" else logits


class SeqScoreModel(FusionTrunk):
    """Sequence scorer (reference Critic/Reward, ppo.py:247-350): the trunk
    runs on the T distinct tags, and the (B, T, D) features are gathered by
    `index` (B, K), so duplicated positions share dropout masks, as in JAX
    (scorer.py:142-148). Learned position embeddings are added, the causal
    XiT `xitt` runs over the K positions (in faithful mode the causal mask
    is the reference's no-op), and the last position's scalar is returned,
    (B,)."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(cfg, dtype, device)
        self.pos_emb = nn.Embedding(cfg.num_pos, cfg.feat_size, device=device)
        self.xitt = _xit(cfg, dtype, device, causal=True)
        self.head = Linear(cfg.feat_size, 1, cfg.init_style, dtype=dtype,
                           int8=cfg.int8, device=device)

    def forward(self, text_emb: torch.Tensor,
                img_emb: Optional[torch.Tensor],
                index: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.trunk(text_emb, img_emb, deterministic, generator)
        idx = index.long()[..., None].expand(*index.shape, x.shape[-1])
        x = torch.gather(x, 1, idx)                          # (B, K, D)
        k = x.shape[1]
        x = x + self.pos_emb.weight[:k].to(x.dtype)[None]
        x = self.xitt(x, x, deterministic, generator)
        return self.head(x)[:, -1, 0]


class TwoDataScoreModel(FusionTrunk):
    """The feature-unification scorer of the tabular family
    (pointwise_2data_trad.py:130-176): one projection MLP per raw feature
    dim of `cfg.trad_dims`, under the reference's names (`text_proj` for
    the first, `text_proj3` for the second, MQ2008's 46 and Web10K's 136);
    the input's last dim picks the projection, whose (B, T, 1, D) token runs
    the tabular trunk and the head. `project` is the projection alone, for
    the tsv exporter (pointwise_2data_infer_trad.py:428-446)."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(cfg, dtype, device)
        d = cfg.feat_size
        for dim in cfg.trad_dims:
            self.add_module(self.proj_name(dim), Mlp(
                dim, cfg.mlp_ratio * d, d, cfg.init_style, dtype, cfg.int8,
                device))
        out = 1 if cfg.mode == "reg" else cfg.labels_num
        self.head = Linear(d, out, cfg.init_style, dtype=dtype,
                           int8=cfg.int8, device=device)

    def proj_name(self, dim: int) -> str:
        i = list(self.cfg.trad_dims).index(dim)
        return "text_proj" if i == 0 else f"text_proj{i + 2}"

    def project(self, text_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """raw (..., dim) -> unified (..., D) features."""
        proj = getattr(self, self.proj_name(text_emb.shape[-1]))
        return proj(cast(text_emb, self.dtype), deterministic, generator)

    def forward(self, text_emb: torch.Tensor,
                img_emb: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens = self.project(text_emb[:, :, None, :], deterministic,
                              generator)
        logits = self.head(self.trunk(None, None, deterministic, generator,
                                      tokens=tokens))
        return logits[..., 0] if self.cfg.mode == "reg" else logits


class ActorCritic(nn.Module):
    """The actor (ScoreModel) and critic (SeqScoreModel) under the
    reference's `actor.`/`critic.` prefixes (ppo_eval.py:336-343), so a
    saved best checkpoint loads with `load_state_dict(strict=True)`."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.actor = ScoreModel(cfg, dtype, device)
        self.critic = SeqScoreModel(cfg, dtype, device)
