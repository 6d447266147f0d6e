"""The layer of the DeepSeek-V3 block as a tower (Moonlight-16B-A3B),
configured by towers/model.py:LatentMoeConfig.

`LatentLayer` is one pre-norm layer: RMSNorm, MLA (towers/mla.py), the
residual, RMSNorm, then the dense SwiGLU for the first
`first_k_dense_replace` layers and the MoE feed-forward (towers/moe.py)
after, the residual. Its norms take `rms_norm_eps`, and AdamW does not
decay them (`no_decay`). `LatentEncoder`, the tower's encoder for a
LatentMoeConfig (towers/model.py:TowerModel), builds its layers by kind
from `layer_kinds`, each causal through the attention kernel's own mask (no
mask tensor is built), ends in the final RMSNorm and adds the layers'
balance losses of a training pass in `balance_loss`, which the tower adds
to its target's loss. Its keys are TransformerEncoder's
(`transformer.<i>`, `layer_norm`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from lr2ppo_torch.towers.layers import T5LayerNorm
from lr2ppo_torch.towers.mla import LatentAttention
from lr2ppo_torch.towers.moe import MoeFeedForward, SwiGLU
from lr2ppo_torch.utils.remat import remat


def layer_kinds(cfg) -> List[str]:
    """Each layer's feed-forward: "dense" or "moe"."""
    return ["dense" if i < cfg.first_k_dense_replace else "moe"
            for i in range(cfg.layers_num)]


def norm(cfg, d: int, dtype=None, device=None) -> T5LayerNorm:
    """An RMSNorm of the block: the config's eps, not decayed by AdamW."""
    n = T5LayerNorm(d, cfg.rms_norm_eps, dtype=dtype, device=device)
    n.no_decay = True
    return n


class LatentLayer(nn.Module):
    """One pre-norm layer of kind "dense" or "moe"; forward(hidden,
    deterministic, generator) -> (hidden, balance loss or None)."""

    def __init__(self, cfg, kind: str, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        d = cfg.hidden_size
        self.input_layernorm = norm(cfg, d, dtype, device)
        self.self_attn = LatentAttention(cfg, dtype, device)
        self.post_attention_layernorm = norm(cfg, d, dtype, device)
        self.mlp = (SwiGLU(d, cfg.feedforward_size, dtype, device)
                    if kind == "dense" else MoeFeedForward(cfg, dtype, device))

    def forward(self, hidden: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden))
        x = self.post_attention_layernorm(hidden)
        if isinstance(self.mlp, MoeFeedForward):
            y, aux = self.mlp(x, deterministic)
        else:
            y, aux = self.mlp(x), None
        return hidden + y, aux


class LatentEncoder(nn.Module):
    """The layers of the latent MoE tower and its final norm; with `remat`,
    each layer of a pass that records gradients is recomputed in the
    backward (utils/remat.py)."""

    # the MoE layers' balance loss of the last training pass
    balance_loss = None

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.transformer = nn.ModuleList(
            LatentLayer(cfg, kind, dtype, device)
            for kind in layer_kinds(cfg))
        self.layer_norm = norm(cfg, cfg.hidden_size, dtype, device)

    def forward(self, emb: torch.Tensor, seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        recompute = self.cfg.remat and torch.is_grad_enabled()
        hidden, balance = emb, None
        for blk in self.transformer:
            hidden, aux = (remat(blk, hidden, deterministic,
                                 generator=generator)
                           if recompute else blk(hidden, deterministic,
                                                 generator))
            if aux is not None:
                balance = aux if balance is None else balance + aux
        self.balance_loss = balance
        return self.layer_norm(hidden)
