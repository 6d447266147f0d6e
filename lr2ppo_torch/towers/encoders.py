"""The transformer encoder of the towers (counterpart of
lr2ppo_tpu/towers/encoders.py:TransformerEncoder).

Its layers are `encoder.transformer.<i>` (or one shared `encoder.transformer`
under parameter sharing), then `encoder.layer_norm` for pre-LN stacks. With
`relative_position_embedding` (T5) the bidirectional bias table is
`encoder.relative_pos_emb`, computed once a pass and added in every layer;
with `has_residual_attention` each layer's chained scores pass to the next.
On a deterministic fully-visible pass with `pallas_attention` set and
neither of those two, the encoder hands each layer a (B, S) key bias, which
routes attention through the fused kernel (ops/attention.py), as the JAX
gate (encoders.py:84-89) does. The kernel has no backward: a training pass
takes the plain attention.

With `remat`, each layer of a pass that records gradients runs under
utils/remat.py, which recomputes its activations in the backward with the
dropout seeds of the forward (the JAX package's `nn.remat` of the layer).

With `seq_parallel` (--sp) and a tp mesh, the residual stream between the
layers is split along the sequence over tp, the JAX package's
`P('dp', 'tp')` constraint (encoders.py:91-120): the embedding's output is
split (parallel/tp.py:split_seq), every layer computes on its S/tp tokens
(towers/layers.py:TransformerLayer), and the stream is gathered whole again
before the final norm and the target. At tp 1 it does nothing, as in JAX.

The RNN family, the gated CNN and dual encoders raise (ROADMAP A4: the other
encoders).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.parallel.tp import gather_seq_replicated, split_seq
from lr2ppo_torch.towers.layers import (RelativePositionEmbedding,
                                        TransformerLayer,
                                        additive_mask_from_seg,
                                        make_layer_norm)
from lr2ppo_torch.utils.remat import remat


class TransformerEncoder(nn.Module):
    """transformer_encoder.py:7-138 (the BERT/ViT-style stack)."""

    seq_parallel = False
    sp_mesh = None

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.factorized_embedding_parameterization:
            self.linear = Linear(cfg.emb_size, cfg.hidden_size, dtype=dtype,
                                 device=device)
        if cfg.relative_position_embedding:
            self.relative_pos_emb = RelativePositionEmbedding(
                cfg.heads_num, bidirectional=True,
                num_buckets=cfg.relative_attention_buckets_num,
                device=device)

        def layer() -> TransformerLayer:
            return TransformerLayer(
                cfg.hidden_size, cfg.heads_num, cfg.feedforward_size,
                cfg.hidden_act, cfg.layernorm_positioning, cfg.layernorm,
                cfg.feed_forward, cfg.attention_head_size,
                has_bias=not cfg.remove_transformer_bias,
                with_scale=not cfg.remove_attention_scale, dtype=dtype,
                device=device, dropout=cfg.dropout,
                hash_dropout=cfg.hash_dropout)

        self.transformer = (layer() if cfg.parameter_sharing
                            else nn.ModuleList(layer()
                                               for _ in range(cfg.layers_num)))
        if cfg.seq_parallel:
            # the stack and every module inside it read the split stream
            # once shard_tp hands them the tp mesh
            self.seq_parallel = True
            for m in self.transformer.modules():
                if hasattr(type(m), "seq_parallel"):
                    m.seq_parallel = True
        if cfg.layernorm_positioning == "pre":
            self.layer_norm = make_layer_norm(cfg.layernorm, cfg.hidden_size,
                                              dtype, device)

    def forward(self, emb: torch.Tensor, seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.factorized_embedding_parameterization:
            emb = self.linear(emb)
        # the key-only bias that takes the fused attention kernel, on a
        # deterministic pass without position bias or chained scores only
        key_bias = None
        if (cfg.pallas_attention and cfg.mask == "fully_visible"
                and deterministic and not cfg.has_residual_attention
                and not cfg.relative_position_embedding):
            key_bias = torch.where(seg > 0, 0.0, -10000.0)
        # the (B, 1, S, S) mask, where some layer takes the plain path
        mask = (additive_mask_from_seg(seg, cfg.mask)
                if key_bias is None or cfg.remove_attention_scale else None)
        position_bias = None
        if cfg.relative_position_embedding:
            layer = (self.transformer if cfg.parameter_sharing
                     else self.transformer[0])
            position_bias = self.relative_pos_emb(
                emb.shape[1], emb.shape[1], layer.self_attn.heads_mesh)
        recompute = cfg.remat and torch.is_grad_enabled()
        sp = self.sp_mesh
        hidden, prev_attn = (emb if sp is None else split_seq(emb, sp)), None
        for i in range(cfg.layers_num):
            blk = (self.transformer if cfg.parameter_sharing
                   else self.transformer[i])
            args = (hidden, mask, position_bias, prev_attn, key_bias,
                    deterministic)
            hidden, prev_attn = (remat(blk, *args, generator=generator)
                                 if recompute else blk(*args, generator))
            if not cfg.has_residual_attention:
                prev_attn = None
        if sp is not None:
            hidden = gather_seq_replicated(hidden, sp)
        if cfg.layernorm_positioning == "pre":
            hidden = self.layer_norm(hidden)
        return hidden


def build_encoder(cfg, dtype=None, device=None) -> TransformerEncoder:
    if cfg.encoder != "transformer":
        raise NotImplementedError(
            f"the {cfg.encoder!r} encoder is not ported yet (ROADMAP.md A4: "
            "the other encoders)")
    return TransformerEncoder(cfg, dtype, device)
