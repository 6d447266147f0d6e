"""Tower model: embedding -> encoder [-> decoder], with the reference JSON
config schema (counterpart of lr2ppo_tpu/towers/model.py).

`TowerConfig` is the port's copy of the JAX package's, field for field, so
`from_json` reads the reference config files (models/vit/
base-16-224_config.json, models/xlm-roberta/base_config.json,
models/t5/base_config.json) and ignores keys it has no field for.
`TowerModel.encode` is the feature-extraction path; built `with_target`, the
model's forward is the pretraining loss through the targets (targets.py).
A config with a `decoder` adds the target-side embedding and the
TransformerDecoder (decoders/transformer_decoder.py), and its targets read
the decoder's output. A `dual` config (CLIP-style) has one embedding a
stream, `embedding_0` and `embedding_1`, each built from the config
overlaid with its stream dict, and the DualEncoder; `encode` then takes and
returns pairs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.ops.hash_dropout import module_dropout
from lr2ppo_torch.towers.embeddings import (CompositeEmbedding,
                                            MaskedPatchEmbedding,
                                            PatchEmbedding, SpeechEmbedding)
from lr2ppo_torch.towers.encoders import (GatedcnnEncoder, RnnWeights,
                                          build_encoder, stream_config)
from lr2ppo_torch.towers.latent import LatentEncoder
from lr2ppo_torch.towers.layers import (GatedFeedForward,
                                        MultiHeadedAttention,
                                        PositionwiseFeedForward, RefLayerNorm,
                                        RelativePositionEmbedding,
                                        T5LayerNorm, additive_mask_from_seg,
                                        make_layer_norm)
from lr2ppo_torch.towers.moe import MoeFeedForward
from lr2ppo_torch.towers.targets import ClrTarget, CompositeTarget
from lr2ppo_torch.utils import span


@dataclass
class TowerConfig:
    """Reference args namespace, defaulted per tencentpretrain/opts.py."""

    emb_size: int = 768
    hidden_size: int = 768
    feedforward_size: int = 3072
    heads_num: int = 12
    layers_num: int = 12
    decoder_layers_num: Optional[int] = None
    max_seq_length: int = 512
    max_audio_frames: int = 6000
    dropout: float = 0.1
    hash_dropout: bool = False
    hidden_act: str = "gelu"
    vocab_size: int = 250002          # XLM-R default
    embedding: List[str] = field(
        default_factory=lambda: ["word", "pos", "seg"])
    encoder: str = "transformer"
    decoder: Optional[str] = None
    tgt_embedding: Optional[List[str]] = None
    gate_embedding: Optional[List[str]] = None
    target: List[str] = field(default_factory=lambda: ["mlm"])
    mask: str = "fully_visible"
    layernorm_positioning: str = "post"
    layernorm: str = "normal"
    feed_forward: str = "dense"
    pooling: str = "first"
    labels_num: int = 2
    attention_head_size: Optional[int] = None
    remove_transformer_bias: bool = False
    remove_attention_scale: bool = False
    remove_embedding_layernorm: bool = False
    factorized_embedding_parameterization: bool = False
    parameter_sharing: bool = False
    relative_position_embedding: bool = False
    relative_attention_buckets_num: int = 32
    has_residual_attention: bool = False
    has_lmtarget_bias: bool = False
    label_smoothing: Optional[float] = None
    bidirectional: bool = False
    kernel_size: int = 3
    block_size: int = 2
    # vision
    image_height: int = 224
    image_width: int = 224
    patch_size: int = 16
    channels_num: int = 3
    # dual/clr
    stream_0: Dict[str, Any] = field(default_factory=dict)
    stream_1: Dict[str, Any] = field(default_factory=dict)
    tie_weights: bool = False
    projection: bool = False
    feature_size: int = 512
    remat: bool = False
    # attention through the fused kernel on deterministic fully-visible
    # passes (ops/attention.py): the feature-extraction path
    pallas_attention: bool = False
    seq_parallel: bool = False

    @classmethod
    def from_json(cls, path: str, **overrides) -> "TowerConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict({**raw, **overrides})

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "TowerConfig":
        if cls is TowerConfig and "kv_lora_rank" in raw:
            return LatentMoeConfig.from_dict(raw)
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in names}
        for key in ("embedding", "tgt_embedding", "target"):
            if isinstance(kw.get(key), str):
                kw[key] = [kw[key]]
        cfg = cls(**kw)
        if cfg.encoder.startswith("bi"):
            cfg = dataclasses.replace(cfg, bidirectional=True)
        return cfg


# published keys of the DeepSeek-V3 config that repeat a TowerConfig field
_SAME_AS = {"num_hidden_layers": "layers_num",
            "num_attention_heads": "heads_num",
            "intermediate_size": "feedforward_size"}
# the published config's choices that LatentMoeConfig runs, and no other
_ONLY = {"q_lora_rank": None, "scoring_func": "sigmoid",
         "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
         "num_nextn_predict_layers": 0, "attention_bias": False,
         "tie_word_embeddings": False, "hidden_act": "silu",
         "encoder": "transformer", "decoder": None}


@dataclass
class LatentMoeConfig(TowerConfig):
    """TowerConfig with the DeepSeek-V3 block's keys (Moonlight-16B-A3B;
    towers/latent.py), under the published config.json's names, plus what
    that file does not state: the router's width where this card holds only
    some of a layer's experts (`router_experts`; None: n_routed_experts),
    the first expert it holds (`first_held_expert`), the sequence-wise
    balance loss's alpha (`aux_loss_alpha`) and the correction bias's speed
    gamma (`bias_update_speed`). `n_routed_experts` counts the experts held
    here, ids first_held_expert.. on: one rank's share of an
    expert-parallel layer, or the whole layer. TowerConfig keeps the JAX
    package's fields:
    `TowerConfig.from_dict` hands a dict holding `kv_lora_rank` here. A
    published key that repeats a field (num_hidden_layers,
    num_attention_heads, intermediate_size) sets the field where the field
    is not given."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_intermediate_size: int = 1408
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    router_experts: Optional[int] = None
    first_held_expert: int = 0
    aux_loss_alpha: float = 1e-4
    bias_update_speed: float = 1e-3

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "LatentMoeConfig":
        raw = dict(raw)
        for key, want in _ONLY.items():
            if key in raw and raw[key] != want:
                raise ValueError(f"{key}={raw[key]!r}: the latent MoE tower "
                                 f"runs {key}={want!r} only")
        for pub, name in _SAME_AS.items():
            if pub in raw:
                raw.setdefault(name, raw[pub])
        cfg = super().from_dict(raw)
        if cfg.first_held_expert + cfg.n_routed_experts > cfg.n_router:
            raise ValueError(
                f"experts {cfg.first_held_expert}.."
                f"{cfg.first_held_expert + cfg.n_routed_experts - 1} held, "
                f"the router has {cfg.n_router}")
        return cfg

    @property
    def n_router(self) -> int:
        """The router's outputs: every expert of the layer."""
        return self.router_experts or self.n_routed_experts

    def held(self) -> List[int]:
        """The ids of the experts held here."""
        return list(range(self.first_held_expert,
                          self.first_held_expert + self.n_routed_experts))


class TransformerDecoderLayer(nn.Module):
    """One decoder layer (transformer_decoder.py): causal self-attention,
    attention over the encoder's memory, the FFN, and three norms
    (`layer_norm_{1,2,3}`), pre- or post-LN. In training mode it has five
    dropout sites, in the order their seeds are drawn: the self-attention
    probabilities, its branch, the context-attention probabilities, its
    branch and the FFN branch. Pre-LN context attention reads the un-normed
    memory as key and value (lr2ppo_tpu/towers/model.py:207)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        dh = cfg.attention_head_size or cfg.hidden_size // cfg.heads_num
        has_bias = not cfg.remove_transformer_bias
        self.pre = cfg.layernorm_positioning == "pre"
        self.dropout, self.hash_dropout = cfg.dropout, cfg.hash_dropout

        def attention():
            return MultiHeadedAttention(
                cfg.hidden_size, cfg.heads_num, dh, has_bias,
                not cfg.remove_attention_scale, dtype, device, cfg.dropout,
                cfg.hash_dropout)

        self.self_attn = attention()
        self.context_attn = attention()
        ffn_cls = (GatedFeedForward if cfg.feed_forward == "gated"
                   else PositionwiseFeedForward)
        self.feed_forward = ffn_cls(cfg.hidden_size, cfg.feedforward_size,
                                    cfg.hidden_act, has_bias, dtype, device)
        for i in (1, 2, 3):
            self.add_module(f"layer_norm_{i}", make_layer_norm(
                cfg.layernorm, cfg.hidden_size, dtype, device))

    def forward(self, hidden: torch.Tensor, memory: torch.Tensor,
                mask_dec: torch.Tensor, mask_enc: torch.Tensor,
                position_bias: Optional[torch.Tensor], deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        def drop(x):
            return module_dropout(x, self.dropout, deterministic, generator,
                                  self.hash_dropout)

        def attend(attn, kv, query, mask, bias=None):
            return attn(kv, kv, query, mask, bias, None, None, deterministic,
                        generator)[0]

        if self.pre:
            normed = self.layer_norm_1(hidden)
            query = drop(attend(self.self_attn, normed, normed, mask_dec,
                                position_bias)) + hidden
            mid = drop(attend(self.context_attn, memory,
                              self.layer_norm_2(query), mask_enc)) + query
            return drop(self.feed_forward(self.layer_norm_3(mid))) + mid
        query = self.layer_norm_1(drop(attend(
            self.self_attn, hidden, hidden, mask_dec, position_bias)) + hidden)
        mid = self.layer_norm_2(drop(attend(
            self.context_attn, memory, query, mask_enc)) + query)
        return self.layer_norm_3(drop(self.feed_forward(mid)) + mid)


class TransformerDecoder(nn.Module):
    """The autoregressive decoder stack (decoders/transformer_decoder.py),
    under `decoder.transformer_decoder.<i>`, with T5's one-way relative
    bias `decoder.self_pos_emb` and the final norm `decoder.layer_norm` of
    pre-LN stacks. The causal mask ignores the target's padding; the
    context mask hides the source's."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.transformer_decoder = nn.ModuleList(
            TransformerDecoderLayer(cfg, dtype, device)
            for _ in range(cfg.decoder_layers_num or cfg.layers_num))
        if cfg.relative_position_embedding:
            self.self_pos_emb = RelativePositionEmbedding(
                cfg.heads_num, bidirectional=False,
                num_buckets=cfg.relative_attention_buckets_num,
                device=device)
        if cfg.layernorm_positioning == "pre":
            self.layer_norm = make_layer_norm(cfg.layernorm, cfg.hidden_size,
                                              dtype, device)

    def forward(self, memory: torch.Tensor, emb: torch.Tensor,
                src_seg: torch.Tensor, tgt_seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t = tgt_seg.shape
        mask_dec = additive_mask_from_seg(tgt_seg, "causal")
        vis = (src_seg > 0)[:, None, None, :].expand(b, 1, t,
                                                     src_seg.shape[1])
        zero = torch.zeros((), device=src_seg.device)
        mask_enc = torch.where(vis, zero, zero - 10000.0)
        position_bias = None
        if self.cfg.relative_position_embedding:
            position_bias = self.self_pos_emb(
                t, t, self.transformer_decoder[0].self_attn.heads_mesh)
        hidden = emb
        for layer in self.transformer_decoder:
            hidden = layer(hidden, memory, mask_dec, mask_enc, position_bias,
                           deterministic, generator)
        if self.cfg.layernorm_positioning == "pre":
            hidden = self.layer_norm(hidden)
        return hidden


class TowerModel(nn.Module):
    """Embedding -> encoder [-> decoder] [-> target] (models/model.py), under
    the reference keys `embedding.*`, `encoder.*`, with a decoder
    `tgt_embedding.*` and `decoder.*`, and, built `with_target`,
    `target.<kind>.*`. `encode` gives the encoder's last hidden states, the
    features clean_feat.h5 stores; a tower for extraction is built without
    the target, as a reference checkpoint's heads are dropped by
    `encoder_state`. The target-side embedding is its own module (no tied
    weights, as in JAX), built from the config with `tgt_embedding` as its
    kinds and the encoder side's list as its gates. A dual tower has
    `embedding_0.*` and `embedding_1.*` instead of `embedding.*`. In
    training mode (`deterministic=False`) every dropout site draws its seed
    from `generator`, a CPU torch.Generator, in forward order: the encoder
    side (a dual tower's two embeddings, then its two encoders, JAX's
    order), then the target embedding and the decoder."""

    def __init__(self, cfg: TowerConfig, dtype: Optional[torch.dtype] = None,
                 device=None, with_target: bool = False):
        super().__init__()
        self.cfg = cfg
        if cfg.encoder == "dual":
            self.embedding_0 = CompositeEmbedding(
                stream_config(cfg, cfg.stream_0), device)
            self.embedding_1 = CompositeEmbedding(
                stream_config(cfg, cfg.stream_1), device)
        else:
            self.embedding = CompositeEmbedding(cfg, device)
        self.encoder = (LatentEncoder(cfg, dtype, device)
                        if isinstance(cfg, LatentMoeConfig)
                        else build_encoder(cfg, dtype, device))
        if cfg.decoder:
            tgt_cfg = (dataclasses.replace(cfg, embedding=cfg.tgt_embedding,
                                           gate_embedding=cfg.embedding)
                       if cfg.tgt_embedding else cfg)
            self.tgt_embedding = CompositeEmbedding(tgt_cfg, device)
            self.decoder = TransformerDecoder(cfg, dtype, device)
        if with_target:
            self.target = CompositeTarget(cfg, dtype, device)

    def encode(self, src, seg, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        """The encoder's last hidden states; a dual tower takes and returns
        (stream 0, stream 1) pairs. A single stream's `src` is a tensor, or
        a (tokens, pixels) pair under word_patch and a (pixels, mask) pair
        under masked_patch; under speech `seg` spans the subsampled
        frames."""
        if self.cfg.encoder == "dual":
            emb = (self.embedding_0(src[0], seg[0], deterministic, generator),
                   self.embedding_1(src[1], seg[1], deterministic, generator))
        else:
            emb = self.embedding(src, seg, deterministic, generator)
        return self.encoder(emb, seg, deterministic, generator)

    def embed_only(self, src, seg: torch.Tensor, deterministic: bool = True,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """The embedding's output without the encoder (the JAX package's
        companion of a pipelined encoder stack)."""
        return self.embedding(src, seg, deterministic, generator)

    def target_only(self, memory: torch.Tensor, tgt, seg: torch.Tensor):
        """The target over a precomputed encoder output."""
        return self.target(memory, tgt, seg)

    def forward(self, src, tgt, seg: torch.Tensor, tgt_in=None,
                tgt_seg: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """The target's loss tuple: (loss, correct, denom) for mlm, lm,
        bilm and clr, (loss, correct) for cls and sp, {kind: tuple} for
        several.
        With a decoder, `tgt_in` and `tgt_seg` are the decoder's input
        stream, and the target reads the decoder's output under tgt_seg."""
        if not hasattr(self, "target"):
            raise ValueError("this TowerModel was built without its target "
                             "(with_target=False); call encode()")
        memory = self.encode(src, seg, deterministic, generator)
        if self.cfg.decoder:
            emb = self.tgt_embedding(tgt_in, tgt_seg, deterministic,
                                     generator)
            memory = self.decoder(memory, emb, seg, tgt_seg, deterministic,
                                  generator)
            seg = tgt_seg
        out = self.target(memory, tgt, seg)
        balance = getattr(self.encoder, "balance_loss", None)
        if balance is not None:
            out = (out[0] + balance, *out[1:])
        return out

    def after_update(self) -> None:
        """After each optimizer step: the MoE layers' correction biases
        move by the load counted since the last step (towers/moe.py); no
        other tower has anything to do."""
        moe = getattr(self, "_moe", None)
        if moe is None:
            moe = self._moe = [m for m in self.modules()
                               if isinstance(m, MoeFeedForward)]
        if moe:
            with span("moe.bias_update"):
                for m in moe:
                    m.update_bias()


def build_model(cfg: TowerConfig, dtype=None, device=None) -> TowerModel:
    return TowerModel(cfg, dtype, device)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights with the JAX package's init styles: linears as torch
    (U(+-1/sqrt(fan_in))), lookup tables (T5's relative bias tables among
    them) N(0, 1), the patch projection and [CLS] N(0, 0.02), layer norms
    at one and zero, recurrent weights and biases U(+-1/sqrt(hs)), gated-CNN
    kernels N(0, 0.02) and their biases N(0, 1), the contrastive
    projections N(0, 1) and its logit scale ln(1 / 0.07), BEiT's mask
    embedding and the speech convolutions N(0, 0.02) with zero biases."""
    for m in model.modules():
        if isinstance(m, (Linear, RefLayerNorm, T5LayerNorm, RnnWeights,
                          GatedcnnEncoder, ClrTarget)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, PatchEmbedding):
            m.projection.weight.normal_(0.0, 0.02, generator=generator)
            m.cls_emb.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, MaskedPatchEmbedding):
            m.mask_emb.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, SpeechEmbedding):
            for i in range(m.n_layers):
                conv = getattr(m, f"conv_{i}")
                conv.weight.normal_(0.0, 0.02, generator=generator)
                conv.bias.zero_()
