"""Tower model: embedding -> encoder, with the reference JSON config schema
(counterpart of lr2ppo_tpu/towers/model.py).

`TowerConfig` is the port's copy of the JAX package's, field for field, so
`from_json` reads the reference config files (models/vit/
base-16-224_config.json, models/xlm-roberta/base_config.json) and ignores
keys it has no field for. `TowerModel.encode` is the feature-extraction
path; built `with_target`, the model's forward is the pretraining loss
through the targets (targets.py). The decoder and dual encoders raise
(ROADMAP A: the rest of the towers).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.towers.embeddings import CompositeEmbedding, PatchEmbedding
from lr2ppo_torch.towers.encoders import build_encoder
from lr2ppo_torch.towers.layers import NOT_PORTED, RefLayerNorm, T5LayerNorm
from lr2ppo_torch.towers.targets import CompositeTarget


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
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in names}
        for key in ("embedding", "tgt_embedding", "target"):
            if isinstance(kw.get(key), str):
                kw[key] = [kw[key]]
        cfg = cls(**kw)
        if cfg.encoder.startswith("bi"):
            cfg = dataclasses.replace(cfg, bidirectional=True)
        return cfg


class TowerModel(nn.Module):
    """Embedding -> encoder [-> target] (models/model.py), under the
    reference keys `embedding.*`, `encoder.*` and, built `with_target`,
    `target.<kind>.*`. `encode` gives the encoder's last hidden states, the
    features clean_feat.h5 stores; a tower for extraction is built without
    the target, as a reference checkpoint's heads are dropped by
    `encoder_state`. In training mode (`deterministic=False`) every dropout
    site draws its seed from `generator`, a CPU torch.Generator."""

    def __init__(self, cfg: TowerConfig, dtype: Optional[torch.dtype] = None,
                 device=None, with_target: bool = False):
        super().__init__()
        if cfg.encoder == "dual" or cfg.decoder:
            raise NotImplementedError(
                f"dual encoders and decoders are {NOT_PORTED}")
        self.cfg = cfg
        self.embedding = CompositeEmbedding(cfg, device)
        self.encoder = build_encoder(cfg, dtype, device)
        if with_target:
            self.target = CompositeTarget(cfg, dtype, device)

    def encode(self, src, seg: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
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

    def forward(self, src, tgt, seg: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """The target's loss tuple: (loss, correct, denom) for mlm, lm and
        bilm, (loss, correct) for cls and sp, {kind: tuple} for several."""
        if not hasattr(self, "target"):
            raise ValueError("this TowerModel was built without its target "
                             "(with_target=False); call encode()")
        return self.target(self.encode(src, seg, deterministic, generator),
                           tgt, seg)


def build_model(cfg: TowerConfig, dtype=None, device=None) -> TowerModel:
    return TowerModel(cfg, dtype, device)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights with the JAX package's init styles: linears as torch
    (U(+-1/sqrt(fan_in))), lookup tables N(0, 1), the patch projection and
    [CLS] N(0, 0.02), layer norms at one and zero."""
    for m in model.modules():
        if isinstance(m, (Linear, RefLayerNorm, T5LayerNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, PatchEmbedding):
            m.projection.weight.normal_(0.0, 0.02, generator=generator)
            m.cls_emb.normal_(0.0, 0.02, generator=generator)
