"""The towers (counterpart of lr2ppo_tpu/towers/): the XLM-R text and ViT
image encoders that make clean_feat.h5, and the pretraining towers with
their targets, encoder-only and encoder-decoder (T5's relative bias,
residual attention, sinusoidal positions), the RNN family, the gated CNN
and the dual (CLIP-style) encoder with the contrastive target, the image
and speech embeddings (ViLT's word_patch, BEiT's masked_patch, S2T's
convolutional subsampler), with the reference JSON config schema and the
TencentPretrain key layout; and the VQGAN image tokenizer (vqgan.py)."""

from lr2ppo_torch.towers.model import TowerConfig, TowerModel, build_model
from lr2ppo_torch.towers.torch_import import (
    load_tower_checkpoint,
    tower_params_from_flax,
)

__all__ = [
    "TowerConfig", "TowerModel", "build_model",
    "load_tower_checkpoint", "tower_params_from_flax",
]
