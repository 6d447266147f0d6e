"""The towers (counterpart of lr2ppo_tpu/towers/): the XLM-R text and ViT
image encoders that make clean_feat.h5, with the reference JSON config
schema and the TencentPretrain key layout. This slice ports their
feature-extraction path; pretraining, the decoder, the targets and the other
encoder kinds come later (ROADMAP A)."""

from lr2ppo_torch.towers.model import TowerConfig, TowerModel, build_model
from lr2ppo_torch.towers.torch_import import (
    load_tower_checkpoint,
    tower_params_from_flax,
)

__all__ = [
    "TowerConfig", "TowerModel", "build_model",
    "load_tower_checkpoint", "tower_params_from_flax",
]
