"""Stage-1 pointwise trainer CLI, multimodal family (counterpart of
lr2ppo_tpu/cli/pointwise.py; reference pointwise.sh ->
finetune/pointwise.py:main):

    python -m lr2ppo_torch.cli.pointwise --train_path train.json \\
        --dev_path dev.json [--labels_num 3 --mode cls] [--profile fast] ...

It takes the JAX package's flags and runs on one GPU, or on one process per GPU
under torchrun or --distributed (--dp, --tp, --zero1, --fsdp as in JAX). The
best model is written to --output_model_path as a reference-keyed `.bin`, which
stage 3 takes as --pretrained_model_path. Reading the MovieNet h5 store needs
h5py."""

from __future__ import annotations

from lr2ppo_torch.cli._common import (movienet_eval_loader,
                                      movienet_train_loader)
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.pointwise import PointwiseTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best NDCG@full."""
    cfg = parse_config(argv, "lr2ppo-torch stage-1 pointwise (multimodal)")
    trainer = PointwiseTrainer(cfg, device)
    train = movienet_train_loader(cfg, "pointwise")
    _state, best = trainer.fit(train, movienet_eval_loader(cfg))
    return best


if __name__ == "__main__":
    main()
