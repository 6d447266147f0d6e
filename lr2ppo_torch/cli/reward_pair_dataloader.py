"""Stage-2 pairwise reward trainer CLI, multimodal family (counterpart of
lr2ppo_tpu/cli/reward_pair_dataloader.py; reference
reward_pair_dataloader.sh -> finetune/reward_pair_dataloader.py:main):

    python -m lr2ppo_torch.cli.reward_pair_dataloader --train_path train.json \\
        --dev_path dev.json [--profile fast] ...

The training JSON's items carry their tag pairs under "index". It takes the JAX
package's flags and runs on one GPU, or on one process per GPU under torchrun
or --distributed (--dp, --tp, --zero1, --fsdp as in JAX). The best model is
written to --output_model_path as a reference-keyed `.bin`, which stage 3 takes
as --reward_model_path. Reading the MovieNet h5 store needs h5py."""

from __future__ import annotations

from lr2ppo_torch.cli._common import (movienet_eval_loader,
                                      movienet_train_loader)
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.reward import RewardTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best pairwise eval accuracy."""
    cfg = parse_config(argv, "lr2ppo-torch stage-2 reward (multimodal)")
    trainer = RewardTrainer(cfg, device)
    train = movienet_train_loader(cfg, "reward")
    ev = movienet_eval_loader(cfg, mode="reward_eval")
    _state, best = trainer.fit(train, ev)
    return best


if __name__ == "__main__":
    main()
