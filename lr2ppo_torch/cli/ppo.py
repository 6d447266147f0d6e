"""Stage-3 LR2PPO trainer CLI (counterpart of lr2ppo_tpu/cli/ppo.py;
reference ppo.sh -> finetune/ppo.py:main):

    python -m lr2ppo_torch.cli.ppo --train_path train.json --dev_path dev.json \\
        [--pretrained_model_path ACTOR] [--reward_model_path REWARD] \\
        [--profile fast] ...

It takes the JAX package's flags and runs on one GPU, or on one process per GPU
under torchrun or --distributed (--dp, --tp, --zero1, --fsdp as in JAX). The
best actor-critic pair is written to --output_model_path as a reference-keyed
`.bin`. Reading the MovieNet h5 store needs h5py."""

from __future__ import annotations

from lr2ppo_torch.cli._common import (movienet_eval_loader,
                                      movienet_train_loader)
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.ppo import PPOTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best NDCG@full."""
    cfg = parse_config(argv, "lr2ppo-torch stage-3 LR2PPO (multimodal)")

    # ONE loader for the whole run: fresh per-epoch pair sampling comes
    # from the trainer's loader.set_epoch(n), so the RAM preload and the
    # worker pool are paid once, not per epoch
    holder = {}

    def make_train_loader(epoch: int):
        if "loader" not in holder:
            holder["loader"] = movienet_train_loader(cfg, "ppo")
        return holder["loader"]

    ev = movienet_eval_loader(cfg)
    _astate, _cstate, best = PPOTrainer(cfg, device).fit(make_train_loader,
                                                          ev)
    return best


if __name__ == "__main__":
    main()
