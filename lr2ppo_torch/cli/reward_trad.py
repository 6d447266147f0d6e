"""Stage-2 reward trainer CLI, tabular family (counterpart of
lr2ppo_tpu/cli/reward_trad.py; reference reward_trad.sh ->
finetune/reward_trad.py; hinge margin 0.01, 5 relevance classes):

    python -m lr2ppo_torch.cli reward_trad --train_path DIR_OR_H5 \\
        --dev_path DIR_OR_H5 [--profile fast] ...

The eval is the pairwise accuracy on 20 pairs of each test query. Reading the
grouped .h5 files needs h5py. It runs on one GPU, or on one process per GPU
under torchrun or --distributed (--dp, --tp, --zero1, --fsdp as in JAX); the
best model goes to --output_model_path as a reference-keyed `.bin`, which
ppo_trad takes as --reward_model_path."""

from __future__ import annotations

from lr2ppo_torch.cli._common import force_family, letor_reward_loaders
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.reward import RewardTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best pairwise eval accuracy."""
    cfg = force_family(parse_config(
        argv, "lr2ppo-torch stage-2 reward (tabular)"), "tabular")
    trainer = RewardTrainer(cfg, device)
    train, ev = letor_reward_loaders(cfg)
    _state, best = trainer.fit(train, ev)
    return best


if __name__ == "__main__":
    main()
