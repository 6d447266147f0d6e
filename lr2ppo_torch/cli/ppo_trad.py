"""Stage-3 LR2PPO trainer CLI, tabular family (counterpart of
lr2ppo_tpu/cli/ppo_trad.py; reference ppo_trad.sh -> finetune/ppo_trad.py):

    python -m lr2ppo_torch.cli ppo_trad --train_path DIR_OR_H5 \\
        --dev_path DIR_OR_H5 [--pretrained_model_path ACTOR] \\
        [--reward_model_path REWARD] [--profile fast] ...

Each epoch samples fresh 2-document pairs of every training query. Reading the
grouped .h5 files needs h5py. It runs on one GPU, or on one process per GPU
under torchrun or --distributed (--dp, --tp, --zero1, --fsdp as in JAX); the
best actor-critic pair goes to --output_model_path as a reference-keyed `.bin`."""

from __future__ import annotations

from lr2ppo_torch.cli._common import force_family, letor_ppo_loaders
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.ppo import PPOTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best NDCG@full."""
    cfg = force_family(parse_config(
        argv, "lr2ppo-torch stage-3 LR2PPO (tabular)"), "tabular")
    trainer = PPOTrainer(cfg, device)
    make_train_loader, ev = letor_ppo_loaders(cfg)
    _astate, _cstate, best = trainer.fit(make_train_loader, ev)
    return best


if __name__ == "__main__":
    main()
