"""Stage-1 pointwise trainer CLI, tabular family (counterpart of
lr2ppo_tpu/cli/pointwise_trad.py; reference pointwise_trad.sh ->
finetune/pointwise_trad.py):

    python -m lr2ppo_torch.cli pointwise_trad --train_path DIR_OR_H5 \\
        --dev_path DIR_OR_H5 [--profile fast] ...

The paths are grouped LETOR .h5 files, or directories holding {train,test}.h5
(the eval reads test.h5); reading them needs h5py. It takes the JAX package's
flags and runs on one GPU, or on one process per GPU under torchrun or
--distributed (--dp, --tp, --zero1, --fsdp as in JAX). The best model is
written to --output_model_path as a reference-keyed `.bin`."""

from __future__ import annotations

from lr2ppo_torch.cli._common import force_family, letor_pointwise_loaders
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.pointwise import PointwiseTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best NDCG@full."""
    cfg = force_family(parse_config(
        argv, "lr2ppo-torch stage-1 pointwise (tabular)"), "tabular")
    trainer = PointwiseTrainer(cfg, device)
    train, ev = letor_pointwise_loaders(cfg)
    _state, best = trainer.fit(train, ev)
    return best


if __name__ == "__main__":
    main()
