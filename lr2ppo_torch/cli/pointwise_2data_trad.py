"""Feature-unification trainer CLI (counterpart of
lr2ppo_tpu/cli/pointwise_2data_trad.py; reference pointwise_2data_trad.sh
-> finetune/pointwise_2data_trad.py): joint pointwise training on two raw
LETOR domains (46-d MQ2008 + 136-d Web10K) with alternating batches.

    python -m lr2ppo_torch.cli pointwise_2data_trad --train_path A \\
        --dev_path A --train_path2 B --dev_path2 B [--profile fast] ...

--train_path/--dev_path = domain A grouped h5 (or a {train,test}.h5 directory),
--train_path2/--dev_path2 = domain B; reading them needs h5py. The raw feature
dims are read from the data and become the model's trad_dims (text_proj /
text_proj3, pointwise_2data_trad.py:136-151). It runs on one GPU, or on one
process per GPU under torchrun or --distributed (--dp, --tp, --zero1, --fsdp as
in JAX); the best model goes to --output_model_path as a reference-keyed
`.bin`, which pointwise_2data_infer_trad reads."""

from __future__ import annotations

from lr2ppo_torch.cli._common import force_family, letor_two_data_loaders
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train.common import device_ctx
from lr2ppo_torch.train.pointwise import TwoDataTrainer


def main(argv=None, device=None) -> float:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns the best mean NDCG@full of the two domains."""
    cfg = force_family(parse_config(
        argv, "lr2ppo-torch 2-data unification (tabular)"), "tabular")
    # the mesh first: the loaders read its dp shard
    device_ctx(cfg, device)
    cfg, loaders, evs = letor_two_data_loaders(cfg)
    _state, best = TwoDataTrainer(cfg, device).fit_two(loaders, evs)
    return best


if __name__ == "__main__":
    main()
