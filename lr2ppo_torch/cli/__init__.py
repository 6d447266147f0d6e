"""The port's CLI entry points, each the counterpart of the JAX package's
CLI of the same name (lr2ppo_tpu/cli/__init__.py), with its flags. Run as
`python -m lr2ppo_torch.cli.<name> --flags`, or
`python -m lr2ppo_torch.cli <name> --flags`: all 14 of the JAX package's
entries."""

ENTRY_POINTS = (
    "pointwise",
    "reward_pair_dataloader",
    "ppo",
    "ppo_eval",
    "pointwise_trad",
    "pointwise_2data_trad",
    "pointwise_2data_infer_trad",
    "reward_trad",
    "ppo_trad",
    "ppo_eval_trad",
    "preprocess_data",
    "preprocess",
    "pretrain",
    "serve",
)
