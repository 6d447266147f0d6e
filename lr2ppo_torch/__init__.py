"""lr2ppo_torch: the PyTorch and CUDA port of lr2ppo_tpu.

The JAX package stays the reference. This package imports no module of it,
and never jax, flax, optax or orbax: it keeps its own copies of the host
side it needs (`config`, `data`, `cli._common`).

Slice 1 is the ranking service on one GPU: `python -m lr2ppo_torch.cli.serve`.
Slice 2 is the stage-3 LR²PPO trainer on one GPU:
`python -m lr2ppo_torch.cli.ppo`.
"""
