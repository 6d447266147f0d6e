"""lr2ppo_torch: the PyTorch and CUDA port of lr2ppo_tpu.

The JAX package stays the reference. This package imports its host side
(`lr2ppo_tpu.config`, `lr2ppo_tpu.data`, `lr2ppo_tpu.cli._common`), which is
free of JAX, and never imports jax, flax, optax or orbax.

Slice 1 is the ranking service on one GPU: `python -m lr2ppo_torch.cli.serve`.
"""
