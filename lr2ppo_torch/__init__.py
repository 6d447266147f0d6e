"""lr2ppo_torch: the PyTorch and CUDA port of lr2ppo_tpu.

The JAX package stays the reference. This package imports no module of it,
and never jax, flax, optax or orbax: it keeps its own copies of the host
side it needs (`config`, `data`, `native`, `cli._common`).

The entry points, `python -m lr2ppo_torch.cli <entry>` (listed in
lr2ppo_torch/cli/__init__.py), serve rankings, extract tower features,
train and evaluate the three LR²PPO stages of both families (LRMovieNet
multimodal, LETOR tabular, with the 2-data unification trainer and its
projection exporter) and pretrain the towers, on one GPU or one process per
GPU (lr2ppo_torch/parallel/: dp, tp, zero1, fsdp), and run the LETOR
offline pipeline on the host.
"""
