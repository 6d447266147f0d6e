"""Multi-GPU training on torch.distributed (counterpart of
lr2ppo_tpu/parallel/): the process group and the (dp, tp) mesh with its
sharding rules (mesh.py), the Megatron splits and the differentiable
collectives (tp.py), fsdp's sharded parameters (fsdp.py) and the multi-
process dry run (dryrun.py)."""

from lr2ppo_torch.parallel.mesh import (Mesh, active, init_runtime,
                                        make_mesh, set_active)

__all__ = ["Mesh", "active", "init_runtime", "make_mesh", "set_active"]
