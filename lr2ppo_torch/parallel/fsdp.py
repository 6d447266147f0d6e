"""fsdp: parameters stored sharded over dp (counterpart of
lr2ppo_tpu/parallel/mesh.py:shard_params_fsdp).

Each large parameter keeps only this dp rank's part along its zero dim
(mesh.py:zero_dim, the JAX `_zero_spec` rule, composed onto the tp split).
A parametrization gathers the whole tensor where the module reads it, and
its backward sums the gradient over dp and keeps this rank's part, divided
by dp: the shard receives the dp-averaged gradient, which the optimizer
then updates in place. The optimizer's moments have the shard's shape, so
fsdp implies zero1. The collectives are all-gather and all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from lr2ppo_torch.parallel.mesh import (Mesh, all_gather_dim, shard_slice,
                                        tp_dim, zero_dim)


class _GatherOverDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather_dim(shard, dim, mesh.dp_group, mesh.dp)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.dp_group)
        part = shard_slice(g, ctx.dim, mesh.dp_rank, mesh.dp)
        return part.contiguous().div_(mesh.dp), None, None


class GatherShard(nn.Module):
    """The parametrization of one fsdp parameter: stored as this rank's
    part along `dim`, read whole."""

    def __init__(self, dim: int, mesh: Mesh):
        super().__init__()
        self.dim, self.mesh = dim, mesh

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _GatherOverDP.apply(shard, self.dim, self.mesh)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return shard_slice(full, self.dim, self.mesh.dp_rank,
                           self.mesh.dp).clone()


def clean_name(name: str) -> str:
    """The reference key of a parameter that a parametrization stores as
    `<module>.parametrizations.<name>.original`."""
    return name.replace(".parametrizations.", ".").replace(".original", "")


def shard_fsdp(model: nn.Module, mesh: Mesh) -> dict:
    """Store every parameter that zero_dim splits as this rank's part, in
    place. Returns {reference key: dim} of the sharded parameters."""
    if mesh.dp == 1:
        return {}
    out = {}
    for mod_name, mod in list(model.named_modules()):
        for pname, p in list(mod.named_parameters(recurse=False)):
            key = f"{mod_name}.{pname}" if mod_name else pname
            d = zero_dim(p.shape, mesh.dp, tp_dim(key))
            if d is None:
                continue
            parametrize.register_parametrization(mod, pname,
                                                 GatherShard(d, mesh),
                                                 unsafe=True)
            out[key] = d
    return out
