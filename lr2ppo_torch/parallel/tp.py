"""Megatron tensor parallelism and the differentiable collectives
(counterpart of the splits XLA derives from lr2ppo_tpu/parallel/mesh.py's
rule table).

A column-parallel Linear holds rows [r*n/tp, (r+1)*n/tp) of its (out, in)
weight and bias; its input passes `copy_to_tp` (identity forward, sum of
the input gradients over tp backward). A row-parallel Linear holds the same
columns of its weight and the whole bias; its partial products pass
`reduce_from_tp` (sum over tp forward, identity backward) before the bias.
`shard_tp` slices a model built at full width, so a tp-split model starts
from the weights world 1 would draw (Linear's init bounds come from the
global fan-in).

Sequence parallelism (`--sp`, Megatron-SP) keeps the residual stream between
the tower's layers split along the sequence over tp: each tp rank holds
S/tp tokens (where tp does not divide S, ceil(S/tp) padded with zero
tokens, as XLA splits it: seq_chunk), and layer norm, dropout and the
residual add run on that shard. A column-parallel Linear then gathers its
input along S (`gather_seq`, whose backward is a reduce-scatter) instead
of `copy_to_tp`, and a row-parallel one reduce-scatters its partial
products along S (`reduce_scatter_seq`, whose backward is an all-gather)
instead of `reduce_from_tp`. A parameter applied to the shard (a layer norm's gamma and
beta, a row-parallel bias) goes through `seq_param`: its gradient is
gathered along S and reduced over the whole sequence, as the tp run reduces
it, so `--sp` trains to the tp run's bits at tp 2 (a sum of two addends
does not depend on their order).

Each collective is an autograd Function over torch.distributed, so it runs
on gloo and NCCL alike. gloo has no reduce-scatter of CUDA tensors, so there
the reduce-scatter is an all-reduce and a slice, the same sum. `dp_sum` is
the all-reduce whose backward is an all-reduce too: a loss whose
denominator counts over the global batch sums its numerator with it, and
the dp-averaged gradients are then exact.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lr2ppo_torch.parallel.mesh import (Mesh, active, all_gather_dim,
                                        assert_tp_coverage, tp_dim)


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along the last dim; the backward keeps this rank's part
    (the consumers are replicated over tp, so every rank holds the whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, group, rank, parts):
        ctx.rank, ctx.parts = rank, parts
        return all_gather_dim(x, -1, group, parts)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.parts
        return g.narrow(-1, ctx.rank * n, n).contiguous(), None, None, None


class _SplitFromTP(torch.autograd.Function):
    """This rank's part along `dim` of a tensor replicated over tp; the
    backward all-gathers the parts' gradients, so every rank holds the
    whole tensor's gradient (T5's position bias, sliced to a rank's
    heads)."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, parts):
        ctx.dim, ctx.group, ctx.parts = dim, group, parts
        n = x.shape[dim] // parts
        return x.narrow(dim, rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return (all_gather_dim(g.contiguous(), ctx.dim, ctx.group, ctx.parts),
                None, None, None, None)


class _SumBothWays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def seq_chunk(seq: int, tp: int) -> int:
    """Tokens of a tp rank's sequence shard: ceil(S / tp), as XLA splits an
    uneven dim (the first ranks take ceil(S / tp), the last ones the rest,
    down to none). The port pads each shard to this length with zero
    tokens; every gather drops them, so no sum over the sequence sees
    them."""
    return -(-seq // tp)


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[1] == n:
        return x
    pad = x.new_zeros(x.shape[0], n - x.shape[1], *x.shape[2:])
    return torch.cat([x, pad], dim=1)


def _gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (B, S, ...) from the tp ranks' padded shards."""
    full = all_gather_dim(x, 1, mesh.tp_group, mesh.tp)
    if full.shape[1] == mesh.seq_len:
        return full
    return full.narrow(1, 0, mesh.seq_len).contiguous()


def _reduce_scatter_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over tp of x (B, S, ...), this rank's padded shard of it."""
    n = seq_chunk(x.shape[1], mesh.tp)
    x = _pad_seq(x, n * mesh.tp)
    if dist.get_backend(mesh.tp_group) == "nccl":
        parts = [p.contiguous() for p in x.split(n, dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.tp_group)
        return out
    return _all_reduce(x, mesh.tp_group).narrow(
        1, mesh.tp_rank * n, n).contiguous()


def _seq_part(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = seq_chunk(x.shape[1], mesh.tp)
    return _pad_seq(x, n * mesh.tp).narrow(1, mesh.tp_rank * n,
                                           n).contiguous()


class _GatherSeq(torch.autograd.Function):
    """All-gather along S; backward: reduce-scatter along S (the consumer,
    a column-parallel product, leaves a partial gradient on each rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_seq(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.mesh), None


class _ReduceScatterSeq(torch.autograd.Function):
    """Reduce-scatter along S; backward: all-gather along S."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_scatter_seq(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g.contiguous(), ctx.mesh), None


class _SplitSeq(torch.autograd.Function):
    """This rank's S/tp rows of a tensor replicated over tp; backward:
    all-gather along S (the embedding's output entering the stream)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _seq_part(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g.contiguous(), ctx.mesh), None


class _GatherSeqReplicated(torch.autograd.Function):
    """All-gather along S into a tensor whose consumers are replicated over
    tp; backward: this rank's rows of the (whole, replicated) gradient (the
    stream leaving for the target)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_seq(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _seq_part(g, ctx.mesh), None


class _SeqParam(torch.autograd.Function):
    """p broadcast to a sequence shard's shape; backward: the per-token
    gradient gathered along S and summed to p's shape over the whole
    sequence, as autograd sums the gradient of p broadcast to the whole
    sequence. Every tp rank so holds the tp run's gradient of p."""

    @staticmethod
    def forward(ctx, p, shape, mesh):
        ctx.mesh, ctx.shape = mesh, p.shape
        return p.expand(shape)

    @staticmethod
    def backward(ctx, g):
        full = _gather_seq(g.contiguous(), ctx.mesh)
        return full.sum_to_size(ctx.shape), None, None


def gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherSeq.apply(x, mesh)


def reduce_scatter_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceScatterSeq.apply(x, mesh)


def split_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the sequence entering the --sp stream; records
    its length S on the mesh, which the gathers of the pass read."""
    mesh.seq_len = x.shape[1]
    return _SplitSeq.apply(x, mesh)


def gather_seq_replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherSeqReplicated.apply(x, mesh)


def seq_param(p: torch.Tensor, like: torch.Tensor, mesh) -> torch.Tensor:
    """p as applied to the sequence shard `like`: itself where `mesh` is
    None (no --sp), else broadcast to like's shape with _SeqParam's
    gradient."""
    if mesh is None:
        return p
    return _SeqParam.apply(p, like.shape, mesh)


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh.tp_group) if mesh.tp > 1 else x


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh.tp_group) if mesh.tp > 1 else x


def gather_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.tp == 1:
        return x
    return _GatherFromTP.apply(x, mesh.tp_group, mesh.tp_rank, mesh.tp)


def split_from_tp(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    if mesh.tp == 1:
        return x
    return _SplitFromTP.apply(x, dim, mesh.tp_group, mesh.tp_rank, mesh.tp)


def tp_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Max over tp, without a gradient."""
    if mesh.tp == 1:
        return x
    return _all_reduce(x.detach(), mesh.tp_group, dist.ReduceOp.MAX)


def tp_min(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.tp == 1:
        return x
    return _all_reduce(x.detach(), mesh.tp_group, dist.ReduceOp.MIN)


def tp_sum_int(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over tp of an integer tensor, forward only: the exact int32
    parts of a row-split int8 product (ops/int8_matmul.py:int8_matmul_tp)."""
    if mesh.tp == 1:
        return x
    return _all_reduce(x, mesh.tp_group)


def dp_sum(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """Sum over the dp ranks whose gradient flows back to every rank's
    summand: with dp-averaged gradients, a loss num/dp_sum(count) written
    as dp_sum(num_local)/dp_sum(count_local) gets the exact gradient of the
    global loss."""
    mesh = mesh or active()
    if mesh.dp == 1 or not mesh.distributed:
        return x
    if not x.requires_grad:
        return _all_reduce(x, mesh.dp_group)
    return _SumBothWays.apply(x, mesh.dp_group)


class _GatherRowsOverDP(torch.autograd.Function):
    """All-gather along dim 0 over dp; the backward sums the gradient over
    dp and keeps this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_dim(x.contiguous(), 0, mesh.dp_group, mesh.dp)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[0] // mesh.dp
        whole = _all_reduce(g, mesh.dp_group)
        return whole.narrow(0, mesh.dp_rank * n, n).contiguous(), None


def gather_dp_rows(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """The global batch's rows of x, in dp rank order, with gradients (the
    contrastive target's features: JAX's similarity matrix is global under
    pjit). Every rank then computes the whole global loss, so the summed
    gradient is dp times one rank's, and the trainer's dp average of the
    parameter gradients is world 1's gradient."""
    mesh = mesh or active()
    if mesh.dp == 1 or not mesh.distributed:
        return x
    return _GatherRowsOverDP.apply(x, mesh)


def dp_mean(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """Mean over the dp ranks, without a gradient (for metrics)."""
    mesh = mesh or active()
    if mesh.dp == 1 or not mesh.distributed:
        return x
    return _all_reduce(x.detach(), mesh.dp_group) / mesh.dp


def vocab_parallel_log_softmax_parts(logits: torch.Tensor, mesh: Mesh):
    """(log Z, m) of float32 logits split over tp along the last dim: the
    max and the sum of exponentials are all-reduced over tp, so no rank
    gathers the logits. log_softmax = logits - log Z."""
    m = tp_max(logits.detach().amax(-1, keepdim=True), mesh)
    s = reduce_from_tp(torch.exp(logits - m).sum(-1, keepdim=True), mesh)
    return m + torch.log(s)


def vocab_parallel_pick(logits: torch.Tensor, tgt: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """logits[..., tgt] of logits split over tp along the last dim; `tgt`
    holds global ids."""
    n = logits.shape[-1]
    lo = mesh.tp_rank * n
    local = tgt.long() - lo
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return reduce_from_tp(torch.where(inside, picked,
                                      torch.zeros_like(picked)), mesh)


def vocab_parallel_argmax(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global argmax of logits split over tp along the last dim, the
    first index among equal maxima, as torch.argmax."""
    n = logits.shape[-1]
    val, idx = logits.detach().max(-1)
    best = tp_max(val, mesh)
    big = torch.full_like(idx, torch.iinfo(torch.int64).max)
    cand = torch.where(val == best, idx + mesh.tp_rank * n, big)
    return tp_min(cand, mesh)


def shard_tp(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Split every Linear the rule table names over tp, in place: the
    module keeps this rank's part of its weight (and of its bias and int8
    scales where they split with it), and every module marked
    `seq_parallel` (--sp) gets the mesh as its `sp_mesh`. Raises where a
    large parameter matches no rule."""
    from lr2ppo_torch.models.layers import Linear

    if mesh.tp == 1:
        return model
    assert_tp_coverage(list(model.named_parameters()), mesh.tp)
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            d = tp_dim(f"{name}.weight")
            if d is not None:
                mod.split_tp(d, mesh)
        if getattr(mod, "seq_parallel", False):
            mod.sp_mesh = mesh
    return model
