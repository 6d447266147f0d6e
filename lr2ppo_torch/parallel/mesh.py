"""Process group, mesh and sharding layout on torch.distributed
(counterpart of lr2ppo_tpu/parallel/mesh.py).

One process drives one device. The mesh has the JAX package's axes:

  dp — data parallel: each dp rank takes its contiguous slice of the global
       batch; gradients are averaged over dp after every backward;
  tp — tensor parallel: Megatron column/row splits of the wide matmuls, by
       the JAX package's rule table over the port's reference-keyed
       parameter names (parallel/tp.py holds the split layers);
  pp — pipeline stages of the tower encoder (parallel/pipeline.py): stage s
       holds layers [s * L/pp, (s+1) * L/pp) and passes its activations to
       stage s + 1.

Rank r sits at (dp_rank, pp_rank, tp_rank), the JAX grid's
`devices.reshape(dp, pp, tp)` order (pipeline.py:make_pp_mesh): tp is the
innermost axis, so the ranks of one tp group are neighbours, and at pp 1 the
grid is the (dp, tp) grid `devices.reshape(dp, tp)`. Under zero1 each dp
rank owns a slice of every optimizer moment, under fsdp also of every
parameter: `zero_dim` is the JAX `_zero_spec` rule, the largest free axis
that divides dp.

`init_runtime` joins the process group: NCCL on the GPU, gloo where the
caller asks for it (the CPU tests, two ranks sharing one card). The rank and
world come from `--distributed --coordinator --num_processes --process_id`
or from the environment `torchrun` sets. The trainers read the active mesh
through `active()`; with no process group it is the single-process mesh,
whose collectives are never called.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the torchrun environment
_ENV_KEYS = ("RANK", "WORLD_SIZE")


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _ENV_KEYS)


def init_runtime(distributed: bool = False, coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, device=None,
                 backend: Optional[str] = None,
                 timeout_s: float = 1800.0) -> bool:
    """Join the process group where `distributed` is set or the process was
    started by torchrun; returns whether a process group is up. A group that
    is already up is kept. The backend is NCCL for a CUDA device and gloo
    for the CPU unless `backend` names one; NCCL without a GPU raises."""
    if dist.is_initialized():
        return True
    if not (distributed or launched_by_torchrun()):
        return False
    rank = (int(process_id) if process_id is not None and process_id >= 0
            else int(os.environ.get("RANK", -1)))
    world = (int(num_processes) if num_processes
             else int(os.environ.get("WORLD_SIZE", 0)))
    if rank < 0 or world <= 0:
        raise ValueError(
            "--distributed needs --num_processes and --process_id (or the "
            "RANK and WORLD_SIZE that torchrun sets)")
    if coordinator:
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        raise ValueError("--distributed needs --coordinator host:port (or "
                         "the MASTER_ADDR and MASTER_PORT that torchrun sets)")
    dev = torch.device(device) if device is not None else None
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" else "nccl"
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("--distributed on the GPU needs CUDA and NCCL; "
                               "the CPU takes --device cpu (gloo)")
        torch.cuda.set_device(local_device_index(rank))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return True


def local_device_index(rank: int) -> int:
    """The card a rank drives: LOCAL_RANK where torchrun sets it, else the
    rank modulo the cards of this host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


@dataclass
class Mesh:
    """A (dp, pp, tp) grid of processes; `dp_group`/`tp_group`/`pp_group`
    are the process groups of the ranks that differ from this one only in
    that coordinate (None in a single process; `pp_group` None at pp 1).
    `host_group` carries host objects between the stages (a gloo group
    over every rank; None where the default group is gloo already).
    `seq_len` is the whole sequence of the --sp pass in flight, which
    parallel/tp.py:split_seq records."""
    dp: int = 1
    tp: int = 1
    rank: int = 0
    dp_group: object = None
    tp_group: object = None
    pp: int = 1
    pp_group: object = None
    host_group: object = None
    seq_len: int = 0

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.pp * self.tp)

    @property
    def pp_rank(self) -> int:
        return (self.rank // self.tp) % self.pp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def prev_stage(self) -> Optional[int]:
        """The global rank of the previous stage at this (dp, tp), or None
        on the first stage."""
        return self.rank - self.tp if self.pp_rank > 0 else None

    @property
    def next_stage(self) -> Optional[int]:
        """The global rank of the next stage at this (dp, tp), or None on
        the last stage."""
        return self.rank + self.tp if self.pp_rank < self.pp - 1 else None

    @property
    def first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1

    @property
    def distributed(self) -> bool:
        return self.dp_group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(dp: int = -1, tp: int = 1, pp: int = 1) -> Mesh:
    """The (dp, pp, tp) mesh over the process group (a single process where
    none is up). dp = -1 takes the world size over pp * tp; a mesh larger
    than the world raises, as the JAX package's make_mesh asserts, and so
    does one that leaves a rank out."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp, pp = max(int(tp), 1), max(int(pp), 1)
    if dp == -1:
        dp = max(world // (pp * tp), 1)
    shape = f"{dp}x{tp}" if pp == 1 else f"{dp}x{pp}x{tp}"
    if dp * pp * tp > world:
        raise ValueError(f"mesh {shape} needs {dp * pp * tp} devices, have "
                         f"{world}")
    if not dist.is_initialized():
        return Mesh(dp, tp, pp=pp)
    if dp * pp * tp < world:
        raise ValueError(f"mesh {shape} holds {dp * pp * tp} of the {world} "
                         "processes; every rank takes a place in the mesh")
    rank = dist.get_rank()

    def at(d, s, t):
        return (d * pp + s) * tp + t

    me = (rank // (pp * tp), (rank // tp) % pp, rank % tp)
    dp_group = tp_group = pp_group = host_group = None
    # every rank creates every group, in one order (at pp 1: the tp groups
    # of each dp row, then the dp groups of each tp column)
    for d in range(dp):
        for s in range(pp):
            g = dist.new_group([at(d, s, t) for t in range(tp)])
            if me[:2] == (d, s):
                tp_group = g
    for s in range(pp):
        for t in range(tp):
            g = dist.new_group([at(d, s, t) for d in range(dp)])
            if me[1:] == (s, t):
                dp_group = g
    if pp > 1:
        for d in range(dp):
            for t in range(tp):
                g = dist.new_group([at(d, s, t) for s in range(pp)])
                if (me[0], me[2]) == (d, t):
                    pp_group = g
        if dist.get_backend() != "gloo":
            host_group = dist.new_group(backend="gloo")
    return Mesh(dp, tp, rank, dp_group, tp_group, pp, pp_group, host_group)


_ACTIVE: Optional[Mesh] = None


def set_active(mesh: Optional[Mesh]) -> None:
    """Make `mesh` the one the layers, losses and dropout sites read."""
    global _ACTIVE
    _ACTIVE = mesh


def active() -> Mesh:
    """The active mesh; a single process has the 1x1 mesh."""
    return _ACTIVE if _ACTIVE is not None else Mesh()


# parameter-name suffix -> the dim of the torch tensor split over tp. A
# torch weight is (out, in): the JAX column split P(None, "tp") of an
# (in, out) kernel is dim 0 here, the row split P("tp", None) dim 1. Biases
# of column-split layers split with them; int8 weight scales are per output
# channel, so they split with a column weight and stay whole with a row one.
RULES = [
    (("mlm", "linear_2", "weight"), 0),       # the MLM vocabulary head
    (("mlm", "linear_2", "bias"), 0),
    (("fc1", "weight"), 0), (("fc1", "bias"), 0), (("fc1", "weight_scale"), 0),
    (("fc2", "weight"), 1),
    # the XiT block's FFN (reference keys: fn.1.0 is fc1, fn.1.3 is fc2)
    (("fn", "1", "0", "weight"), 0), (("fn", "1", "0", "bias"), 0),
    (("fn", "1", "0", "weight_scale"), 0),
    (("fn", "1", "3", "weight"), 1),
    (("projection", "weight"), 1),
    # tower layers (towers/layers.py)
    (("final_linear", "weight"), 1),
    (("linear_2", "weight"), 1),
    (("output_layer", "weight"), 0), (("output_layer", "bias"), 0),
    (("output_layer_forward", "weight"), 0),
    (("output_layer_forward", "bias"), 0),
    (("output_layer_backward", "weight"), 0),
    (("output_layer_backward", "bias"), 0),
] + [((name, leaf), 0)
     for name in ("queries", "keys", "values", "linear_gate", "linear_1")
     for leaf in ("weight", "bias", "weight_scale")] + [
    (("linear_layers", i, leaf), 0)
    for i in ("0", "1", "2") for leaf in ("weight", "bias")]

# large parameters replicated by design (row gathers, not matmuls)
KNOWN_REPLICATED = ("embedding", "pos_emb", "cls_emb", "mask_emb")
TP_COVERAGE_MIN_ELEMENTS = 1_000_000


def tp_dim(name: str) -> Optional[int]:
    """The dim of parameter `name` split over tp, or None (replicated)."""
    parts = tuple(name.split("."))
    for suffix, dim in RULES:
        if parts[-len(suffix):] == suffix:
            return dim
    return None


def assert_tp_coverage(named_params, tp: int,
                       min_elements: int = TP_COVERAGE_MIN_ELEMENTS) -> None:
    """Raise where tp > 1 and a 2-D parameter of at least `min_elements`
    matches no rule: it would be replicated on every tp rank."""
    if tp <= 1:
        return
    misses = [f"{k} {tuple(v.shape)}" for k, v in named_params
              if v.ndim == 2 and v.numel() >= min_elements
              and tp_dim(k) is None
              and not any(p in KNOWN_REPLICATED for p in k.split("."))]
    if misses:
        raise ValueError("tp sharding rule table (RULES) misses large "
                         "parameters; they would be fully replicated on "
                         "every tp rank:\n  " + "\n  ".join(misses))


# leaves below this size stay whole under zero1/fsdp (mesh.py:
# ZERO1_MIN_ELEMENTS)
ZERO1_MIN_ELEMENTS = 2 ** 16


def zero_dim(shape, dp: int, base_dim: Optional[int] = None
             ) -> Optional[int]:
    """The dim a zero1 moment or an fsdp parameter of this (local) shape is
    split over dp: the largest dim, other than the tp-split `base_dim`, that
    dp divides; None below ZERO1_MIN_ELEMENTS, at dp 1 or where no dim
    divides (the JAX `_zero_spec`, ties to the first dim as its max)."""
    shape = tuple(shape)
    if dp <= 1 or not shape or math.prod(shape) < ZERO1_MIN_ELEMENTS:
        return None
    free = [i for i, n in enumerate(shape) if i != base_dim and n % dp == 0]
    if not free:
        return None
    return max(free, key=lambda i: shape[i])


def shard_slice(t: torch.Tensor, dim: int, index: int, parts: int
                ) -> torch.Tensor:
    """Part `index` of `parts` equal parts of t along `dim` (a view)."""
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split in "
                         f"{parts}")
    return t.narrow(dim, index * (n // parts), n // parts)


def all_gather_parts(t: torch.Tensor, group, parts: int) -> list:
    """Every rank's `t` (one shape on all of them), in the group's rank
    order (no autograd)."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(parts)]
    dist.all_gather(out, t, group=group)
    return out


def all_gather_dim(t: torch.Tensor, dim: int, group, parts: int
                   ) -> torch.Tensor:
    """The whole tensor from each rank's part along `dim` (no autograd)."""
    if parts == 1:
        return t
    return torch.cat(all_gather_parts(t, group, parts), dim=dim)


def local_rows(x, mesh: Mesh, axis: int = 0):
    """This dp rank's contiguous slice of a full global array along `axis`
    (the JAX put_global(from_full_copy=True)); the whole array at dp 1."""
    if mesh.dp == 1:
        return x
    n = x.shape[axis]
    if n % mesh.dp:
        raise ValueError(f"global batch axis {axis} ({n}) must be divisible "
                         f"by dp ({mesh.dp})")
    per = n // mesh.dp
    idx = slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
    return x[(slice(None),) * axis + (idx,)]


def fetch_global(t: torch.Tensor, mesh: Mesh, axis: int = 0) -> np.ndarray:
    """Host copy of the global array whose dp slices the ranks hold: an
    all-gather over dp, in rank order (every dp rank calls it)."""
    if mesh.dp > 1:
        t = all_gather_dim(t.detach(), axis, mesh.dp_group, mesh.dp)
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()
