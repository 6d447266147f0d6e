"""AdamW, Adafactor and LR schedules with the reference's semantics
(counterpart of lr2ppo_tpu/train/optim.py).

The step is the JAX package's optax chain written out:
  [clip_by_global_norm] -> scale_by_adam_hf -> add_decayed_weights(mask)
  -> scale_by_learning_rate,
so one update is  p -= lr(t) * (m / (sqrt(v) + eps) + wd * p)  with no bias
correction by default (HF AdamW(correct_bias=False)), the decay scaled by
the scheduled lr and applied after the Adam step, and t counted from 0.
torch.optim.AdamW always corrects the bias and decays before the step, so
it cannot stand in. Moments may be stored in a narrower `moment_dtype`;
their math runs in float32.

Adafactor is `optax.adafactor(learning_rate=schedule)` with optax's
defaults written out (see `Adafactor`), as the JAX package builds it for
--optimizer adafactor.

The decay mask is the JAX package's `decay_mask`: every parameter decays
but one whose flax leaf is named `bias` (the reference exempts names holding
'bias'/'gamma'/'beta', and its finetune models have no gamma/beta, so
LayerNorm weights and `pos_emb` decay). A torch `.bias` is that leaf except
where JAX declares the bias under a name of its own (the gated CNN's
`conv_stem_b`, the speech embedding's `conv_<i>_bias`): those modules set
`decay_bias`, and `no_decay_names(model)` leaves them out.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from lr2ppo_torch.ops.adamw import adamw
from lr2ppo_torch.parallel.fsdp import clean_name
from lr2ppo_torch.parallel.mesh import (all_gather_dim, shard_slice, tp_dim,
                                        zero_dim)
from lr2ppo_torch.train.checkpoints import local_part
from lr2ppo_torch.utils import count, span


def _schedule_fns(name: str, base_lr: float, train_steps: int, w: int):
    """The str2scheduler family (optimizers.py:25-300) in float64 Python
    arithmetic; the JAX package evaluates the same formulas in float32."""
    n = float(train_steps)

    def clip01(v):
        return min(max(v, 0.0), 1.0)

    if name == "constant":
        return lambda t: base_lr
    if name == "constant_with_warmup":
        return lambda t: base_lr * min(1.0, t / w)
    if name == "linear":
        return lambda t: base_lr * (t / w if t < w else max(
            0.0, (n - t) / max(1.0, n - w)))
    if name == "cosine":
        return lambda t: base_lr * (t / w if t < w else 0.5 * (
            1.0 + math.cos(math.pi * clip01((t - w) / max(1.0, n - w)))))
    if name == "inverse_sqrt":
        return lambda t: base_lr * (t / w if t < w else math.sqrt(
            w / max(t, 1)))
    if name == "polynomial":
        return lambda t: base_lr * (t / w if t < w else 1.0 - clip01(
            (t - w) / max(1.0, n - w)))
    if name == "cosine_with_restarts":
        def sched(t):
            if t < w:
                return base_lr * t / w
            prog = (t - w) / max(1.0, n - w)
            cyc = 0.5 * (1.0 + math.cos(math.pi * (prog % 1.0)))
            return base_lr * (0.0 if prog >= 1.0 else max(0.0, cyc))
        return sched
    if name == "tri_stage":
        init_scale, final_scale = 0.01, 0.05
        decay_steps = max(train_steps // 4, 1)
        hold_end = train_steps - decay_steps
        decay_factor = -math.log(final_scale) / decay_steps

        def sched(t):
            if t < w:
                factor = init_scale + (1.0 - init_scale) * t / w
            elif t < hold_end:
                factor = 1.0
            elif t <= train_steps:
                factor = math.exp(-decay_factor * (t - hold_end))
            else:
                factor = final_scale
            return base_lr * factor
        return sched
    raise ValueError(f"unknown scheduler: {name}")


def make_schedule(name: str, base_lr: float, train_steps: int,
                  warmup: float) -> Callable[[int], float]:
    """The lr at optimizer step t, counted from 0."""
    return _schedule_fns(name, base_lr, train_steps,
                         max(int(train_steps * warmup), 1))


def no_decay_names(model: torch.nn.Module) -> frozenset:
    """The reference keys of the model's parameters that AdamW does not
    decay: every `bias` but those of modules that set `decay_bias` (their
    JAX leaf has another name, so JAX's decay_mask decays it), and every
    parameter of a module that sets `no_decay` (the latent MoE tower's
    norms, towers/latent.py, which the JAX package does not have)."""
    out = set()
    for key, _ in model.named_parameters():
        key = clean_name(key)
        owner, _, leaf = key.rpartition(".")
        module = model.get_submodule(owner)
        if getattr(module, "no_decay", False) or (
                leaf == "bias" and not getattr(module, "decay_bias", False)):
            out.add(key)
    return frozenset(out)


def decays(name: str, no_decay: Optional[frozenset] = None) -> bool:
    """Whether AdamW decays the parameter `name`: not where it is in
    `no_decay` (no_decay_names of its model), and where that is not given,
    not where it is named `bias`."""
    if no_decay is not None:
        return name not in no_decay
    return name.split(".")[-1] != "bias"


class AdamW:
    """The reference's AdamW over named parameters; `step()` reads their
    `.grad` and updates them in place, a tensor at a time through
    ops/adamw.py:adamw (one kernel launch a tensor on a card, the plain
    version on the CPU). `count` is the number of steps taken; step t uses
    schedule(t)."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, correct_bias: bool = False,
                 moment_dtype: Optional[torch.dtype] = None,
                 grad_clip: Optional[float] = None,
                 no_decay: Optional[frozenset] = None):
        self.params = dict(named_params)
        self.no_decay = no_decay
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.correct_bias = weight_decay, correct_bias
        self.grad_clip = grad_clip
        self.count = 0
        self.mu = {k: torch.zeros_like(p, dtype=moment_dtype or p.dtype)
                   for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=moment_dtype or p.dtype)
                   for k, p in self.params.items()}

    def lr(self) -> float:
        """The lr the next step uses."""
        return float(self.schedule(self.count))

    @torch.no_grad()
    def step(self, grads: Optional[dict] = None,
             norm: Optional[torch.Tensor] = None) -> None:
        """One update from the parameters' `.grad`, or from `grads` by name
        (DistributedOptimizer passes the slices of a zero1 rank); `norm`
        overrides the global gradient norm that grad_clip reads."""
        with span("optim.step"):
            # a parameter the step's graph did not reach (the 2-data model's
            # other projection) takes a zero gradient, as jax.grad gives it:
            # its moments decay and its weight decay applies
            if grads is None:
                grads = {k: p.grad for k, p in self.params.items()}
            grads = {k: grads.get(k) for k in self.params}
            if self.grad_clip and norm is None:
                # optax.clip_by_global_norm: g / ||g|| * max_norm where
                # ||g|| >= max_norm; a zero gradient adds nothing
                norm = torch.sqrt(torch.as_tensor(sum(
                    (torch.sum(torch.square(g.float()))
                     for g in grads.values() if g is not None), 0.0)))
            lr = self.lr()
            self.count += 1
            step_scale = 1.0
            if self.correct_bias:
                c = float(self.count)
                step_scale = math.sqrt(1 - self.b2 ** c) / (1 - self.b1 ** c)
            on_kernel = 0
            for k, p in self.params.items():
                wd = (self.weight_decay
                      if self.weight_decay and decays(k, self.no_decay)
                      else 0.0)
                on_kernel += adamw(p, grads[k], self.mu[k], self.nu[k], lr,
                                   self.b1, self.b2, self.eps, wd,
                                   step_scale, norm, self.grad_clip)
            count("optim.kernel_tensors", on_kernel)
            count("optim.plain_tensors", len(self.params) - on_kernel)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> dict:
        """The moments, keyed by parameter name in their moment dtype, and
        the step count: what a resume needs besides the parameters."""
        return {"count": self.count,
                "mu": {k: v.detach() for k, v in self.mu.items()},
                "nu": {k: v.detach() for k, v in self.nu.items()}}

    def local_state(self) -> dict:
        """What this optimizer writes to a sharded checkpoint: in one
        process, its whole state_dict()."""
        return self.state_dict()

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a state_dict() into this optimizer's moments (each keeps its
        device and dtype); the parameter names and shapes must match."""
        for name in ("mu", "nu"):
            copy_named(f"AdamW.{name}", getattr(self, name), state[name])
        self.count = int(state["count"])


def copy_named(what: str, have: Dict[str, torch.Tensor],
               got: Dict[str, torch.Tensor]) -> None:
    """Copy the saved tensors `got` into `have`, by parameter name; the
    names, shapes and dtypes must match."""
    if set(got) != set(have):
        raise KeyError(
            f"{what}: the saved state is for other parameters (missing "
            f"{sorted(set(have) - set(got))}, unexpected "
            f"{sorted(set(got) - set(have))})")
    for k, v in got.items():
        if v.shape != have[k].shape or v.dtype != have[k].dtype:
            raise ValueError(
                f"{what}[{k!r}]: saved {v.dtype} {tuple(v.shape)}, this "
                f"optimizer holds {have[k].dtype} {tuple(have[k].shape)}")
        have[k].copy_(v)


class Adafactor:
    """optax.adafactor(learning_rate=schedule) with optax's defaults
    (optax/_src/alias.py, factorized.py, clipping.py, transform.py):

      * second moments factored into a row and a column mean for a
        parameter whose two largest dims are both >= 128, else kept whole;
        each statistic in the parameter's dtype;
      * decay 1 - (t + 1)^-0.8 at step t (counted from 0), over g^2 + 1e-30;
      * update g * rsqrt(v), factored as g * rsqrt(v_row / mean(v_row)) *
        rsqrt(v_col), then clipped to RMS 1.0 (u / max(1, rms(u)));
      * times the scheduled lr, then times max(rms(p), 1e-3)
        (multiply_by_parameter_scale); no momentum and no weight decay.

    Same interface as AdamW: `step()` reads the parameters' `.grad`;
    `state_dict()` carries the statistics and the count."""

    MIN_DIM_TO_FACTOR = 128
    DECAY_EXPONENT = 0.8
    EPS = 1e-30
    CLIP = 1.0
    MIN_PARAM_SCALE = 1e-3

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 schedule: Callable[[int], float],
                 splits: Optional[dict] = None):
        self.params = dict(named_params)
        self.schedule = schedule
        # key -> {param dim: (process group, parts)} of a tensor this rank
        # holds a part of (tp, fsdp)
        self.splits = dict(splits or {})
        self.count = 0
        self.v_row, self.v_col, self.v = {}, {}, {}
        for k, p in self.params.items():
            dims = self.factored_dims(self.global_shape(k))
            if dims is None:
                self.v[k] = torch.zeros_like(p)
            else:
                # v_row drops the largest dim, v_col the second largest
                d1, d0 = dims
                self.v_row[k] = p.new_zeros(
                    [n for i, n in enumerate(p.shape) if i != d0])
                self.v_col[k] = p.new_zeros(
                    [n for i, n in enumerate(p.shape) if i != d1])

    @classmethod
    def factored_dims(cls, shape):
        """(second largest, largest) dim where both are >= 128, else None
        (optax's _factored_dims, numpy's argsort included)."""
        if len(shape) < 2:
            return None
        order = np.argsort(tuple(shape))
        if shape[order[-2]] < cls.MIN_DIM_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    def global_shape(self, k: str) -> tuple:
        """The whole tensor's shape of the part this rank holds."""
        shape = list(self.params[k].shape)
        for d, (_group, parts) in self.splits.get(k, {}).items():
            shape[d] *= parts
        return tuple(shape)

    def _mean(self, t: torch.Tensor, dim: int, k: str, pdim: int,
              keepdim: bool = False) -> torch.Tensor:
        """The mean of t along `dim`, the parameter's dim `pdim`: over the
        whole tensor where the ranks split pdim (a sum all-reduced over
        their group)."""
        split = self.splits.get(k, {}).get(pdim)
        if split is None:
            return t.mean(dim, keepdim=keepdim)
        group, parts = split
        total = t.sum(dim, keepdim=keepdim)
        dist.all_reduce(total, group=group)
        return total / (t.shape[dim] * parts)

    def _mean_all(self, t: torch.Tensor, k: str) -> torch.Tensor:
        """The mean of every element of the whole tensor."""
        split = self.splits.get(k)
        if not split:
            return torch.mean(t)
        total, n = t.sum(), t.numel()
        for group, parts in split.values():
            dist.all_reduce(total, group=group)
            n *= parts
        return total / n

    def lr(self) -> float:
        """The lr the next step uses."""
        return float(self.schedule(self.count))

    def _decay(self) -> float:
        # optax computes 1 - t^-0.8 in float32
        t = np.float32(self.count + 1)
        return float(np.float32(1.0) - t ** np.float32(-self.DECAY_EXPONENT))

    @torch.no_grad()
    def step(self, grads: Optional[dict] = None) -> None:
        with span("optim.step"):
            decay = self._decay()
            lr = self.lr()
            self.count += 1
            if grads is None:
                grads = {k: p.grad for k, p in self.params.items()}
            for k, p in self.params.items():
                g = (torch.zeros_like(p) if grads.get(k) is None
                     else grads[k].to(p.dtype))
                g2 = g * g + self.EPS
                dims = self.factored_dims(self.global_shape(k))
                if dims is None:
                    v = decay * self.v[k] + (1.0 - decay) * g2
                    self.v[k] = v
                    upd = g * v ** -0.5
                else:
                    d1, d0 = dims
                    vr = (decay * self.v_row[k]
                          + (1.0 - decay) * self._mean(g2, d0, k, d0))
                    vc = (decay * self.v_col[k]
                          + (1.0 - decay) * self._mean(g2, d1, k, d1))
                    self.v_row[k], self.v_col[k] = vr, vc
                    r1 = d1 - 1 if d1 > d0 else d1
                    row = (vr / self._mean(vr, r1, k, d1,
                                           keepdim=True)) ** -0.5
                    upd = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
                upd = upd / torch.clamp_min(
                    torch.sqrt(self._mean_all(upd * upd, k)) / self.CLIP, 1.0)
                upd = upd * lr
                rms = torch.sqrt(self._mean_all(p * p, k))
                upd = upd * torch.clamp_min(rms, self.MIN_PARAM_SCALE)
                p.add_(upd * -1.0)

    def stat_dim(self, table: str, k: str, pdim: int) -> Optional[int]:
        """The dim of statistic `table` of key k that the parameter's dim
        `pdim` becomes, or None where the statistic reduced it away."""
        if table == "v":
            return pdim
        d1, d0 = self.factored_dims(self.global_shape(k))
        gone = d0 if table == "v_row" else d1
        if pdim == gone:
            return None
        return pdim - 1 if pdim > gone else pdim

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> dict:
        """The statistics by parameter name and the step count."""
        return {"count": self.count,
                "v_row": {k: v.detach() for k, v in self.v_row.items()},
                "v_col": {k: v.detach() for k, v in self.v_col.items()},
                "v": {k: v.detach() for k, v in self.v.items()}}

    def local_state(self) -> dict:
        """What this optimizer writes to a sharded checkpoint: in one
        process, its whole state_dict()."""
        return self.state_dict()

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a state_dict() into this optimizer's statistics; the
        parameter names and shapes must match."""
        for name in ("v_row", "v_col", "v"):
            copy_named(f"Adafactor.{name}", getattr(self, name), state[name])
        self.count = int(state["count"])


def build_optimizer(optim_cfg, named_params: Dict[str, torch.nn.Parameter],
                    train_steps: int, lr: Optional[float] = None,
                    schedule_wrap=None, splits: Optional[dict] = None,
                    no_decay: Optional[frozenset] = None):
    """AdamW or Adafactor + schedule, mirroring build_optimizer
    (ppo.py:378-419); Adafactor takes only the schedule, as in JAX.
    `no_decay` is AdamW's no_decay_names(model) (decays). `lr`
    overrides the base lr (actor vs critic); `schedule_wrap(sched) -> sched`
    remaps the step axis — PPO ticks its schedulers once per update SWEEP
    (ppo.py:612-613) via `lambda s: lambda t: s(t // upd)`. `splits` are
    Adafactor's split parameters under a mesh (DistributedOptimizer)."""
    base_lr = lr if lr is not None else optim_cfg.learning_rate
    sched = make_schedule(optim_cfg.scheduler, base_lr, train_steps,
                          optim_cfg.warmup)
    if schedule_wrap is not None:
        sched = schedule_wrap(sched)
    if optim_cfg.optimizer == "adafactor":
        return Adafactor(named_params, sched, splits)
    moment_dtype = getattr(optim_cfg, "moment_dtype", None)
    return AdamW(named_params, sched, optim_cfg.beta1, optim_cfg.beta2,
                 optim_cfg.adam_eps, optim_cfg.weight_decay,
                 optim_cfg.correct_bias,
                 getattr(torch, moment_dtype) if moment_dtype else None,
                 optim_cfg.grad_clip, no_decay)


# elements a gradient all-reduce takes at once
BUCKET_ELEMENTS = 1 << 25


class DistributedOptimizer:
    """AdamW or Adafactor under a (dp, pp, tp) mesh: the counterpart of the
    JAX package's sharded optax transformation (parallel/mesh.py:
    shard_optimizer), as an object with the optimizers' interface. Under pp
    each rank's optimizer holds its stage's parameters.

    `step()` averages the gradients over dp (all-reduce in buckets; an fsdp
    shard's gradient arrives averaged from its gather's backward), then
    updates. Under zero1 each dp rank owns a slice of every large moment:

      * AdamW is elementwise, so the rank updates the slice of the parameter
        that its moments cover, from the same averaged gradient, and the
        slices are all-gathered back into the parameter. The result is the
        unsharded update bit for bit; the moments never exist whole.
      * Adafactor's factored statistics are row and column means, and its
        update is clipped by the whole update's RMS: the rank keeps its
        slice of each statistic between steps, gathers them for the step,
        which it computes whole, and slices them again.

    Adafactor under tp and fsdp: a rank holds part of a parameter, and its
    update reads whole-tensor statistics. Which dims it factors is decided
    on the global shape; the row and column means, the update's RMS clip and
    multiply_by_parameter_scale's rms(p) sum their partial sums over the
    group that splits the reduced dim (Adafactor.splits). The partial sums
    are chosen over gathering each statistic whole, as zero1 does: they move
    a few numbers a tensor, never a tensor, and no rank ever holds a whole
    tp- or fsdp-split parameter or gradient; they differ from one process
    in the order of the sums only. Each statistic is kept as this rank's
    part (a factored statistic whose reduced dim was the split one is whole
    on every rank).

    grad_clip's norm is taken over the global gradient: the squared sums of
    tp-split and fsdp-sharded parameters are summed over their groups, and
    the stages' sums over pp. `state_dict()` gathers every moment to its
    global shape and, under pp, the stages' to rank 0 (every rank calls it);
    `load_state_dict` slices a global one (under pp, its stage's keys), so a
    `.state` written at one world resumes at any other with the same pp."""

    def __init__(self, inner, params: dict, mesh, zero1: bool,
                 fsdp_dims: dict, views: dict):
        self.inner, self.mesh = inner, mesh
        self.params = params                 # reference key -> Parameter
        self.fsdp_dims = dict(fsdp_dims)     # key -> dp dim of the shard
        self.views = dict(views)             # key -> dp dim of a zero1 view
        self.zero1 = zero1
        self.tp_dims = {}
        if mesh.tp > 1:
            self.tp_dims = {k: tp_dim(k) for k in params
                            if tp_dim(k) is not None}
        # Adafactor under zero1: statistic (table, key) -> its dp dim (the
        # statistics of tp- and fsdp-split parameters are parts already)
        self.stat_dims = {}
        if zero1 and isinstance(inner, Adafactor):
            self._slice_stats(first=True)

    @staticmethod
    def adafactor_splits(named: dict, mesh, fsdp_dims: dict) -> dict:
        """Adafactor.splits of this rank's parameters: the tp dim over the
        tp group, the fsdp dim over the dp group."""
        out = {}
        for k in named:
            split = {}
            d = tp_dim(k) if mesh.tp > 1 else None
            if d is not None:
                split[d] = (mesh.tp_group, mesh.tp)
            if k in fsdp_dims:
                split[fsdp_dims[k]] = (mesh.dp_group, mesh.dp)
            if split:
                out[k] = split
        return out

    # -- the optimizer interface ---------------------------------------
    @property
    def count(self) -> int:
        return self.inner.count

    def lr(self) -> float:
        return self.inner.lr()

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self._average_grads()
        grads = {}
        for k, p in self.params.items():
            d = self.views.get(k)
            g = p.grad
            if d is not None and g is not None:
                g = self._part(g, d)
            grads[k] = g
        if isinstance(self.inner, AdamW):
            norm = (self._global_norm() if self.inner.grad_clip
                    and (self.views or self.fsdp_dims or self.tp_dims
                         or self.mesh.pp > 1)
                    else None)
            self.inner.step(grads, norm)
        else:
            if self.stat_dims:
                self._gather_stats()
            self.inner.step(grads)
            if self.stat_dims:
                self._slice_stats()
        self._gather_views()

    # -- gradients -------------------------------------------------------
    def _part(self, t: torch.Tensor, d: int) -> torch.Tensor:
        return shard_slice(t, d, self.mesh.dp_rank, self.mesh.dp)

    def _average_grads(self) -> None:
        mesh = self.mesh
        if not mesh.distributed:
            return
        with span("optim.allreduce"):
            todo = [p.grad for k, p in self.params.items()
                    if p.grad is not None and k not in self.fsdp_dims]
            by_dtype: dict = {}
            for g in todo:
                by_dtype.setdefault(g.dtype, []).append(g)
            for group in by_dtype.values():
                bucket, size = [], 0
                for g in group + [None]:
                    if g is not None:
                        bucket.append(g)
                        size += g.numel()
                    if bucket and (g is None or size >= BUCKET_ELEMENTS):
                        flat = torch.cat([t.reshape(-1) for t in bucket])
                        dist.all_reduce(flat, group=mesh.dp_group)
                        if mesh.dp > 1:
                            flat.div_(mesh.dp)
                        for t, part in zip(bucket, flat.split(
                                [t.numel() for t in bucket])):
                            t.copy_(part.view_as(t))
                        bucket, size = [], 0

    def _global_norm(self) -> torch.Tensor:
        """sqrt of the global squared gradient sum, each parameter counted
        once: sums of split parameters are all-reduced over their groups,
        and the stages' totals over pp."""
        mesh = self.mesh
        sums = {}
        for k, p in self.params.items():
            if p.grad is None:
                continue
            kind = (k in self.tp_dims, k in self.fsdp_dims)
            sums[kind] = sums.get(kind, 0.0) + torch.sum(
                torch.square(p.grad.float()))
        total = 0.0
        for (tp_split, dp_split), v in sums.items():
            v = torch.as_tensor(v).clone()
            if dp_split:
                dist.all_reduce(v, group=mesh.dp_group)
            if tp_split:
                dist.all_reduce(v, group=mesh.tp_group)
            total = total + v
        total = torch.as_tensor(total)
        if mesh.pp > 1:
            total = total.clone()
            dist.all_reduce(total, group=mesh.pp_group)
        return torch.sqrt(total)

    @torch.no_grad()
    def _gather_views(self) -> None:
        for k, d in self.views.items():
            p = self.params[k]
            p.copy_(all_gather_dim(self._part(p, d).contiguous(), d,
                                   self.mesh.dp_group, self.mesh.dp))

    # -- Adafactor statistics under zero1 --------------------------------
    def _stat_tables(self):
        return {"v_row": self.inner.v_row, "v_col": self.inner.v_col,
                "v": self.inner.v}

    @torch.no_grad()
    def _slice_stats(self, first: bool = False) -> None:
        for tname, table in self._stat_tables().items():
            for k, t in table.items():
                if first and k in self.fsdp_dims:
                    continue
                d = (zero_dim(t.shape, self.mesh.dp) if first
                     else self.stat_dims.get((tname, k)))
                if d is None:
                    continue
                self.stat_dims[(tname, k)] = d
                table[k] = self._part(t, d).clone()

    @torch.no_grad()
    def _gather_stats(self) -> None:
        tables = self._stat_tables()
        for (tname, k), d in self.stat_dims.items():
            tables[tname][k] = all_gather_dim(
                tables[tname][k], d, self.mesh.dp_group, self.mesh.dp)

    # -- global state ------------------------------------------------------
    def _moment_dims(self, k: str):
        """(dp dim, tp dim) of key k's AdamW moments."""
        return (self.views.get(k, self.fsdp_dims.get(k)),
                self.tp_dims.get(k))

    def _split_stat_dims(self, tname: str, k: str):
        """[(stat dim, group, parts)] of an Adafactor statistic of a split
        parameter, the fsdp split first."""
        out = []
        split = self.inner.splits.get(k, {})
        for pd, (group, parts) in sorted(
                split.items(), key=lambda kv: kv[1][0] is self.mesh.tp_group):
            d = self.inner.stat_dim(tname, k, pd)
            if d is not None:
                out.append((d, group, parts))
        return out

    @torch.no_grad()
    def state_dict(self) -> dict:
        mesh = self.mesh
        if isinstance(self.inner, Adafactor):
            if self.stat_dims:
                self._gather_stats()
            sd = self.inner.state_dict()
            sd = {n: ({k: v.clone() for k, v in t.items()}
                      if isinstance(t, dict) else t) for n, t in sd.items()}
            if self.stat_dims:
                self._slice_stats()
            for tname in ("v_row", "v_col", "v"):
                for k, v in sd[tname].items():
                    for d, group, parts in self._split_stat_dims(tname, k):
                        v = all_gather_dim(v, d, group, parts)
                    sd[tname][k] = v
            return self._gather_stages(sd, ("v_row", "v_col", "v"))
        sd = self.inner.state_dict()
        for table in ("mu", "nu"):
            out = {}
            for k, v in sd[table].items():
                dd, td = self._moment_dims(k)
                if dd is not None:
                    v = all_gather_dim(v, dd, mesh.dp_group, mesh.dp)
                if td is not None:
                    v = all_gather_dim(v, td, mesh.tp_group, mesh.tp)
                out[k] = v
            sd[table] = out
        return self._gather_stages(sd, ("mu", "nu"))

    def local_state(self) -> dict:
        """This rank's share of state_dict() for a sharded checkpoint, with
        no collective: each moment or statistic as this rank holds it, a
        Part of the global tensor (tp outermost, then dp), written by one
        rank of each replica group; under pp, the stage's keys."""
        mesh = self.mesh
        out = {"count": self.inner.count}
        if isinstance(self.inner, Adafactor):
            for tname, table in self._stat_tables().items():
                out[tname] = {}
                for k, v in table.items():
                    splits = [(d, mesh.tp_rank, parts, "tp")
                              if group is mesh.tp_group
                              else (d, mesh.dp_rank, parts, "dp")
                              for d, group, parts in reversed(
                                  self._split_stat_dims(tname, k))]
                    if (tname, k) in self.stat_dims:
                        splits.append((self.stat_dims[(tname, k)],
                                       mesh.dp_rank, mesh.dp, "dp"))
                    part = local_part(v, splits, mesh)
                    if part is not None:
                        out[tname][k] = part
            return out
        for table in ("mu", "nu"):
            out[table] = {}
            for k, v in getattr(self.inner, table).items():
                dd, td = self._moment_dims(k)
                splits = ([(td, mesh.tp_rank, mesh.tp, "tp")]
                          if td is not None else [])
                if dd is not None:
                    splits.append((dd, mesh.dp_rank, mesh.dp, "dp"))
                part = local_part(v, splits, mesh)
                if part is not None:
                    out[table][k] = part
        return out

    def _gather_stages(self, sd: dict, tables) -> dict:
        if self.mesh.pp == 1:
            return sd
        from lr2ppo_torch.parallel.pipeline import gather_to_first

        return {**sd, **{t: gather_to_first(sd[t], self.mesh)
                         for t in tables}}

    def _own(self, state: dict, tables) -> dict:
        """Under pp, a whole model's state cut to this stage's keys."""
        if self.mesh.pp == 1:
            return state
        return {**state, **{t: {k: v for k, v in state[t].items()
                                if k in self.params} for t in tables}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        mesh = self.mesh
        if isinstance(self.inner, Adafactor):
            local = self._own(state, ("v_row", "v_col", "v"))
            for tname in ("v_row", "v_col", "v"):
                table = {}
                for k, v in local[tname].items():
                    for d, group, parts in reversed(
                            self._split_stat_dims(tname, k)):
                        index = (mesh.tp_rank if group is mesh.tp_group
                                 else mesh.dp_rank)
                        v = shard_slice(v, d, index, parts)
                    table[k] = v
                local[tname] = table
            if self.stat_dims:
                self._gather_stats()
            self.inner.load_state_dict(local)
            if self.stat_dims:
                self._slice_stats()
            return
        local = self._own(state, ("mu", "nu"))
        for table in ("mu", "nu"):
            out = {}
            for k, v in local[table].items():
                dd, td = self._moment_dims(k)
                if td is not None:
                    v = shard_slice(v, td, mesh.tp_rank, mesh.tp)
                if dd is not None:
                    v = shard_slice(v, dd, mesh.dp_rank, mesh.dp)
                out[k] = v
            local[table] = out
        self.inner.load_state_dict(local)
