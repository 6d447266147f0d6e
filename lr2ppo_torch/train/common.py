"""Shared trainer plumbing (counterpart of lr2ppo_tpu/train/common.py):
train state, placement on the mesh (DeviceCtx), save-best, and the `.state`
save and resume. One process drives one device; under a mesh every rank
runs the same trainer on its shard, and rank 0 writes the files."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lr2ppo_torch.config import Config
from lr2ppo_torch.device import compute_dtype, require_cuda
from lr2ppo_torch.parallel.fsdp import clean_name, shard_fsdp
from lr2ppo_torch.parallel.mesh import (Mesh, active, all_gather_dim,
                                        init_runtime,
                                        local_rows, make_mesh, set_active,
                                        shard_slice, tp_dim, zero_dim)
from lr2ppo_torch.parallel.tp import dp_mean, shard_tp
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.checkpoints import local_part
from lr2ppo_torch.train.optim import (AdamW, DistributedOptimizer,
                                      build_optimizer, no_decay_names)
from lr2ppo_torch.utils import count, recording, span


@dataclass
class TrainState:
    """A trainable model, its optimizer and the count of steps taken."""
    model: nn.Module
    opt: AdamW
    step: int = 0


def init_state(model: nn.Module, opt: AdamW) -> TrainState:
    return TrainState(model, opt, 0)


def apply_updates(state: TrainState) -> TrainState:
    """One optimizer step from the gradients the model holds; the gradients
    are dropped after it."""
    state.opt.step()
    state.opt.zero_grad()
    state.step += 1
    return state


class DeviceCtx:
    """Placement on this rank's device under the active mesh (counterpart
    of lr2ppo_tpu/train/common.py:DeviceCtx): batches, models and
    optimizers.

    `cast_dtype` (e.g. "bfloat16"): float inputs are cast on the host
    before the copy; the models compute in that dtype anyway, and float32
    embeddings double the host-to-device bytes (a (256, 2, 196, 768) text
    batch is 1.2 GB in float32 and 0.6 GB in bfloat16).

    Under dp the training loaders are sharded (Loader(shard=(dp_rank,
    dp))), so `put` moves this rank's rows; eval loaders are not, and
    `put_eval` takes this rank's slice of the whole batch, padded to a
    multiple of dp with masked rows. zero1 and fsdp do nothing at dp 1, and
    fsdp implies zero1, as in JAX."""

    def __init__(self, device, cast_dtype=None, mesh: Optional[Mesh] = None,
                 zero1: bool = False, fsdp: bool = False):
        self.device = torch.device(device)
        self.cast_dtype = (None if cast_dtype is None
                           else compute_dtype(str(cast_dtype)))
        self.mesh = mesh or Mesh()
        self.fsdp = bool(fsdp and self.mesh.dp > 1)
        self.zero1 = bool((zero1 or self.fsdp) and self.mesh.dp > 1)

    @property
    def is_main(self) -> bool:
        return self.mesh.is_main

    def _cast(self, v) -> torch.Tensor:
        a = np.ascontiguousarray(v)
        if a.dtype.name == "bfloat16":         # ml_dtypes arrays
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if (self.cast_dtype is not None and t.is_floating_point()
                and t.dtype != self.cast_dtype):
            t = t.to(self.cast_dtype)
        return t

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        if recording():
            count("h2d.bytes", t.nbytes)
            if not t.is_pinned():
                count("h2d.pageable_bytes", t.nbytes)
        return t.to(self.device, non_blocking=False)

    def put(self, batch: dict) -> dict:
        with span("data.put"):
            return {k: self._copy(self._cast(v)) for k, v in batch.items()}

    def put_eval(self, batch: dict) -> dict:
        """This dp rank's rows of a whole eval batch (every rank holds the
        same batch), padded with zero rows to a multiple of dp; the padded
        rows' mask is False. At dp 1, `put`."""
        dp = self.mesh.dp
        if dp == 1:
            return self.put(batch)
        n = next(iter(batch.values())).shape[0]
        pad = -n % dp
        out = {}
        for k, v in batch.items():
            a = np.asarray(v)
            if pad:
                a = np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                a.dtype)])
            out[k] = local_rows(a, self.mesh)
        return self.put(out)

    def put_array(self, v) -> torch.Tensor:
        """One array -> device, no dtype cast."""
        with span("data.put"):
            return self._copy(torch.from_numpy(np.ascontiguousarray(v)))

    def check_loader(self, loader) -> None:
        """A training loader under dp must hand this rank its slice of each
        global batch."""
        want = (self.mesh.dp_rank, self.mesh.dp)
        if self.mesh.dp > 1 and getattr(loader, "shard", None) != want:
            raise ValueError(
                f"at dp {self.mesh.dp} the training loader must be sharded "
                f"as Loader(shard={want}); it has "
                f"{getattr(loader, 'shard', None)}")

    # -- models ------------------------------------------------------------
    def place(self, model: nn.Module, fsdp: Optional[bool] = None
              ) -> nn.Module:
        """Split a full-width model over the mesh, in place: the tp rule
        table's Linears keep this rank's part, and under fsdp (unless
        `fsdp` is False: the frozen models) every large parameter is
        stored as this dp rank's part."""
        shard_tp(model, self.mesh)
        model._fsdp_dims = (shard_fsdp(model, self.mesh)
                            if (self.fsdp if fsdp is None else fsdp) else {})
        return model

    def named_parameters(self, model: nn.Module) -> dict:
        """{reference key: parameter}; an fsdp parameter is its shard."""
        return {clean_name(k): p for k, p in model.named_parameters()}

    def optimizer(self, optim_cfg, model: nn.Module, train_steps: int,
                  **kw):
        """build_optimizer over the model's parameters, wrapped in a
        DistributedOptimizer when a process group is up (zero1 slices the
        AdamW moments: each rank's optimizer sees views of its slices)."""
        named = self.named_parameters(model)
        kw.setdefault("no_decay", no_decay_names(model))
        if not self.mesh.distributed:
            return build_optimizer(optim_cfg, named, train_steps, **kw)
        fsdp_dims = getattr(model, "_fsdp_dims", {})
        adafactor = optim_cfg.optimizer == "adafactor"
        if adafactor:
            kw["splits"] = DistributedOptimizer.adafactor_splits(
                named, self.mesh, fsdp_dims)
        views = {}
        if self.zero1 and not adafactor:
            for k, p in named.items():
                d = (None if k in fsdp_dims
                     else zero_dim(p.shape, self.mesh.dp, tp_dim(k)))
                if d is not None:
                    views[k] = d
        inner_params = {
            k: (shard_slice(p.detach(), views[k], self.mesh.dp_rank,
                            self.mesh.dp) if k in views else p)
            for k, p in named.items()}
        inner = build_optimizer(optim_cfg, inner_params, train_steps, **kw)
        return DistributedOptimizer(inner, named, self.mesh, self.zero1,
                                    fsdp_dims, views)

    @torch.no_grad()
    def full_state_dict(self, model: nn.Module) -> dict:
        """The model's reference-keyed state_dict at full width: fsdp parts
        gathered over dp, tp parts over tp, and under pp the stages' parts
        on rank 0 (the whole model there, a stage's part elsewhere). Every
        rank must call it."""
        mesh, dims = self.mesh, getattr(model, "_fsdp_dims", {})
        out = {}
        for k, v in model.state_dict().items():
            k = clean_name(k)
            if k in dims:
                v = all_gather_dim(v, dims[k], mesh.dp_group, mesh.dp)
            d = tp_dim(k) if mesh.tp > 1 else None
            if d is not None and _is_split(model, k):
                v = all_gather_dim(v, d, mesh.tp_group, mesh.tp)
            out[k] = v
        if mesh.pp > 1:
            from lr2ppo_torch.parallel.pipeline import gather_to_first

            out = gather_to_first(out, mesh)
        return out

    def local_state_dict(self, model: nn.Module) -> dict:
        """The per-rank counterpart of full_state_dict, with no collective:
        {reference key: Part} of the tensors this rank writes to a sharded
        checkpoint, each as this rank holds it with its place in the whole
        (the tp split outermost, then the fsdp one); a tensor whole along
        an axis is written by the rank at index 0 of that axis, and under
        pp each stage writes its own keys."""
        mesh, dims = self.mesh, getattr(model, "_fsdp_dims", {})
        out = {}
        for k, v in model.state_dict().items():
            k = clean_name(k)
            splits = []
            d = tp_dim(k) if mesh.tp > 1 else None
            if d is not None and _is_split(model, k):
                splits.append((d, mesh.tp_rank, mesh.tp, "tp"))
            if k in dims:
                splits.append((dims[k], mesh.dp_rank, mesh.dp, "dp"))
            part = local_part(v, splits, mesh)
            if part is not None:
                out[k] = part
        return out

    @torch.no_grad()
    def load_full_state(self, model: nn.Module, state: dict) -> None:
        """Load a full-width reference-keyed state_dict (strict) into a
        placed model: each tensor sliced to this rank's part (under pp, the
        stage's keys of a whole model's state)."""
        mesh, dims = self.mesh, getattr(model, "_fsdp_dims", {})
        local = {}
        keys = {clean_name(k): k for k in model.state_dict()}
        if mesh.pp > 1:
            state = {k: v for k, v in state.items() if k in keys}
        if set(keys) != set(state):
            raise KeyError(
                f"state_dict mismatch: missing {sorted(set(keys) - set(state))}"
                f", unexpected {sorted(set(state) - set(keys))}")
        for k, raw in keys.items():
            v = state[k]
            d = tp_dim(k) if mesh.tp > 1 else None
            if d is not None and _is_split(model, k):
                v = shard_slice(v, d, mesh.tp_rank, mesh.tp)
            if k in dims:
                v = shard_slice(v, dims[k], mesh.dp_rank, mesh.dp)
            local[raw] = v
        model.load_state_dict(local, strict=True)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """A per-rank metric's mean over dp (the global batch's mean where
        the ranks hold equal shards)."""
        return dp_mean(t, self.mesh)


def _is_split(model: nn.Module, key: str) -> bool:
    """Whether the Linear holding `key` was split over tp (the rule table
    names a Linear's int8 scale only where it splits with the weight)."""
    mod = model.get_submodule(key.rsplit(".", 1)[0])
    return getattr(mod, "tp_dim", None) is not None


def check_unported(cfg: Config, allow_pp: bool = False) -> None:
    """Refuse an unknown checkpoint backend, and --pp outside tower
    pretraining (`allow_pp`), as the JAX package pipelines only the tower
    encoder."""
    checkpoints.check_backend(cfg.ckpt_backend)
    if getattr(cfg.mesh, "pp", 1) > 1 and not allow_pp:
        raise ValueError("--pp pipelines the tower encoder: it runs in "
                         "tower pretraining (cli/pretrain.py) only")


def device_ctx(cfg: Config, device=None, cast_dtype=None,
               allow_pp: bool = False) -> DeviceCtx:
    """The run's DeviceCtx: joins the process group where --distributed is
    set or torchrun started the process, builds the (dp, pp, tp) mesh and
    makes it the active one. The device is `device` where the caller passes
    one, else the GPU (raising where there is none); a rank of an NCCL group
    takes its own card."""
    check_unported(cfg, allow_pp)
    m = cfg.mesh
    up = init_runtime(m.distributed, m.coordinator or None,
                      m.num_processes or None,
                      m.process_id if m.process_id >= 0 else None,
                      device=device)
    mesh = active()
    world = dist.get_world_size() if up else 1
    tp, pp = max(m.tp, 1), max(getattr(m, "pp", 1), 1)
    dp = max(world // (tp * pp), 1) if m.dp == -1 else m.dp
    if not (mesh.distributed and (mesh.dp, mesh.tp, mesh.pp) == (dp, tp, pp)):
        # a second trainer of the same run keeps the mesh and its groups
        mesh = make_mesh(m.dp, m.tp, pp)
    set_active(mesh)
    if device is None or torch.device(device).type == "cuda":
        require_cuda()
        if device is None or torch.device(device).index is None:
            device = torch.device("cuda", torch.cuda.current_device()
                                  if up else 0)
    return DeviceCtx(device, cast_dtype, mesh, m.zero1, m.fsdp)


def logged_path(ctx: DeviceCtx, path: Optional[str]) -> Optional[str]:
    """Logs and metric files are written by rank 0 only."""
    return path if ctx.is_main else None


def save_models(path: str, models, ctx: Optional[DeviceCtx] = None,
                backend: str = "pickle") -> None:
    """Write one model (stages 1 and 2, pretraining) as a reference-keyed
    `.bin`, or the {"actor", "critic"} pair as one ActorCritic `.bin`
    (stage 3). Under a mesh the pickle backend gathers the full-width
    weights on every rank and rank 0 writes; the sharded backends write
    each rank's part (DeviceCtx.local_state_dict) with no gather. Every
    rank must call it."""
    def weights(model):
        if ctx is None:
            return model
        return (ctx.full_state_dict(model) if backend == "pickle"
                else ctx.local_state_dict(model))

    if isinstance(models, dict):
        write = checkpoints.save_actor_critic
        parts = [weights(models["actor"]), weights(models["critic"])]
    else:
        write, parts = checkpoints.save_model, [weights(models)]
    if backend == "pickle" and ctx is not None and not ctx.is_main:
        return
    write(path, *parts, backend)


class BestSaver:
    """Save-best contract (model_saver.py:4-11, ppo.py:910-915): one model
    is written as a reference-keyed `.bin` (stages 1 and 2), the
    {"actor", "critic"} pair as one ActorCritic `.bin` (stage 3), with the
    run's checkpoint backend (save_models). Under a mesh the metric is the
    same on every rank, so all of them take the branch."""

    def __init__(self, path: str, logger=None,
                 ctx: Optional[DeviceCtx] = None, backend: str = "pickle"):
        self.path = path
        self.best = -np.inf
        self.logger = logger
        self.ctx = ctx
        self.backend = backend

    def maybe_save(self, metric: float, models) -> bool:
        # 'not (metric > best)': NaN from a diverged eval must never
        # overwrite the real best checkpoint ('NaN <= best' is False)
        if not (metric > self.best):
            return False
        self.best = float(metric)
        if self.path:
            save_models(self.path, models, self.ctx, self.backend)
        if self.logger:
            self.logger.info("Best val indicator until now!")
        return True


def peek_batch(loader):
    """First batch for shape probing / param init. Prefers the loader's
    synchronous first_batch() — abandoning a started prefetch iterator
    leaves workers racing the next iteration for the collate buffers."""
    fb = getattr(loader, "first_batch", None)
    return fb() if fb is not None else next(iter(loader))


def save_train_state(path: str, states: dict, generator: torch.Generator,
                     step: int, best: float, ctx: Optional[DeviceCtx] = None,
                     backend: str = "pickle", **counters) -> None:
    """The resumable `.state` payload (checkpoints.save_state): each named
    TrainState's model, optimizer and update count, the dropout generator's
    state, the step and the best watermark. The single-model trainers name
    their state "model"; PPO names "actor" and "critic" and adds its
    rollout counter. Under a mesh the pickle backend writes full-width
    tensors (every rank gathers; rank 0 writes), and the sharded backends
    each rank's part with no gather; either resumes at any world."""
    whole = backend == "pickle"
    if ctx is None:
        models = {k: s.model for k, s in states.items()}
    else:
        weights = ctx.full_state_dict if whole else ctx.local_state_dict
        models = {k: weights(s.model) for k, s in states.items()}
    optims = {k: s.opt.state_dict() if whole else s.opt.local_state()
              for k, s in states.items()}
    if whole and ctx is not None and not ctx.is_main:
        return
    checkpoints.save_state(
        path, models, optims, generator, backend, step=step,
        best=best, updates={k: s.step for k, s in states.items()},
        **counters)


def restore_train_state(state: TrainState, payload: dict, name: str,
                        ctx: Optional[DeviceCtx] = None) -> TrainState:
    """Load the payload's model `name` (strict), its optimizer's moments and
    count and its update count into `state`, in place; under a mesh each
    full-width tensor is sliced to this rank's part."""
    if ctx is not None:
        ctx.load_full_state(state.model, payload["models"][name])
    else:
        state.model.load_state_dict(payload["models"][name], strict=True)
    state.opt.load_state_dict(payload["optims"][name])
    state.step = int(payload["updates"][name])
    return state


def resume_fit_state(cfg: Config, state: TrainState,
                     generator: torch.Generator, steps_per_epoch: int,
                     logger=None, ctx: Optional[DeviceCtx] = None):
    """--resume_path for the single-model trainers: the train state and the
    dropout generator restored in place, and where the data stream picks
    up. Returns (step, start_epoch, skip_batches, resume_best); an epoch
    past epochs_num makes the epoch range empty, so resuming a finished run
    is a no-op. A JAX package `.state` raises (checkpoints.load_state).

    The JAX package replays its threefry key stream past the completed
    steps (burn_keys); the port restores the generator's saved state, which
    is where the uninterrupted run's stream stands after those steps."""
    payload = checkpoints.load_state(cfg.resume_path)
    restore_train_state(state, payload, "model", ctx)
    generator.set_state(payload["generator"])
    step = int(payload["step"])
    resume_best = float(payload["best"])
    start_epoch = step // steps_per_epoch + 1
    skip_batches = step % steps_per_epoch
    if logger is not None:
        logger.info(
            f"resumed from {cfg.resume_path} @ step {step} "
            f"(epoch {start_epoch}, skipping {skip_batches} batches)")
    return step, start_epoch, skip_batches, resume_best
