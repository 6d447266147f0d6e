"""Shared trainer plumbing on one device (counterpart of
lr2ppo_tpu/train/common.py): train state, host-to-device placement,
save-best, and the `.state` save and resume."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from lr2ppo_torch.config import Config
from lr2ppo_torch.device import compute_dtype, require_cuda
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.optim import AdamW


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
    """Host batch -> device tensors on one device. `cast_dtype` (e.g.
    "bfloat16"): float inputs are cast on the host before the copy — the
    models compute in that dtype anyway, and float32 embeddings double the
    host-to-device bytes (a (256, 2, 196, 768) text batch is 1.2 GB in
    float32 and 0.6 GB in bfloat16)."""

    def __init__(self, device: torch.device, cast_dtype=None):
        self.device = torch.device(device)
        self.cast_dtype = (None if cast_dtype is None
                           else compute_dtype(str(cast_dtype)))

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

    def put(self, batch: dict) -> dict:
        return {k: self._cast(v).to(self.device, non_blocking=False)
                for k, v in batch.items()}

    def put_array(self, v) -> torch.Tensor:
        """One array -> device, no dtype cast."""
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)


def check_single_device(cfg: Config, device) -> torch.device:
    """The device the single-GPU trainers run on: `device` where the caller
    passes one, else the GPU (raising where there is none). --dp/--tp above
    1, a non-pickle checkpoint backend and --profile_dir raise."""
    if cfg.mesh.dp > 1 or cfg.mesh.tp > 1:
        raise ValueError(f"--dp {cfg.mesh.dp} --tp {cfg.mesh.tp}: the port "
                         "trains on one GPU; multi-GPU is not ported yet")
    checkpoints.check_backend(cfg.ckpt_backend)
    if cfg.profile_dir:
        raise NotImplementedError(
            "--profile_dir (the trace window) is not ported yet (ROADMAP.md, "
            "A3.8)")
    return require_cuda() if device is None else torch.device(device)


class BestSaver:
    """Save-best contract (model_saver.py:4-11, ppo.py:910-915): one model
    is written as a reference-keyed `.bin` (stages 1 and 2), the
    {"actor", "critic"} pair as one ActorCritic `.bin` (stage 3)."""

    def __init__(self, path: str, logger=None):
        self.path = path
        self.best = -np.inf
        self.logger = logger

    def maybe_save(self, metric: float, models) -> bool:
        # 'not (metric > best)': NaN from a diverged eval must never
        # overwrite the real best checkpoint ('NaN <= best' is False)
        if not (metric > self.best):
            return False
        self.best = float(metric)
        if self.path and isinstance(models, dict):
            checkpoints.save_actor_critic(self.path, models["actor"],
                                          models["critic"])
        elif self.path:
            checkpoints.save_model(self.path, models)
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
                     step: int, best: float, **counters) -> None:
    """The resumable `.state` payload (checkpoints.save_state): each named
    TrainState's model, optimizer and update count, the dropout generator's
    state, the step and the best watermark. The single-model trainers name
    their state "model"; PPO names "actor" and "critic" and adds its
    rollout counter."""
    checkpoints.save_state(
        path, {k: s.model for k, s in states.items()},
        {k: s.opt for k, s in states.items()}, generator, step=step,
        best=best, updates={k: s.step for k, s in states.items()},
        **counters)


def restore_train_state(state: TrainState, payload: dict,
                        name: str) -> TrainState:
    """Load the payload's model `name` (strict), its optimizer's moments and
    count and its update count into `state`, in place."""
    state.model.load_state_dict(payload["models"][name], strict=True)
    state.opt.load_state_dict(payload["optims"][name])
    state.step = int(payload["updates"][name])
    return state


def resume_fit_state(cfg: Config, state: TrainState,
                     generator: torch.Generator, steps_per_epoch: int,
                     logger=None):
    """--resume_path for the single-model trainers: the train state and the
    dropout generator restored in place, and where the data stream picks
    up. Returns (step, start_epoch, skip_batches, resume_best); an epoch
    past epochs_num makes the epoch range empty, so resuming a finished run
    is a no-op. A JAX package `.state` raises (checkpoints.load_state).

    The JAX package replays its threefry key stream past the completed
    steps (burn_keys); the port restores the generator's saved state, which
    is where the uninterrupted run's stream stands after those steps."""
    payload = checkpoints.load_state(cfg.resume_path)
    restore_train_state(state, payload, "model")
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
