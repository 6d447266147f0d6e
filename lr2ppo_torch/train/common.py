"""Shared trainer plumbing on one device (counterpart of
lr2ppo_tpu/train/common.py): train state, host-to-device placement,
save-best."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from lr2ppo_torch.device import compute_dtype
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


class BestSaver:
    """Save-best contract (model_saver.py:4-11, ppo.py:910-915): the
    {"actor", "critic"} models are written as one reference-keyed
    ActorCritic `.bin` (checkpoints.save_actor_critic)."""

    def __init__(self, path: str, logger=None):
        self.path = path
        self.best = -np.inf
        self.logger = logger

    def maybe_save(self, metric: float, models: dict) -> bool:
        # 'not (metric > best)': NaN from a diverged eval must never
        # overwrite the real best checkpoint ('NaN <= best' is False)
        if not (metric > self.best):
            return False
        self.best = float(metric)
        if self.path:
            checkpoints.save_actor_critic(self.path, models["actor"],
                                          models["critic"])
        if self.logger:
            self.logger.info("Best val indicator until now!")
        return True


def peek_batch(loader):
    """First batch for shape probing / param init. Prefers the loader's
    synchronous first_batch() — abandoning a started prefetch iterator
    leaves workers racing the next iteration for the collate buffers."""
    fb = getattr(loader, "first_batch", None)
    return fb() if fb is not None else next(iter(loader))
