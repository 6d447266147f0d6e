"""Stage 1 — the pointwise scorer trainer on one GPU, multimodal family
(counterpart of lr2ppo_tpu/train/pointwise.py:make_train_step and
PointwiseTrainer; reference finetune/pointwise.py).

One step: the ScoreModel forward in training mode (every dropout site draws
its seed from one CPU generator), SmoothL1 with beta 0.3 ('reg') or the
3-way NLL ('cls'), the backward and one AdamW step. The NDCG eval runs at
the report_steps cadence and at the end of each epoch; the best model is
saved as a reference-keyed `.bin`, which stage 3 loads strict as its actor.

With --save_state_steps N the `.state` is written every Nth step after that
step's eval, and again after the epoch-end eval where an epoch ends on such
a step, so the best it carries counts every eval before it (the JAX package
writes it before the step's eval, so its watermark can miss that eval).

The tabular two-domain trainer (TwoDataTrainer, project_tsv) is not ported
(ROADMAP.md, queue A).
"""

from __future__ import annotations

from itertools import islice
from typing import Optional

import numpy as np
import torch

from lr2ppo_torch.config import Config
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import ScoreModel
from lr2ppo_torch.ops.losses import nll_3way_loss, smooth_l1_loss
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.common import (BestSaver, DeviceCtx, TrainState,
                                       apply_updates, check_single_device,
                                       init_state, resume_fit_state,
                                       save_train_state)
from lr2ppo_torch.train.evaluate import evaluate_ndcg, format_ndcg
from lr2ppo_torch.train.optim import build_optimizer
from lr2ppo_torch.utils import MetricLogger, check_finite, init_logger

NDCG_FULL = 100000000


def make_train_step(mode: str):
    """train_step(state, generator, text, img, tgts) -> the detached loss;
    updates the state in place."""

    def train_step(state: TrainState, generator, text, img, tgts):
        scores = state.model(text, img, False, generator)
        if mode == "reg":
            loss = smooth_l1_loss(scores, tgts, beta=0.3)
        else:
            loss = nll_3way_loss(scores, tgts)
        loss.backward()
        apply_updates(state)
        return loss.detach()

    return train_step


class PointwiseTrainer:
    """The stage-1 trainer on one device: `device` defaults to the GPU
    (raising where there is none); the CPU tests pass "cpu"."""

    def __init__(self, cfg: Config, device=None):
        self.device = check_single_device(cfg, device)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.mesh.compute_dtype)
        self.logger = init_logger(cfg.log_path)
        self.metrics = MetricLogger(
            cfg.log_path + ".jsonl" if cfg.log_path else None)
        self.ctx = DeviceCtx(self.device, cast_dtype=cfg.mesh.compute_dtype)

    def init_model(self, seed: int) -> ScoreModel:
        """The scorer from pretrained_model_path (strict) or seeded init."""
        cfg = self.cfg
        model = ScoreModel(cfg.model, self.dtype, device=self.device)
        if cfg.pretrained_model_path:
            model.load_state_dict(
                checkpoints.load_any(cfg.pretrained_model_path), strict=True)
            self.logger.info(f"loaded pretrained {cfg.pretrained_model_path}")
        else:
            init_weights(model,
                         torch.Generator(device=self.device).manual_seed(seed))
        return model

    def fit(self, train_loader, eval_loader,
            train_steps: Optional[int] = None):
        """Returns (train state, best NDCG@full)."""
        cfg = self.cfg
        steps_per_epoch = len(train_loader)
        total = train_steps or int(steps_per_epoch * cfg.epochs_num) + 1
        # on a resume every parameter comes from the .state
        model = (ScoreModel(cfg.model, self.dtype, device=self.device)
                 if cfg.resume_path else self.init_model(cfg.seed))
        state = init_state(model, build_optimizer(
            cfg.optim, dict(model.named_parameters()), total))
        generator = torch.Generator().manual_seed(cfg.seed + 1)
        step, start_epoch, skip_batches, resume_best = 0, 1, 0, -np.inf
        if cfg.resume_path:
            step, start_epoch, skip_batches, resume_best = resume_fit_state(
                cfg, state, generator, steps_per_epoch, self.logger)
        train_step = make_train_step(cfg.model.mode)
        saver = BestSaver(cfg.output_model_path, self.logger)
        saver.best = max(saver.best, resume_best)

        def save_state(step):
            if cfg.save_state_steps and step % cfg.save_state_steps == 0:
                save_train_state(cfg.output_model_path + ".state",
                                 {"model": state}, generator, step,
                                 saver.best)

        self.logger.info(f"Start training: {steps_per_epoch} steps/epoch, "
                         f"{cfg.epochs_num} epochs")
        for epoch in range(start_epoch, cfg.epochs_num + 1):
            train_loader.set_epoch(epoch)
            it = iter(train_loader)
            if epoch == start_epoch and skip_batches:
                it = islice(it, skip_batches, None)
            for batch in it:
                b = self.ctx.put(batch)
                loss = train_step(state, generator, b["text"], b["img"],
                                  b["tgts"])
                step += 1
                if step % cfg.report_steps == 0:
                    loss_v = check_finite(
                        float(loss), step,
                        checkpoint_hint=cfg.output_model_path)
                    self.logger.info(
                        f"epoch {epoch} step {step} loss {loss_v:.6f}")
                    if eval_loader is not None:
                        result = self._evaluate(model, eval_loader, saver,
                                                "NDCG:")
                        self.metrics.log(step, loss=loss_v,
                                         ndcg_full=result[NDCG_FULL])
                    else:
                        self.metrics.log(step, loss=loss_v)
                save_state(step)
            if eval_loader is not None:
                self._evaluate(model, eval_loader, saver,
                               f"epoch {epoch} NDCG:")
                save_state(step)      # with the epoch-end eval's best
        self.logger.info(f"Best NDCG: {saver.best}")
        return state, saver.best

    def _evaluate(self, model, eval_loader, saver, label):
        result = evaluate_ndcg(model, eval_loader, put=self.ctx.put)
        self.logger.info(label + format_ndcg(result))
        saver.maybe_save(result[NDCG_FULL], model)
        return result
