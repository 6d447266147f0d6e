"""Stage 1 — the pointwise scorer trainers, both families, on one GPU or
one rank per GPU under --dp/--tp
(counterpart of lr2ppo_tpu/train/pointwise.py: make_train_step,
PointwiseTrainer, TwoDataTrainer and project_tsv; reference
finetune/pointwise.py, pointwise_trad.py, pointwise_2data_trad.py and
pointwise_2data_infer_trad.py).

One step: the ScoreModel forward in training mode (every dropout site draws
its seed from one CPU generator), SmoothL1 with beta 0.3 ('reg') or the
3-way NLL ('cls'), the backward and one AdamW step. The NDCG eval runs at
the report_steps cadence and at the end of each epoch; the best model is
saved as a reference-keyed `.bin`, which stage 3 loads strict as its actor.

With --save_state_steps N the `.state` is written every Nth step after that
step's eval, and again after the epoch-end eval where an epoch ends on such
a step, so the best it carries counts every eval before it (the JAX package
writes it before the step's eval, so its watermark can miss that eval).

TwoDataTrainer trains the tabular 2-data unification model on two LETOR
domains of other raw widths with alternating batches; project_tsv writes a
domain's rows through the trained projection, 768 wide.
"""

from __future__ import annotations

from itertools import islice
from typing import Optional

import numpy as np
import torch

from lr2ppo_torch.config import Config
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import ScoreModel, TwoDataScoreModel
from lr2ppo_torch.ops.losses import nll_3way_loss, smooth_l1_loss
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.common import (BestSaver, TrainState, apply_updates,
                                       device_ctx, init_state,
                                       logged_path, resume_fit_state,
                                       save_train_state)
from lr2ppo_torch.train.evaluate import evaluate_ndcg, format_ndcg
from lr2ppo_torch.utils import (MetricLogger, TraceWindow, check_finite,
                                init_logger)

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
    """The stage-1 trainer on this rank's device (train/common.py:
    device_ctx): `device` defaults to the GPU (raising where there is
    none); the CPU tests pass "cpu"."""

    model_cls = ScoreModel

    def __init__(self, cfg: Config, device=None):
        self.ctx = device_ctx(cfg, device, cfg.mesh.compute_dtype)
        self.device = self.ctx.device
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.mesh.compute_dtype)
        self.logger = init_logger(cfg.log_path, main=self.ctx.is_main)
        self.metrics = MetricLogger(logged_path(
            self.ctx, cfg.log_path + ".jsonl" if cfg.log_path else None))

    def init_model(self, seed: int) -> ScoreModel:
        """The scorer from pretrained_model_path (strict) or seeded init,
        at full width, then placed on the mesh."""
        cfg = self.cfg
        model = self.model_cls(cfg.model, self.dtype, device=self.device)
        if cfg.pretrained_model_path:
            model.load_state_dict(
                checkpoints.load_any(cfg.pretrained_model_path), strict=True)
            self.logger.info(f"loaded pretrained {cfg.pretrained_model_path}")
        else:
            init_weights(model,
                         torch.Generator(device=self.device).manual_seed(seed))
        return self.ctx.place(model)

    def _start(self, steps_per_epoch: int, train_steps: Optional[int]):
        """The train state, the dropout generator, the best saver and where
        the run starts: fresh, or from --resume_path (every parameter from
        the .state). Returns (state, generator, saver, step, start_epoch,
        skip_batches, save_state), where save_state(step) writes the
        `.state` on the --save_state_steps cadence."""
        cfg = self.cfg
        total = train_steps or int(steps_per_epoch * cfg.epochs_num) + 1
        model = (self.ctx.place(self.model_cls(cfg.model, self.dtype,
                                               device=self.device))
                 if cfg.resume_path else self.init_model(cfg.seed))
        state = init_state(model, self.ctx.optimizer(cfg.optim, model, total))
        generator = torch.Generator().manual_seed(cfg.seed + 1)
        step, start_epoch, skip_batches, resume_best = 0, 1, 0, -np.inf
        if cfg.resume_path:
            step, start_epoch, skip_batches, resume_best = resume_fit_state(
                cfg, state, generator, steps_per_epoch, self.logger,
                self.ctx)
        saver = BestSaver(cfg.output_model_path, self.logger, self.ctx,
                          cfg.ckpt_backend)
        saver.best = max(saver.best, resume_best)

        def save_state(step):
            if cfg.save_state_steps and step % cfg.save_state_steps == 0:
                save_train_state(cfg.output_model_path + ".state",
                                 {"model": state}, generator, step,
                                 saver.best, self.ctx, cfg.ckpt_backend)

        return (state, generator, saver, step, start_epoch, skip_batches,
                save_state)

    def fit(self, train_loader, eval_loader,
            train_steps: Optional[int] = None):
        """Returns (train state, best NDCG@full)."""
        cfg = self.cfg
        self.ctx.check_loader(train_loader)
        steps_per_epoch = len(train_loader)
        (state, generator, saver, step, start_epoch, skip_batches,
         save_state) = self._start(steps_per_epoch, train_steps)
        model = state.model
        train_step = make_train_step(cfg.model.mode)
        # steps 10-20 traced where --profile_dir is set, on rank 0 only
        trace = TraceWindow(cfg.profile_dir if self.ctx.is_main else None)
        self.logger.info(f"Start training: {steps_per_epoch} steps/epoch, "
                         f"{cfg.epochs_num} epochs")
        for epoch in range(start_epoch, cfg.epochs_num + 1):
            train_loader.set_epoch(epoch)
            it = iter(train_loader)
            if epoch == start_epoch and skip_batches:
                it = islice(it, skip_batches, None)
            for batch in it:
                b = self.ctx.put(batch)
                loss = train_step(state, generator, b["text"],
                                  b.get("img"), b["tgts"])
                step += 1
                trace.tick(step)
                if step % cfg.report_steps == 0:
                    loss_v = check_finite(
                        float(self.ctx.mean(loss)), step,
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
        trace.close()
        self.trace_path = trace.path
        checkpoints.wait_for_async_saves()
        self.logger.info(f"Best NDCG: {saver.best}")
        return state, saver.best

    def _evaluate(self, model, eval_loader, saver, label):
        result = evaluate_ndcg(model, eval_loader, put=self.ctx.put_eval)
        self.logger.info(label + format_ndcg(result))
        saver.maybe_save(result[NDCG_FULL], model)
        return result


class TwoDataTrainer(PointwiseTrainer):
    """Joint stage-1 training on two tabular domains with alternating
    batches (pointwise_2data_trad.py:492-534): the TwoDataScoreModel picks
    text_proj or text_proj3 by the batch's feature width. The eval, at the
    end of each epoch, is the mean NDCG@full over both domains."""

    model_cls = TwoDataScoreModel

    def fit_two(self, loaders, eval_loaders,
                train_steps: Optional[int] = None):
        """Round-robin over `loaders` (one batch of each in turn, a loader
        that runs out drops from the turn) for each epoch. Returns (train
        state, best mean NDCG@full).

        --save_state_steps and --resume_path as in fit: both loaders are
        deterministic in (seed, epoch), so a resume replays the round-robin
        draw order without training up to the saved step."""
        cfg = self.cfg
        for loader in loaders:
            self.ctx.check_loader(loader)
        steps_per_epoch = sum(len(l) for l in loaders)
        (state, generator, saver, step, start_epoch, skip_batches,
         save_state) = self._start(steps_per_epoch, train_steps)
        model = state.model
        train_step = make_train_step(cfg.model.mode)
        for epoch in range(start_epoch, cfg.epochs_num + 1):
            skip = skip_batches if epoch == start_epoch else 0
            for l in loaders:
                l.set_epoch(epoch)
            iters = [iter(l) for l in loaders]
            alive = list(range(len(iters)))
            while alive:
                for i in list(alive):
                    try:
                        batch = next(iters[i])
                    except StopIteration:
                        alive.remove(i)
                        continue
                    if skip > 0:       # fast-forward the alternating stream
                        skip -= 1
                        continue
                    b = self.ctx.put(batch)
                    loss = train_step(state, generator, b["text"], None,
                                      b["tgts"])
                    step += 1
                    if step % cfg.report_steps == 0:
                        loss_v = check_finite(
                            float(self.ctx.mean(loss)), step,
                            checkpoint_hint=cfg.output_model_path)
                        self.logger.info(
                            f"epoch {epoch} step {step} loss {loss_v:.6f}")
                        self.metrics.log(step, loss=loss_v)
                    save_state(step)
            metric = float(np.mean([
                evaluate_ndcg(model, ev, put=self.ctx.put_eval)[NDCG_FULL]
                for ev in eval_loaders]))
            self.logger.info(f"epoch {epoch} mean NDCG@full {metric:.4f}")
            self.metrics.log(step, ndcg_full=metric)
            saver.maybe_save(metric, model)
            save_state(step)          # with the epoch-end eval's best
        checkpoints.wait_for_async_saves()
        self.logger.info(f"Best NDCG: {saver.best}")
        return state, saver.best


@torch.inference_mode()
def project_tsv(cfg: Config, state_dict: dict, input_path: str,
                output_path: str, batch: int = 4096, device=None) -> None:
    """The feature projection exporter (pointwise_2data_infer_trad.py:
    428-446): every row of the tsv [label, qid, raw feats] (46 or 136 wide)
    through the 2-data model's projection for its width, in float32, as
    [label, qid, 768 floats] with %.9g. Rows go in batches of `batch`, the
    last padded with zeros to the same shape and trimmed, so every row is
    computed by the same kernels.

    Under a mesh (--dp/--tp, as the trainers take them) every rank projects
    every row, as every JAX process does, and rank 0 alone writes: at dp the
    file is world 1's byte for byte; at tp the model is split over tp
    (ctx.place), and the row-split fc2 sums its partial products over tp."""
    import os

    ctx = device_ctx(cfg, device)
    dev = ctx.device
    model = TwoDataScoreModel(cfg.model, device=dev)
    model.load_state_dict(state_dict, strict=True)
    ctx.place(model, fsdp=False)
    rows = np.loadtxt(input_path, delimiter="\t", dtype=np.float32, ndmin=2)
    head, feats = rows[:, :2], rows[:, 2:]
    outs = []
    for s in range(0, feats.shape[0], batch):
        chunk = feats[s: s + batch]
        n = chunk.shape[0]
        if n < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - n, chunk.shape[1]), np.float32)])
        out = model.project(torch.from_numpy(chunk).to(dev))
        outs.append(out[:n].float().cpu().numpy())
    if not ctx.is_main:
        return
    os.makedirs(os.path.dirname(os.path.abspath(output_path)) or ".",
                exist_ok=True)
    np.savetxt(output_path,
               np.concatenate([head, np.concatenate(outs, axis=0)], axis=1),
               delimiter="\t", fmt="%.9g")
