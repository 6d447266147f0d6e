"""Stage 2 — the pairwise reward trainer, both families, on one GPU or one
rank per GPU under --dp/--tp
(counterpart of lr2ppo_tpu/train/reward.py; reference
finetune/reward_pair_dataloader.py and finetune/reward_trad.py).

One step runs both forwards of the SeqScoreModel, on the chosen and on the
rejected 4-index ordering of the item's pair, each in training mode with its
dropout seeds drawn from one CPU generator (chosen first), then the hinge
relu(margin - (s_chosen - s_rejected)) with the family's margin (1.0
multimodal, 0.01 tabular), and one AdamW step. The eval is pairwise
accuracy, the share of eval pairs with s_chosen > s_rejected. The best model
is saved as a reference-keyed `.bin`, which stage 3 loads strict into both
its critic and its frozen reward model.
The `.state` is written after the step's eval, as in stage 1
(train/pointwise.py).
"""

from __future__ import annotations

from itertools import islice
from typing import Optional

import numpy as np
import torch

from lr2ppo_torch.config import Config
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import SeqScoreModel
from lr2ppo_torch.ops.losses import reward_pair_hinge_loss
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.parallel.mesh import active, fetch_global
from lr2ppo_torch.train.common import (BestSaver, TrainState, apply_updates,
                                       device_ctx, init_state, logged_path,
                                       resume_fit_state, save_train_state)
from lr2ppo_torch.utils import (MetricLogger, TraceWindow, check_finite,
                                init_logger)

# the reference's hinge margin of each family: reward_pair_dataloader.py:
# 355-357 (multimodal), reward_trad.py:273 (tabular)
MARGINS = {"multimodal": 1.0, "tabular": 0.01}


def make_train_step(margin: float):
    """train_step(state, generator, text, img, chosen, reject) ->
    (loss, accuracy), detached; updates the state in place. The hinge needs
    no labels: they are in the chosen/rejected orderings."""

    def train_step(state: TrainState, generator, text, img, chosen, reject):
        cs = state.model(text, img, chosen, False, generator)
        rs = state.model(text, img, reject, False, generator)
        loss = reward_pair_hinge_loss(cs, rs, margin)
        loss.backward()
        apply_updates(state)
        return loss.detach(), (cs > rs).float().mean().detach()

    return train_step


@torch.inference_mode()
def evaluate_pairwise(model, eval_loader, put) -> float:
    """The share of eval pairs the model orders right, s_chosen > s_rejected.
    Wrap-padded rows of the last batch (`_valid` False) are not counted
    twice. Under dp `put` (DeviceCtx.put_eval) gives each rank its slice of
    the batch and the hits are all-gathered."""
    correct, total = 0.0, 0
    mesh = active()
    for batch in eval_loader:
        n = batch["tgts"].shape[0]
        valid = np.asarray(batch.get("_valid", np.ones(n, bool)))
        b = put({k: batch[k] for k in ("text", "img", "chosen_index",
                                       "reject_index") if k in batch})
        cs = model(b["text"], b.get("img"), b["chosen_index"])
        rs = model(b["text"], b.get("img"), b["reject_index"])
        hits = fetch_global(cs > rs, mesh)[:n][valid]
        correct += float(hits.sum())
        total += hits.size
    return correct / max(total, 1)


class RewardTrainer:
    """The stage-2 trainer on this rank's device (train/common.py:
    device_ctx): `device` defaults to the GPU (raising where there is
    none); the CPU tests pass "cpu"."""

    def __init__(self, cfg: Config, device=None):
        self.ctx = device_ctx(cfg, device, cfg.mesh.compute_dtype)
        self.device = self.ctx.device
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.mesh.compute_dtype)
        self.logger = init_logger(cfg.log_path, main=self.ctx.is_main)
        self.metrics = MetricLogger(logged_path(
            self.ctx, cfg.log_path + ".jsonl" if cfg.log_path else None))
        self.margin = MARGINS[cfg.model.family]

    def init_model(self, seed: int) -> SeqScoreModel:
        """The reward model from pretrained_model_path (strict) or seeded
        init, at full width, then placed on the mesh."""
        cfg = self.cfg
        model = SeqScoreModel(cfg.model, self.dtype, device=self.device)
        if cfg.pretrained_model_path:
            model.load_state_dict(
                checkpoints.load_any(cfg.pretrained_model_path), strict=True)
            self.logger.info(f"loaded {cfg.pretrained_model_path}")
        else:
            init_weights(model,
                         torch.Generator(device=self.device).manual_seed(seed))
        return self.ctx.place(model)

    def fit(self, train_loader, eval_loader,
            train_steps: Optional[int] = None):
        """Returns (train state, best eval accuracy)."""
        cfg = self.cfg
        self.ctx.check_loader(train_loader)
        steps_per_epoch = len(train_loader)
        total = train_steps or int(steps_per_epoch * cfg.epochs_num) + 1
        model = (self.ctx.place(SeqScoreModel(cfg.model, self.dtype,
                                              device=self.device))
                 if cfg.resume_path else self.init_model(cfg.seed))
        state = init_state(model, self.ctx.optimizer(cfg.optim, model, total))
        generator = torch.Generator().manual_seed(cfg.seed + 1)
        step, start_epoch, skip_batches, resume_best = 0, 1, 0, -np.inf
        if cfg.resume_path:
            step, start_epoch, skip_batches, resume_best = resume_fit_state(
                cfg, state, generator, steps_per_epoch, self.logger,
                self.ctx)
        train_step = make_train_step(self.margin)
        saver = BestSaver(cfg.output_model_path, self.logger, self.ctx,
                          cfg.ckpt_backend)
        saver.best = max(saver.best, resume_best)

        def save_state(step):
            # after the step's eval: the best it carries counts that eval
            if cfg.save_state_steps and step % cfg.save_state_steps == 0:
                save_train_state(cfg.output_model_path + ".state",
                                 {"model": state}, generator, step,
                                 saver.best, self.ctx, cfg.ckpt_backend)

        # steps 10-20 traced where --profile_dir is set, on rank 0 only
        trace = TraceWindow(cfg.profile_dir if self.ctx.is_main else None)
        last_eval_step = -1
        for epoch in range(start_epoch, cfg.epochs_num + 1):
            train_loader.set_epoch(epoch)
            it = iter(train_loader)
            if epoch == start_epoch and skip_batches:
                it = islice(it, skip_batches, None)
            for batch in it:
                b = self.ctx.put(batch)
                loss, acc = train_step(state, generator, b["text"],
                                       b.get("img"), b["chosen_index"],
                                       b["reject_index"])
                step += 1
                trace.tick(step)
                if step % cfg.report_steps == 0:
                    loss_v = check_finite(
                        float(self.ctx.mean(loss)), step,
                        checkpoint_hint=cfg.output_model_path)
                    acc_v = float(self.ctx.mean(acc))
                    self.logger.info(f"epoch {epoch} step {step} loss "
                                     f"{loss_v:.6f} acc {acc_v:.4f}")
                    val_acc = evaluate_pairwise(model, eval_loader,
                                                self.ctx.put_eval)
                    self.logger.info(f"val accuracy: {val_acc:.4f}")
                    self.metrics.log(step, loss=loss_v, acc=val_acc)
                    saver.maybe_save(val_acc, model)
                    last_eval_step = step
                save_state(step)
            # the epoch's last step may just have run the same eval
            if step != last_eval_step:
                val_acc = evaluate_pairwise(model, eval_loader,
                                            self.ctx.put_eval)
                self.logger.info(f"epoch {epoch} val accuracy: {val_acc:.4f}")
                saver.maybe_save(val_acc, model)
                save_state(step)      # with the epoch-end eval's best
        trace.close()
        self.trace_path = trace.path
        checkpoints.wait_for_async_saves()
        self.logger.info(f"Best Acc: {saver.best}")
        return state, saver.best
