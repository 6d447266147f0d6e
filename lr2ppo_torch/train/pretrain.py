"""Tower pretraining on one GPU or one rank per GPU (counterpart of
lr2ppo_tpu/train/pretrain.py: make_pretrain_step_form in its simple,
pair_sp, pair_cls, bilm, seq2seq, vilt, clip and beit forms, and
PretrainTrainer).

One optimizer step takes `accum` micro-batches of the loader's batch, which
holds accum x micro rows: each micro-batch runs the tower's forward in
training mode (every dropout site draws its seed from one CPU generator) and
its backward, the gradients add up in `.grad`, are divided by accum, and one
optimizer step (AdamW, or Adafactor) follows. The step's loss is the mean of
the micro-batches' losses and its accuracy the summed correct count over the
summed denominators, as in the JAX step.

Every `report_steps` the loss, the accuracy and the tokens a second since the
last report are logged (and written to `<log_path>.jsonl`), and a better
accuracy saves the model to `<output_model_path>-best`; every
`save_checkpoint_steps` the resumable `.state` goes to
`<output_model_path>-<step>`; the last step's model goes to
`output_model_path`. The model checkpoints are reference-keyed `.bin` files
(embedding, encoder and target keys).

The batch forms map a processor's batch keys onto TowerModel's (src, tgt,
seg[, tgt_in, tgt_seg]) (form_args): simple (mlm, lm, cls, prefixlm, vit,
dalle), pair_sp (bert, albert: the mlm and sp targets), pair_cls (cls_mlm),
bilm, seq2seq (mt, t5, gsg, bart, s2t: the decoder's input and its
targets), vilt (a (text, image) source with the mlm and match targets), clip
(a dual tower's (text, image) pairs for the clr target, whose loss carries
its own count n) and beit (a (pixels, mask) source). A step's tokens are the
source's as in JAX, the text's where there is one (clip, vilt); where the
source is pixels (vit, beit), the tokens are seg's, [CLS] and the patches.
Under --dp/--tp
(train/common.py:device_ctx) each rank takes its slice of every micro-batch
(the loader shards per accumulation chunk), the masked means divide by the
global counts and the clr target gathers its features over dp
(towers/targets.py), and the vocabulary heads are split over tp; --zero1
and --fsdp shard the optimizer and the parameters over dp; --sp (with
--tp) splits the residual stream along the sequence over tp
(towers/encoders.py). Under --pp each rank holds one stage of the tower
(parallel/pipeline.py) and a micro-batch runs the GPipe schedule over
--pp_microbatches microbatches (0: pp); the checks are the JAX trainer's
(pretrain.py:158-175,270-285). Its `-best` and final checkpoints hold the
whole tower under the reference keys (rank 0 gathers the stages), and its
`.state` the whole model and optimizer, which a run at the same --pp
resumes.

A latent MoE tower (towers/model.py:LatentMoeConfig, Moonlight's DeepSeek-V3
block) adds its layers' balance loss to the target's loss, and each
optimizer step is followed by TowerModel.after_update, which moves the MoE
layers' correction biases by the load the step counted. It trains on one
process: --tp, --pp, --sp, --fsdp and a dp above 1 raise, naming the flag.
"""

from __future__ import annotations

import time
from itertools import islice
from typing import Optional

import numpy as np
import torch

from lr2ppo_torch.config import Config
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.parallel.mesh import active
from lr2ppo_torch.parallel.pipeline import (GPipe, check_pp_supported,
                                            keep_stage)
from lr2ppo_torch.towers.model import (LatentMoeConfig, TowerConfig,
                                       TowerModel, init_weights)
from lr2ppo_torch.towers.torch_import import load_tower_checkpoint
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.common import (BestSaver, TrainState, apply_updates,
                                       device_ctx, init_state, logged_path,
                                       peek_batch, resume_fit_state,
                                       save_models, save_train_state)
from lr2ppo_torch.utils import (MetricLogger, TraceWindow, check_finite,
                                init_logger, span)

def norm_target_out(out, rows: int):
    """(loss, correct, denom) from a target's output: mlm, lm and bilm give
    that triple, cls and sp (loss, correct) over `rows` (the global batch's
    rows), several targets {kind: tuple}, summed."""
    if isinstance(out, dict):
        parts = [norm_target_out(v, rows) for v in out.values()]
        return (sum(p[0] for p in parts), sum(p[1] for p in parts),
                sum(p[2] for p in parts))
    if len(out) == 2:
        return out[0], out[1], torch.tensor(float(rows),
                                            device=out[0].device)
    return out


def step_tokens(batch: dict) -> int:
    """A batch's tokens: its source's first two dims (the text's under
    clip and vilt), or seg's where the source is pixels (vit, beit)."""
    key = next(k for k in ("src_text", "src", "src_image") if k in batch)
    if batch[key].ndim == 4:
        key = "seg"
    return int(np.prod(batch[key].shape[:2]))


def form_args(form: str, mb: dict):
    """TowerModel.forward's positional arguments from a batch of `form`
    (lr2ppo_tpu/train/pretrain.py:form_args): (src, tgt, seg), tgt
    {kind: targets} for the composite targets and (forward, backward) for
    bilm; seq2seq adds the decoder's (tgt_in, tgt_seg); clip passes (text,
    image) pairs as src and seg; vilt a (text, image) src with the mlm and
    match (sp) targets; beit a (pixels, mask) src."""
    if form == "simple":
        return mb["src"], mb["tgt"], mb["seg"]
    if form == "pair_sp":
        return mb["src"], {"mlm": mb["tgt_mlm"], "sp": mb["tgt_sp"]}, mb["seg"]
    if form == "pair_cls":
        return (mb["src"], {"mlm": mb["tgt_mlm"], "cls": mb["tgt_cls"]},
                mb["seg"])
    if form == "bilm":
        return mb["src"], (mb["tgt_fwd"], mb["tgt_bwd"]), mb["seg"]
    if form == "seq2seq":
        return (mb["src"], mb["tgt_out"], mb["seg"], mb["tgt_in"],
                mb["tgt_seg"])
    if form == "vilt":
        return ((mb["src_text"], mb["src_image"]),
                {"mlm": mb["tgt_mlm"], "sp": mb["tgt_match"]}, mb["seg"])
    if form == "clip":
        return ((mb["src_text"], mb["src_image"]), mb["tgt"],
                (mb["seg_text"], mb["seg_image"]))
    if form == "beit":
        return ((mb["src_image"], mb["mask"]), mb["tgt"], mb["seg"])
    raise KeyError(f"unknown batch form: {form}")


def make_pretrain_step(accum: int = 1, pipe: Optional[GPipe] = None,
                       form: str = "simple"):
    """step(state, generator, batch) -> {"loss", "acc"} as detached
    tensors; `batch` holds device tensors of accum x micro rows of the
    batch `form` (form_args). The state is updated in place. Under pp
    (`pipe`, the JAX make_pretrain_step_pp) each micro-batch runs pipe's
    GPipe schedule, its dropout seeds keyed by one draw from the generator,
    and every stage returns the last stage's metrics."""
    from lr2ppo_torch.ops.hash_dropout import draw_seed

    def micro(model, generator, mb):
        if pipe is not None:
            return pipe.forward_backward(mb["src"], mb["tgt"], mb["seg"],
                                         draw_seed(generator))
        out = model(*form_args(form, mb), deterministic=False,
                    generator=generator)
        loss, correct, denom = norm_target_out(
            out, next(iter(mb.values())).shape[0] * active().dp)
        loss.backward()
        return loss.detach(), correct.detach(), denom.detach()

    def step(state: TrainState, generator: torch.Generator, batch: dict):
        model = state.model
        lsum = csum = dsum = 0.0
        for a in range(accum):
            mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[a]
                  for k, v in batch.items()}
            loss, correct, denom = micro(model, generator, mb)
            lsum, csum, dsum = lsum + loss, csum + correct, dsum + denom
        if accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        apply_updates(state)
        model.after_update()
        return {"loss": lsum / accum,
                "acc": csum / torch.clamp_min(torch.as_tensor(dsum), 1.0)}

    return step


def refuse_parallel(cfg: Config, tower_cfg: TowerConfig, dp: int) -> None:
    """The latent MoE tower trains on one process: raises naming the first
    parallel flag that is set (`dp`: the flag's, or the mesh's once --dp -1
    has taken the world)."""
    m = cfg.mesh
    for flag, on in (("--tp", m.tp > 1), ("--pp", m.pp > 1),
                     ("--sp", tower_cfg.seq_parallel), ("--fsdp", m.fsdp),
                     ("--dp", dp > 1)):
        if on:
            raise ValueError(f"{flag} is not supported by the latent MoE "
                             "tower, which trains on one process (expert "
                             "parallelism across processes is not built)")


class PretrainTrainer:
    """The tower pretrainer on this rank's device (train/common.py:
    device_ctx): `device` defaults to the GPU (raising where there is
    none); the CPU tests pass "cpu"."""

    def __init__(self, cfg: Config, tower_cfg: TowerConfig,
                 accumulation_steps: int = 1, device=None,
                 form: str = "simple"):
        latent = isinstance(tower_cfg, LatentMoeConfig)
        if latent:
            # before device_ctx, whose mesh would raise first at --tp, --pp
            # or --dp N without naming the flag
            refuse_parallel(cfg, tower_cfg, cfg.mesh.dp)
        self.pp = max(cfg.mesh.pp, 1)
        if self.pp > 1:
            check_pp_supported(tower_cfg, cfg.mesh)
            if form != "simple":
                raise ValueError(
                    f"--pp supports the 'simple' batch form "
                    f"(mlm/lm/cls/vit); got {form!r}")
        self.form = form
        self.pp_micro = cfg.mesh.pp_microbatches or self.pp
        self.ctx = device_ctx(cfg, device, allow_pp=True)
        if latent:                      # --dp -1 over a world of several
            refuse_parallel(cfg, tower_cfg, self.ctx.mesh.dp)
        self.device = self.ctx.device
        self.cfg, self.tower_cfg = cfg, tower_cfg
        self.accum = max(accumulation_steps, 1)
        dtype = compute_dtype(cfg.mesh.compute_dtype)
        self.dtype = None if dtype == torch.float32 else dtype
        self.logger = init_logger(cfg.log_path, main=self.ctx.is_main)
        self.metrics = MetricLogger(logged_path(
            self.ctx, cfg.log_path + ".jsonl" if cfg.log_path else None))

    def build_model(self) -> TowerModel:
        return TowerModel(self.tower_cfg, self.dtype, self.device,
                          with_target=True)

    def place(self, model: TowerModel) -> TowerModel:
        """A full-width model placed on the mesh: under pp cut to this
        rank's stage first."""
        if self.pp > 1:
            keep_stage(model, self.pp, self.ctx.mesh.pp_rank)
        return self.ctx.place(model)

    def init_model(self) -> TowerModel:
        """The tower with its target, from pretrained_model_path (a
        reference `.bin`, the port's checkpoint or a JAX package pickle;
        strict) or from seeded weights, at full width, then placed on the
        mesh."""
        model = self.build_model()
        path = self.cfg.pretrained_model_path
        if path:
            model.load_state_dict(load_tower_checkpoint(
                path, self.tower_cfg.channels_num,
                self.tower_cfg.kernel_size), strict=True)
            self.logger.info(f"loaded pretrained {path}")
        else:
            init_weights(model, torch.Generator(
                device=self.device).manual_seed(self.cfg.seed))
        return self.place(model)

    def fit(self, train_loader, total_steps: Optional[int] = None,
            save_checkpoint_steps: int = 0):
        """Returns (train state, best accuracy)."""
        cfg = self.cfg
        self.ctx.check_loader(train_loader)
        steps_per_epoch = len(train_loader)
        total = total_steps or steps_per_epoch * cfg.epochs_num
        # an explicit total_steps is the budget: cycle epochs to reach it
        epochs = cfg.epochs_num
        if total_steps:
            epochs = max(epochs, -(-total_steps // max(steps_per_epoch, 1)))
        first = peek_batch(train_loader)
        rows = next(v for k, v in first.items()
                    if not k.startswith("_")).shape[0]
        if rows % self.accum:
            raise ValueError(f"batch_size {rows} must be divisible by "
                             f"accumulation_steps {self.accum}")
        if self.pp > 1:
            # `rows` is this rank's share: the global micro-batch is dp x
            # larger
            dp, m = self.ctx.mesh.dp, self.pp_micro
            global_micro = rows // self.accum * dp
            if global_micro % m or (global_micro // m) % dp:
                raise ValueError(
                    f"micro-batch {global_micro} must split into "
                    f"--pp_microbatches={m} pipeline microbatches each "
                    f"divisible by dp={dp}")
        model = (self.place(self.build_model()) if cfg.resume_path
                 else self.init_model())
        state = init_state(model, self.ctx.optimizer(cfg.optim, model, total))
        generator = torch.Generator().manual_seed(cfg.seed + 1)
        step, start_epoch, skip_batches, resume_best = 0, 1, 0, -np.inf
        if cfg.resume_path:
            step, start_epoch, skip_batches, resume_best = resume_fit_state(
                cfg, state, generator, steps_per_epoch, self.logger,
                self.ctx)
        self.pipe = (GPipe(model, self.ctx.mesh, self.pp_micro, self.dtype,
                           self.device) if self.pp > 1 else None)
        # the step of this fit, for a caller that times one more
        self.step_fn = step_fn = make_pretrain_step(self.accum, self.pipe,
                                                    self.form)
        saver = BestSaver(cfg.output_model_path + "-best"
                          if cfg.output_model_path else "", self.logger,
                          self.ctx, cfg.ckpt_backend)
        saver.best = max(saver.best, resume_best)
        # steps 10-20 traced where --profile_dir is set, on rank 0 only
        trace = TraceWindow(cfg.profile_dir if self.ctx.is_main else None)
        tokens_since, t_last = 0, time.perf_counter()
        for epoch in range(start_epoch, epochs + 1):
            if step >= total:
                break
            train_loader.set_epoch(epoch)
            batch_iter = iter(train_loader)
            if epoch == start_epoch and skip_batches:
                batch_iter = islice(batch_iter, skip_batches, None)
            for batch in batch_iter:
                with span("pretrain.step"):
                    dev_batch = self.ctx.put({k: v for k, v in batch.items()
                                              if not k.startswith("_")})
                    with span("pretrain.update"):
                        m = step_fn(state, generator, dev_batch)
                    step += 1
                    trace.tick(step)
                    tokens_since += step_tokens(batch) * self.ctx.mesh.dp
                    if step % cfg.report_steps == 0:
                        with span("pretrain.report"):
                            self._report(m, step, total, saver, model,
                                         tokens_since, t_last)
                        tokens_since, t_last = 0, time.perf_counter()
                    if (save_checkpoint_steps
                            and step % save_checkpoint_steps == 0):
                        with span("pretrain.save"):
                            save_train_state(
                                f"{cfg.output_model_path}-{step}",
                                {"model": state}, generator, step,
                                saver.best, self.ctx, cfg.ckpt_backend)
                if step >= total:
                    break
        trace.close()
        self.trace_path = trace.path
        if cfg.output_model_path:
            with span("pretrain.save"):
                save_models(cfg.output_model_path, model, self.ctx,
                            cfg.ckpt_backend)
        checkpoints.wait_for_async_saves()
        return state, saver.best

    def _report(self, m: dict, step: int, total: int, saver, model,
                tokens_since: int, t_last: float) -> None:
        """Logs the step's loss, accuracy (the loss checked finite) and
        tokens/s since `t_last`, and saves the best model by accuracy."""
        cfg = self.cfg
        # a masked mean is global already; a cls or sp mean is this rank's,
        # and equal shards average to the global one
        loss = check_finite(
            float(self.ctx.mean(m["loss"])), step,
            checkpoint_hint=(cfg.output_model_path + "-best"
                             if cfg.output_model_path else None))
        acc = float(m["acc"])
        tps = tokens_since / max(time.perf_counter() - t_last, 1e-9)
        self.logger.info(f"step {step}/{total} loss {loss:.4f} "
                         f"acc {acc:.4f} | {tps:,.0f} tokens/s")
        self.metrics.log(step, loss=loss, acc=acc, tokens_s=tps)
        saver.maybe_save(acc, model)
