"""Stage 3 — the LR2PPO actor-critic trainer, both families, on one GPU or
one rank per GPU under --dp/--tp
(counterpart of lr2ppo_tpu/train/ppo.py; reference finetune/ppo.py and
finetune/ppo_trad.py, whose batches carry no images).

The recipe (ppo.py:815-915): per batch of 2-tag pairs,

  rollout  — the actor scores the pair, the critic values the current
             state (tag order), the pair is re-ranked by score (the
             'action'), next_state = [0,1] ++ permuted order, the FROZEN
             stage-2 reward model scores next_state; the memory is stored;
  update   — every update_timesteps memories: for each memory recompute
             actor scores and critic value, the KL(old||new) penalty
             shifts the reward, the one-step advantage is reward - old
             value (or GAE), the policy loss is RankLoss(margin 0.01 over
             the demanded order, flipped when the advantage < -0.1) *
             |advantage| - entropy_w * H, the critic loss the PPO-clipped
             value loss; two AdamW steps; the schedulers tick once per
             sweep (ppo.py:612-613).

The rollout runs under torch.inference_mode(). Memories keep the batch on
the device when a sweep's batches fit under ppo.device_memory_gb, else on
the host. Under ppo.rollout_int8 the rollout's actor (and with '1' the
critic) are int8 twins requantized from the live params once per sweep;
their FFNs run through the fused int8 kernel (ops/int8_mlp.py) where the
site is compute-bound, as at the multimodal batch 256; the tabular sites
(one token a document) are not, and dequantize as in JAX.
"""

from __future__ import annotations

import dataclasses
from itertools import islice
from typing import List, Optional

import numpy as np
import torch

from lr2ppo_torch.config import Config, rollout_int8_mode
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
from lr2ppo_torch.ops.int8 import quantize_state_dict
from lr2ppo_torch.ops.losses import (categorical_entropy, categorical_kl,
                                     clipped_value_loss, cls_expected_scores,
                                     gae_advantages, pl_log_prob,
                                     rank_hinge_loss)
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.common import (BestSaver, TrainState, apply_updates,
                                       device_ctx, init_state, logged_path,
                                       peek_batch, restore_train_state,
                                       save_train_state)
from lr2ppo_torch.train.evaluate import evaluate_ndcg, format_ndcg
from lr2ppo_torch.utils import (MetricLogger, TraceWindow, check_finite,
                                init_logger, span)

def frozen_copy(cls, mcfg, state: dict, dtype, int8: bool, ctx=None):
    """A frozen inference model of `cls` holding the full-width `state` (on
    the state's device): quantized to int8 once (int8 weights with float32
    scales, every other float at `dtype`), or every float cast to `dtype`.
    The module is built without storage and takes copies of the tensors:
    the source may be a model that goes on training. With `ctx` it is then
    split over tp (never stored sharded over dp): the kernels are quantized
    from the full weights before they are sliced."""
    state = {k: v.detach().clone() for k, v in state.items()}
    if int8:
        state = quantize_state_dict(state, dtype)
    else:
        state = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in state.items()}
    model = cls(dataclasses.replace(mcfg, int8=int8), dtype, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    if ctx is not None:
        ctx.place(model, fsdp=False)
    return model.eval().requires_grad_(False)


def make_rollout_step(mode: str):
    """rollout_step(actor, critic, reward, text, img, state) ->
    (scores, value, next_state, rewards), all without autograd."""

    @torch.inference_mode()
    def rollout_step(actor, critic, reward, text, img, state):
        logits = actor(text, img)
        scores = cls_expected_scores(logits) if mode == "cls" else logits
        value = critic(text, img, state)
        order = torch.argsort(-scores, dim=-1, stable=True)   # descending
        permuted = torch.gather(state, 1, order)
        prefix = torch.arange(2, dtype=state.dtype, device=state.device)
        next_state = torch.cat(
            [prefix[None].expand(scores.shape[0], 2), permuted], dim=1)
        rew = reward(text, img, next_state)
        return scores, value, next_state, rew

    return rollout_step


def make_update_step(cfg: Config):
    """update_step(astate, cstate, generator, text, img, state, next_state,
    old_scores, rewards, old_value[, gae_adv, gae_ret]) -> metrics, a dict
    of detached 0-d device tensors. Trains the actor, then the critic, each
    with its own AdamW step; every dropout site draws its seed from
    `generator`, actor sites first."""
    mode, ppo = cfg.model.mode, cfg.ppo

    def update_step(astate: TrainState, cstate: TrainState, generator,
                    text, img, state, next_state, old_scores, rewards,
                    old_value, gae_adv=None, gae_ret=None) -> dict:
        logits = astate.model(text, img, False, generator)
        scores = cls_expected_scores(logits) if mode == "cls" else logits
        kl = categorical_kl(old_scores, scores)                # (B,)
        entropy = categorical_entropy(scores)                  # (B,)
        rew = rewards - ppo.kl_div_loss_weight * kl            # (B,)
        if ppo.use_gae:
            adv = gae_adv - ppo.kl_div_loss_weight * kl
        else:
            adv = rew - old_value                              # one-step
        tail = next_state[:, -2:]
        flip = adv < ppo.advantage_eps
        rank_states = torch.where(flip[:, None], tail.flip(1), tail)
        rank_loss = rank_hinge_loss(scores, rank_states, ppo.rank_margin)
        policy = rank_loss * torch.abs(adv) - ppo.entropy_weight * entropy
        if ppo.surrogate_clip:
            ratio = torch.exp(pl_log_prob(scores, tail)
                              - pl_log_prob(old_scores, tail))
            a = adv.detach()
            policy = policy - torch.minimum(
                ratio * a,
                torch.clamp(ratio, 1.0 - ppo.eps_clip, 1.0 + ppo.eps_clip)
                * a)
        ploss = policy.mean()
        ploss.backward()
        apply_updates(astate)

        # GAE mode regresses the critic on the window returns instead of
        # the KL-shifted one-step reward
        vtarget = gae_ret if ppo.use_gae else rew.detach()
        value = cstate.model(text, img, state, False, generator)
        vloss = clipped_value_loss(value, vtarget, old_value, ppo.value_clip)
        vloss.backward()
        apply_updates(cstate)

        metrics = {
            "policy_loss": ploss, "value_loss": vloss,
            "old_value": old_value.mean(), "value": value.mean(),
            "rewards_ori": rewards.mean(), "kl": kl.mean(),
            "entropy": entropy.mean(), "rewards": rew.mean(),
            "advantages": adv.mean(), "rank_loss": rank_loss,
        }
        return {k: v.detach().float() for k, v in metrics.items()}

    return update_step


class PPOTrainer:
    """The stage-3 trainer on this rank's device (train/common.py:
    device_ctx): `device` defaults to the GPU (raising where there is
    none); the CPU tests pass "cpu". Under dp each rank rolls out and
    updates on its slice of every batch; the frozen reward model and the
    int8 rollout twins are split over tp like the live models, and are not
    wrapped for gradients."""

    def __init__(self, cfg: Config, device=None):
        self.ctx = device_ctx(cfg, device, cfg.mesh.compute_dtype)
        self.device = self.ctx.device
        self.dtype = compute_dtype(cfg.mesh.compute_dtype)
        self.cfg = cfg
        self.logger = init_logger(cfg.log_path, main=self.ctx.is_main)
        self.metrics = MetricLogger(logged_path(
            self.ctx, cfg.log_path + ".jsonl" if cfg.log_path else None))
        # ppo.rollout_int8: '1' = int8 twins of actor and critic for the
        # rollout, 'actor' = the actor's only, '0' = none
        self.ri8 = rollout_int8_mode(cfg.ppo.rollout_int8)

    # -- parameter loading (key contract: ppo.py:769-771) ---------------
    def init_params(self, seed: int):
        """(actor, critic, reward) modules on the device: the actor from
        pretrained_model_path or seeded init; critic and reward from
        reward_model_path or seeded init, all at full width, then placed
        on the mesh. The reward model is frozen and stored at the compute
        dtype, int8 under ppo.reward_int8."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        actor = ScoreModel(cfg.model, self.dtype, device=dev)
        critic = SeqScoreModel(cfg.model, self.dtype, device=dev)
        if cfg.pretrained_model_path:
            state = checkpoints.load_any(cfg.pretrained_model_path)
            actor.load_state_dict(state, strict=True)
        else:
            init_weights(actor, gen)
        if cfg.reward_model_path:
            # the stage-2 checkpoint initializes BOTH critic and reward
            critic.load_state_dict(
                checkpoints.load_any(cfg.reward_model_path), strict=True)
            reward_state = critic.state_dict()
        else:
            init_weights(critic, gen)
            reward_model = SeqScoreModel(cfg.model, self.dtype, device=dev)
            init_weights(reward_model, gen)
            reward_state = reward_model.state_dict()
        reward = frozen_copy(SeqScoreModel, cfg.model, reward_state,
                             self.dtype, cfg.ppo.reward_int8, self.ctx)
        return self.ctx.place(actor), self.ctx.place(critic), reward

    def fit(self, make_train_loader, eval_loader,
            train_steps: Optional[int] = None):
        """make_train_loader(epoch) -> Loader (the trainset is rebuilt per
        epoch for fresh pair sampling, ppo.py:816). Returns (actor state,
        critic state, best NDCG@full).

        With --save_state_steps N, every Nth sweep writes
        <output_model_path>.state at the next batch boundary with an empty
        memory buffer; --resume_path restores both train states, the sweep
        and rollout counters, the best watermark and the dropout generator,
        and skips the batches already rolled out. The reward model is
        rebuilt from reward_model_path (or the seed), and the int8 rollout
        twins from the restored parameters."""
        cfg = self.cfg
        upd = cfg.ppo.update_timesteps
        if cfg.ppo.use_gae and upd % max(cfg.ppo.max_timesteps, 1) != 0:
            # GAE bootstraps V=0 at the sweep-window edge; a window that
            # cuts a trajectory mid-way would bias its tail advantages
            raise ValueError(
                f"ppo.use_gae requires update_timesteps ({upd}) to be a "
                f"multiple of max_timesteps ({cfg.ppo.max_timesteps}): a "
                f"sweep window that cuts a trajectory mid-way would "
                f"bootstrap GAE with V=0 inside the trajectory")
        loader0 = make_train_loader(1)
        self.ctx.check_loader(loader0)
        steps_per_epoch = len(loader0)
        total = train_steps or int(steps_per_epoch * cfg.epochs_num) + 1
        self._check_geometry(peek_batch(loader0))

        actor, critic, reward = self.init_params(cfg.seed)

        # schedulers tick once per sweep (ppo.py:612-613)
        def mk(model, base_lr):
            return self.ctx.optimizer(cfg.optim, model, total, lr=base_lr,
                                      schedule_wrap=lambda s: (
                                          lambda t: s(t // upd)))
        astate = init_state(actor, mk(actor, cfg.optim.learning_rate))
        cstate = init_state(critic, mk(critic,
                                       cfg.optim.critic_learning_rate))

        rollout_step = make_rollout_step(cfg.model.mode)
        update_step = make_update_step(cfg)
        # rollout_int8: int8 twins of the live params, rebuilt lazily after
        # every sweep (the only place params change); dropped before the
        # sweep so their memory frees first
        twins: dict = {}

        def rollout_models():
            if self.ri8 == "0":
                return actor, critic
            if not twins:
                full = self.ctx.full_state_dict
                with span("ppo.requantize"):
                    twins["actor"] = frozen_copy(ScoreModel, cfg.model,
                                                 full(actor), self.dtype,
                                                 True, self.ctx)
                    if self.ri8 == "1":
                        twins["critic"] = frozen_copy(
                            SeqScoreModel, cfg.model, full(critic),
                            self.dtype, True, self.ctx)
            return twins["actor"], twins.get("critic", critic)

        generator = torch.Generator().manual_seed(cfg.seed + 2)
        time_ctr, step = 0, 0
        start_epoch, skip_batches, resume_best = 1, 0, -np.inf
        if cfg.resume_path:
            payload = checkpoints.load_state(cfg.resume_path)
            restore_train_state(astate, payload, "actor", self.ctx)
            restore_train_state(cstate, payload, "critic", self.ctx)
            generator.set_state(payload["generator"])
            step, time_ctr = int(payload["step"]), int(payload["time_ctr"])
            resume_best = float(payload["best"])
            consumed = time_ctr // max(cfg.ppo.max_timesteps, 1)
            # past the last epoch: the resume is a no-op (empty range)
            start_epoch = consumed // steps_per_epoch + 1
            skip_batches = consumed % steps_per_epoch
            self.logger.info(
                f"resumed PPO from {cfg.resume_path} @ sweep {step} "
                f"(epoch {start_epoch}, skipping {skip_batches} batches)")
        saver = BestSaver(cfg.output_model_path, self.logger, self.ctx,
                          cfg.ckpt_backend)
        saver.best = max(saver.best, resume_best)

        def save_state():
            with span("ppo.save"):
                save_train_state(cfg.output_model_path + ".state",
                                 {"actor": astate, "critic": cstate},
                                 generator, step, saver.best, self.ctx,
                                 cfg.ckpt_backend, time_ctr=time_ctr)

        memories: List[dict] = []
        pending_save = False
        # sweeps 10-20 traced where --profile_dir is set, on rank 0 only
        trace = TraceWindow(cfg.profile_dir if self.ctx.is_main else None)
        self.logger.info(
            f"Start PPO: {steps_per_epoch} rollout steps/epoch, "
            f"update every {upd}")

        device_memories: Optional[bool] = None
        for epoch in range(start_epoch, cfg.epochs_num + 1):
            loader = make_train_loader(epoch)
            loader.set_epoch(epoch)
            # recycled-buffer loaders invalidate a batch after a few
            # yields; anything retained across the sweep must be copied
            must_copy = (getattr(loader, "shared_slots", False)
                         or getattr(loader, "reuse_buffers", False))
            batch_iter = iter(loader)
            if epoch == start_epoch and skip_batches:
                batch_iter = islice(batch_iter, skip_batches, None)
            for batch in batch_iter:
                with span("ppo.step"):
                    if device_memories is None:
                        device_memories = self._memory_policy(batch)
                    if (device_memories and must_copy
                            and self.device.type == "cpu"):
                        # on the CPU the device tensors alias the loader's
                        # recycled host buffers: copy first
                        batch = {k: np.array(v) for k, v in batch.items()}
                    b = self.ctx.put(batch)
                    if not device_memories:
                        # ONE retained host copy per batch, shared by all of
                        # its timesteps' memories
                        host_batch = ({k: np.array(v)
                                       for k, v in batch.items()}
                                      if must_copy else batch)
                    bsz, tags = batch["tgts"].shape
                    state = self.ctx.put_array(np.broadcast_to(
                        np.arange(tags, dtype=np.int32), (bsz, tags)).copy())
                    for _t in range(cfg.ppo.max_timesteps):
                        ra, rc = rollout_models()
                        with span("ppo.rollout"):
                            scores, value, next_state, rew = rollout_step(
                                ra, rc, reward, b["text"], b.get("img"),
                                state)
                        dev = (b["text"], b.get("img"), state, next_state,
                               scores, rew, value)
                        if device_memories:
                            memories.append({"dev": dev, "t": _t})
                        else:
                            memories.append({
                                "batch": host_batch,
                                "small": [v.cpu() for v in dev[2:]],
                                "t": _t})
                        state = next_state
                        time_ctr += 1
                        if time_ctr % upd == 0:
                            if _t == cfg.ppo.max_timesteps - 1:
                                b = dev = None
                            twins.clear()         # params change: requantize
                            agg = self._sweep(update_step, astate, cstate,
                                              generator, memories)
                            memories = []
                            step += 1
                            trace.tick(step)
                            if (cfg.save_state_steps
                                    and step % cfg.save_state_steps == 0):
                                # saved at a batch boundary with an empty
                                # memory buffer, so the counters describe a
                                # clean resume point
                                pending_save = True
                            check_finite(agg["policy_loss"], step,
                                         "policy_loss", cfg.output_model_path)
                            check_finite(agg["value_loss"], step,
                                         "value_loss", cfg.output_model_path)
                            self.logger.info(f"Training step: {step}")
                            for k, v in agg.items():
                                self.logger.info(f"{k}: {v:.6f}")
                            if (cfg.eval_steps <= 0
                                    or step % cfg.eval_steps == 0):
                                self._evaluate(step, actor, critic,
                                               eval_loader, saver, agg, "Val")
                            else:
                                self.metrics.log(step, **agg)
                    if pending_save and not memories:
                        save_state()
                        pending_save = False
        improved = False
        try:
            if (cfg.eval_steps > 0 and step > 0
                    and step % cfg.eval_steps != 0):
                # a decoupled eval cadence still scores and saves the
                # end-of-run model, unless the last sweep evaluated these
                # exact params; before the .state flush below, so a best
                # found here reaches the resume state
                improved = self._evaluate(step, actor, critic, eval_loader,
                                          saver, {}, "Final val")
        finally:
            # a run that ended off a clean batch boundary, or whose final
            # eval raised the best, flushes its .state (a stale lower best
            # would let a resumed run overwrite the best .bin with worse
            # params); only where .state files are kept at all
            if pending_save or (improved and cfg.save_state_steps):
                save_state()
        trace.close()
        self.trace_path = trace.path
        checkpoints.wait_for_async_saves()
        self.logger.info(f"Best NDCG: {saver.best}")
        return astate, cstate, saver.best

    def _evaluate(self, step, actor, critic, eval_loader, saver, agg,
                  label):
        with span("ppo.eval"):
            result = evaluate_ndcg(actor, eval_loader, put=self.ctx.put_eval)
            self.logger.info(f"{label} NDCG:" + format_ndcg(result))
            self.metrics.log(step, ndcg_full=result[100000000], **agg)
            with span("ppo.save"):
                return saver.maybe_save(result[100000000],
                                        {"actor": actor, "critic": critic})

    def _check_geometry(self, batch) -> None:
        """The loader's batches must have the model's widths: (B, T, S, D)
        text and (B, I, D) images (multimodal), or (B, T, D) text and no
        images (tabular)."""
        m = self.cfg.model
        if m.family == "tabular":
            if "img" in batch:
                raise ValueError("a tabular batch carries no 'img'")
            want = {"text": ("B", "T", m.feat_size)}
        else:
            want = {"text": ("B", "T", m.seq_length, m.feat_size),
                    "img": ("B", m.max_imgs, m.feat_size)}
        for k, dims in want.items():
            got = tuple(np.asarray(batch[k]).shape)
            tail = tuple(d for d in dims if isinstance(d, int))
            if len(got) != len(dims) or got[len(got) - len(tail):] != tail:
                raise ValueError(f"batch {k!r} is {got}; the model takes "
                                 f"{dims}")

    def _memory_policy(self, batch) -> bool:
        """Keep the memory buffer's batches on the device when a sweep's
        worth fits under ppo.device_memory_gb: the sweep then re-uploads
        nothing (the reference also kept memories on the GPU,
        ppo.py:882-883). A sweep holds upd/max_timesteps DISTINCT batches
        (a batch's timesteps share its tensors), at the compute dtype."""
        cfg = self.cfg
        upd = cfg.ppo.update_timesteps
        itemsize = torch.tensor([], dtype=self.dtype).element_size()
        per = sum(np.asarray(v).size * itemsize
                  if np.issubdtype(np.asarray(v).dtype, np.floating)
                  or np.asarray(v).dtype.name == "bfloat16"
                  else np.asarray(v).nbytes for v in batch.values())
        mt = max(cfg.ppo.max_timesteps, 1)
        # worst case: the window starts at a batch's LAST timestep
        distinct = (upd // mt if upd % mt == 0
                    else (upd + mt - 2) // mt + 1)
        projected = per * distinct / 1e9
        on_device = projected <= cfg.ppo.device_memory_gb
        self.logger.info(
            f"PPO memories: {'device' if on_device else 'host'}-resident "
            f"(~{projected:.2f} GB / sweep)")
        if not on_device and projected > 8.0:
            self.logger.warning(
                f"PPO memory buffer will hold ~{projected:.1f} GB of host "
                f"batches ({per / 1e6:.0f} MB x {distinct}); consider a "
                f"bf16 loader dtype, smaller batch_size, or smaller "
                f"update_timesteps")
        return on_device

    def _sweep(self, update_step, astate, cstate, generator, memories):
        """One PPO update sweep over the collected memories. Metrics
        accumulate on the device and are fetched once at the end."""
        def put(mem):
            if "dev" in mem:          # device-resident: nothing to move
                return mem["dev"]
            b = self.ctx.put({k: mem["batch"][k] for k in ("text", "img")
                              if k in mem["batch"]})
            return (b["text"], b.get("img"),
                    *(v.to(self.device) for v in mem["small"]))

        with span("ppo.sweep"):
            gae_kw = [{} for _ in memories]
            if self.cfg.ppo.use_gae and memories:
                g = self.cfg.ppo
                pairs = [(m["dev"][5], m["dev"][6]) if "dev" in m
                         else (m["small"][3].to(self.device),
                               m["small"][4].to(self.device))
                         for m in memories]
                ts = [m["t"] for m in memories]
                cont = torch.zeros(len(memories), device=self.device)
                for i in range(len(memories) - 1):
                    # memory i+1 continues i's trajectory iff it is the next
                    # timestep of the SAME batch
                    cont[i] = 1.0 if ts[i + 1] == ts[i] + 1 else 0.0
                adv_all, ret_all = gae_advantages(
                    torch.stack([p[0] for p in pairs]).float(),
                    torch.stack([p[1] for p in pairs]).float(), cont,
                    g.gae_gamma, g.gae_lambda)
                gae_kw = [{"gae_adv": adv_all[i], "gae_ret": ret_all[i]}
                          for i in range(len(memories))]

            agg = None
            for i, mem in enumerate(memories):
                arrays = put(mem)
                with span("ppo.update"):
                    metrics = update_step(astate, cstate, generator, *arrays,
                                          **gae_kw[i])
                agg = metrics if agg is None else {k: agg[k] + v
                                                   for k, v in metrics.items()}
            if agg is None:
                return {}
            n = len(memories)
            # the means over the global batch: each rank's over its equal
            # shard, averaged over dp
            with span("ppo.fetch"):
                host = self.ctx.mean(
                    torch.stack(list(agg.values()))).cpu().tolist()
            return {k: v / n for k, v in zip(agg, host)}
