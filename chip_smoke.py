#!/usr/bin/env python3
"""Check the PyTorch port once on one CUDA card: the ranking service, the
three-stage LR2PPO recipe of both families, feature extraction, tower
pretraining (the transformer, seq2seq, recurrent, gated-CNN and dual towers,
and the image and speech towers) and multi-GPU training at full width. The
port's speed is the benchmark's to measure (BENCHMARK.json, perfbench/);
this script times only its kernels, for the `kernels` line.

    python3 chip_smoke.py [--seed N] [--parallel_only | --pipeline_only |
                           --processors_only | --seq2seq_only |
                           --encoders_only | --vision_speech_only |
                           --checkpoints_only | --adamw_only |
                           --mla_only]

Phases, each of which raises on failure (exit code other than 0); there is
no phase 5, and the others keep their numbers:
  1. device: torch and CUDA versions, the card's name and power limit;
  2. build: compile the CUDA kernels from lr2ppo_torch/kernels/csrc, one
     nvcc per source, all at once, with ptxas' registers and spills;
  3. the fused int8 FFN kernel against its plain PyTorch version, bit for
     bit, at a ragged row count, at D 512 / H 4096 in float32, at the serve
     shape (200,704 rows, D 768, H 3072) in float32 and bfloat16, and at the
     rollout's 100,352 rows in bfloat16, with the times from CUDA events
     beside the bound and the share of it reached;
  4. the serving path: the flagship-width int8 ScoreModel (seeded weights,
     saved as a reference `.bin` and loaded back), served over synthetic
     EvalLoader batches through lr2ppo_torch.cli.serve.serve_batches; the
     kernel's launch count, the rankings' schema and the int8 scores
     against the same weights served in bfloat16 are checked;
  6. both dropout kernels (hash, Philox) against their plain versions at a
     ragged size and at the update's FFN-inner site (100,352 x 3072),
     float32 and bfloat16, forward and backward, bit for bit, with times
     beside torch.nn.functional.dropout's; hash dropout also at a split
     place whose ragged rows straddle its ring's chunks, at a size that
     wraps the ring several times (the ragged size takes its register
     path, the larger ones its bulk-copy ring);
  7. the training path: PPOTrainer.fit under --profile fast at batch 256
     (4 rollouts, 4 updates, one eval, one best save reloaded strict), its
     kernel launches, losses and moved parameters checked;
  8. the TPU-dropout configuration (pallas_dropout on, hash off): two
     update steps at batch 256, with 2 forward and 2 backward launches of
     the Philox kernel each and finite losses;
  9. the tower attention kernel against its plain version at a ragged
     (3, 5, 77, 64), a long (2, 12, 514, 64), a dh-128 (2, 4, 130, 128), the
     short path's last and the long path's first length (4, 12, 256 and
     257, 64), the text (32, 12, 196, 64) and the image (32, 12, 197, 64)
     shape, float32 and bfloat16, with padded keys, and the path each shape
     took (short for S <= 256); at the two tower shapes its time beside the
     plain version's, F.scaled_dot_product_attention's and the bound;
 10. the feature-extraction path at full width: XLM-R base and ViT-B/16
     (seeded weights saved as reference `.bin` files and loaded back
     strict, pallas_attention on, float32), a synthetic Unigram vocabulary,
     8 items of 5-20 tags and 16 frames of 224x224 through the CLI's
     per-item loop at batch 32; the attention kernel's launches (12 per
     encode, all on the short path), the features' shapes and values, and
     the same items with the kernel off, within EXTRACT_TOL;
 11. the narrow int8 GEMM (K2) against its plain version, bit for bit, at a
     ragged 1,040 x 256 -> 128 (float32), the rollout's fc2 site (100,352 x
     3072 -> 768, bfloat16), the serve site (200,704 rows, bfloat16 and
     float32) and the corners of its shape gate; at the two fc2 sites its
     time beside the plain version's, the dequant + bf16 route it replaces
     by default, the unfused s8 route (quantize_rows + torch._int_mm +
     epilogue), torch._int_mm alone, the bound and the share of it
     reached;
 12. the three-stage recipe at the flagship width on synthetic batches:
     stage 1 (PointwiseTrainer.fit, batch 32 x 32 tags, 4 steps) and stage
     2 (RewardTrainer.fit, batch 32 pairs, 4 steps) under --profile fast,
     each best `.bin` reloaded strict; stage 3 (PPOTrainer.fit from both
     `.bin`s, batch 256 x 2 tags, 2 rollouts and 2 updates) with the fused
     FFN off and the narrow sites on, 4 K2 launches a rollout and no K1,
     and one more rollout in that routing and one in the default one (4 K1
     launches); then evaluate_cases (ppo_eval) on the stage-3 best `.bin`,
     its NDCG equal to the trainer's best; and one served batch of phase
     4's int8 model in the narrow routing, 2 K2 launches, scores within
     phase 4's gate;
 13. the tabular (LETOR) recipe at full width (768, 8 heads, one XiT block,
     trad_dims [46, 136]) on synthetic data in the published shapes of
     MQ2008 (9,630 rows x 46 features, labels 0-2) and MSLR-Web10K (cut to
     60,000 rows x 136 features, labels 0-4): hash dropout against its
     plain version at the tabular sites (512 x 3072, 512 x 768, 640 x
     3072); preprocess_data svm2tsv (the native parse equal to the numpy
     parse), disjoint and check, grouping to 20 documents; the 2-data
     trainer (4 steps of each domain) and project_tsv of MQ2008 to 768
     wide, combined with 50 projected Web10K queries into the merged set;
     stages 1 and 2 (4 steps each) and stage 3 (4 rollouts, 4 updates)
     under --profile fast, hash dropout's launches counted at every stage,
     no K1 launch and every int8 site of one more rollout on the dequant
     route; ppo_eval_trad's evaluate_cases, its NDCG equal to stage 3's
     best;
 14. tower pretraining: hash dropout against its plain version at the two
     tower sites of XLM-R base MLM at batch 32 x 128 ((32, 128, 768) and
     (32, 12, 128, 128), float32); then `lr2ppo_torch.cli.pretrain.main`
     at XLM-R base's full width (12 x 768, 12 heads, FFN 3072, a
     250,002-entry space vocabulary with the specials first, a synthetic
     Zipf corpus), --data_processor mlm --hash_dropout, batch 32 x 128, 2
     accumulated micro-batches, 4 steps, float32: finite losses, moved
     parameters, hash dropout launched at every site forward and backward
     (592), the -best and final checkpoints reloaded strict and one encode
     of the final one through the extraction path; and 2 steps of the same
     trainer under Adafactor;
 15. multi-GPU training (lr2ppo_torch/parallel/): hash dropout's
     global-index form against its plain version at a dp shard (timed, for
     the kernels line) and a tp column shard of the update's site
     (bfloat16) and at an odd width, Philox at a dp shard's offset; then
     PPOTrainer.fit at the flagship width under --profile fast at a
     constant learning rate (2 global batches of 256 x 2 tags, 2 updates,
     one eval), each leg in processes of its own: the reference without
     torch.distributed; (a) NCCL at world = the card count, one card a
     rank, bit-equal to the reference at world 1 (the sweep's records and
     checksums of every parameter), 4 K1 launches a rollout; (b) two gloo
     ranks sharing card 0 with CUDA tensors, dp 2 with zero1 (K1 on each
     rank) and tp 2 (no K1, out_layer.fc1 split), each within P15_RTOL /
     P15_ATOL of the reference on the sweep's records and within
     P15_PARAM_GAP on every trained parameter but P15_SHIFT_LEAVES, with
     hash dropout's launches at a place. `--parallel_only` runs the build
     and (a) alone, adding on two or more cards dp with zero1 over NCCL
     (bit-equal to plain dp), and on four dp x tp 2;
 16. pipeline stages, sequence parallelism, Adafactor under tp and serving
     on a mesh: hash dropout at the sp place ((32, 64, 768) of (32, 128,
     768), float32, the second tp rank's tokens) against its plain version
     forward and backward, timed for the kernels line; XLM-R base MLM
     through cli.pretrain (phase 14's width, corpus and batch, cut to
     P16_LAYERS of its 12 layers, P16_STEPS steps) in this process at
     dropout 0 and, under Adafactor, at dropout 0.1 with hash dropout, as
     the references; then legs of two gloo ranks sharing card 0, each in
     processes of its own: pp 2 (M = 4) at dropout 0 against the reference
     (losses within P16_LOSS_RTOL, parameters within P16_PARAM_GAP, the
     unpacked -best loaded strict), tp 2 with and without --sp at dropout
     0.1 (bit equality reported, the gap held), pp 2 at dropout 0.1 (hash
     dropout's launches on each stage as its layers give them, every
     stage's tensors moved), tp 2 with --sp under Adafactor against its
     reference; then the int8 service of phase 4's weights
     (P16_SERVE_BATCHES batches) in this process and at dp 2 (the same
     orders, K1 on each rank) and tp 2 (no K1, fc2 split), scores within
     phase 4's gate. `--parallel_only` runs, after phase 15's, pp 4, pp 2 x
     tp 2, pp 2 x dp 2 and fsdp at dp 4 over NCCL against the reference, tp
     2 with and without --sp over NCCL, and the service at dp 4;
 17. the encoder-only pretraining processors, K2 under tp and the trace
     window: hash dropout against its plain version at bert's two sites;
     cli.pretrain's build and fit at --data_processor bert --hash_dropout
     (XLM-R base with the mlm and sp targets, phase 14's batch, P17_STEPS
     steps, a synthetic documents corpus from the seed; the launches,
     finite losses and moved weights held); K2's tp entry (the int32
     product and the epilogue) bit for bit against their plain versions at
     a tp-2 rank's shard of the rollout's fc2 site, timed beside
     torch._int_mm for the kernels line; one spawn of two gloo ranks
     sharing card 0: the fc2 site at tp 2 with NARROW_SITES on, bit-equal
     to K2 at world 1, and project_tsv of a seeded flagship-width 2-data
     model at dp 2 (world 1's file byte for byte) and tp 2 (within float32
     rounding), rank 0 writing; stage 1 at phase 12's geometry with
     --profile_dir for 21 steps, whose trace of steps 10-20 must exist and
     name the kernels. `--processors_only` runs the build and phase 17
     alone;
 18. the seq2seq towers: T5-base span corruption through cli.pretrain's
     build and fit at --data_processor t5 --hash_dropout (12 + 12 layers of
     768, T5's relative bias, RMS norms at pre-LN, no biases, a 32,028-entry
     space vocabulary grown by the 100 sentinels to 32,128, a synthetic
     Zipf corpus, 2 micro-batches of 32 x (128 + 128), float32, 4 steps):
     the parameter count, losses that fall, moved leaves, 98 hash-dropout
     sites a pass forward and backward, no K4 launch; the first decoder
     layer's context probabilities of that batch (32, 12, 128, 128) and of
     a --tgt_seq_length 64 batch (32, 12, 64, 128) through hash dropout
     against its plain version on the site's own input and seed; then
     Transformer base (6 + 6 layers of 512, sinusoidal positions, post-LN)
     at --data_processor mt on a synthetic tsv for 2 steps.
     `--seq2seq_only` runs the build and phase 18 alone;
 19. the other encoders: the large LSTM LM of Zaremba et al. (2014; 2
     layers of 1,500, dropout 0.65, a 10,000-entry space vocabulary, a
     synthetic Zipf corpus) through cli.pretrain's build and fit at
     --data_processor lm --hash_dropout, batch 20 x 35, float32, 4 steps:
     66,024,000 parameters, losses that fall, moved leaves, 3 hash-dropout
     sites a pass forward and backward; its three sites (20, 35, 1500)
     held against the plain hash dropout at rate 0.65 on each site's own
     input and seed; one deterministic forward on the card against the
     same weights' forward on the CPU (LSTM_CPU_ATOL, LSTM_CPU_RTOL); then
     the ELMo-style bilm on bilstm at the same widths (2 steps, 5 sites a
     pass), and rnn, gru, the bidirectional lstm, birnn, bigru and the
     gated CNN (kernel 4, 8 layers, blocks of 2) for one step each; then
     CLIP ViT-B/16 contrastive pretraining at OpenAI's widths through
     PretrainTrainer's clip form on 2 x 64 seeded pairs held in memory (no
     PIL on the card's machine), 4 steps: the parameter count beside
     OpenAI's, a first loss near ln 64 that falls, moved leaves in both
     towers, the projections and logit_scale, no hash-dropout or K4
     launch. `--encoders_only` runs the build and phase 19 alone;
 20. image and speech pretraining, float32 with TF32 off for products and
     convolutions: the VQGAN at the published imagenet f16-1024 widths
     (seeded weights) encoding 8 images at 224 x 224 on the card and on the
     CPU, quant_conv's output within VQ_Z_RTOL and the tokens equal wherever
     the CPU's margin between its two nearest codes exceeds twice the gap
     in the distances (the share printed); BEiT-base (ViT-B/16,
     masked_patch + pos, an mlm head over the VQGAN's 1,024 codes, the
     CLI's mask rate) through cli.pretrain at --data_processor beit
     --hash_dropout, 2 micro-batches of 32 seeded images, 4 steps: the
     parameter count beside the published 86 M, falling losses, moved
     leaves (mask_emb among them), the launches against the sites counted
     from the config, its embedding and attention-probability sites ((32,
     197, 768), (32, 12, 197, 197)) against the plain hash dropout; the
     -best checkpoint loaded strict and one encode of 32 images through the
     extraction path (12 K4 launches); ViLT-B/32 (word_patch + pos + seg,
     384 x 384 in patches of 32, text of 40, a 30,522-entry vocabulary, the
     mlm and match targets) at --data_processor vilt, 2 x 32 pairs, 4
     steps, the same quantities and the match targets' share; S2T-small
     (12 + 6 layers of 256, 2 convolutions over 80 mel bins, a 10,000-entry
     vocabulary) at --data_processor s2t on 32 seeded wavs of 12-16 s read
     through S2tDataset, --max_audio_frames 1600, targets of up to 128
     tokens, 2 x 16 utterances, 4 steps, the same quantities and its
     encoder site (16, 400, 256); then vit (ViT-B/16, 1,000 classes) and
     dalle (a reduced 12 x 768 causal tower over 32 text and 256 VQGAN
     tokens), 2 steps each. The images are seeded arrays behind the port's
     own datasets (only `_pixels` overridden; the card's machine has no
     PIL). `--vision_speech_only` runs the build and phase 20 alone.
 21. the checkpoint backends (`--ckpt_backend pickle|orbax|orbax_async`):
     (a) phase 7's trained actor and critic `.state` written with each,
     the bytes on disk, the three payloads read back bit-equal
     (checksums); phase 7's update run 3 times while the async write is in
     flight (it must not reach the directory); (b) in a process of its own
     with deterministic algorithms, phase 7's fit cut after its first
     sweep with orbax_async and --save_state_steps 1 and resumed from the
     directory: the actor, the critic and their moments bit-equal to phase
     7's fit; (c) in phase 15's shared-card legs (dp 2 + zero1, tp 2) every
     rank writes the trained state once with orbax, its bytes beside the
     pickle route's gather-and-write, the tensors read back bit-equal to
     the gathered ones. Each checkpoint is deleted after its check.
     `--checkpoints_only` runs the build, phase 7, phase 21 and phase 15.
 22. the AdamW kernel against its plain version, p, m and v bit for bit
     over 3 steps, at the `out_layer` weight (3,072 x 162,816; float32
     parameters and bfloat16 moments, as the PPO trainer under --profile
     fast holds them, and bfloat16 parameters) and XLM-R base's word table
     (250,002 x 768; float32 parameters and moments, as tower pretraining
     holds them, and bfloat16 parameters), with its time beside the plain
     version's, torch.optim.AdamW(fused=True)'s and the bound; then one
     update's whole set (the actor's and the critic's steps at flagship
     width under --profile fast) through AdamW.step, one launch a tensor,
     2 steps bit for bit, its time, the host's time to enqueue it and the
     kernels' traced device time. Phase 7 also counts one launch a tensor
     an update. `--adamw_only` runs the build and phase 22 alone.
 23. the latent tower's causal attention kernels (ops/mla_attention.py:
     the Triton forward, the CUDA C++ backward of
     kernels/csrc/mla_attention_bwd.cu) at (8, 16, 8,192, 192/128) bf16,
     the moe-lm-s8192 cell's shape: its output and its dq, dk, dv held to
     the plain version's on the same inputs (one sequence at a time: the
     plain scores would not fit whole), within the card test's gaps
     (norm-relative 1e-2 forward, 2e-2 gradients; worst element 6e-2 of the
     largest); forward and backward times beside their bound at the bf16
     peak (the pairs at or below the diagonal), the plain version's and
     F.scaled_dot_product_attention's as the yardstick, which the port
     never calls, and the Triton backward's 24.876 ms that the CUDA one
     replaced (PERF.md); the backward's tiles and ptxas' registers and
     spills for its three kernels. Then, its counters set to 0, one
     training step (forward with remat, backward, the correction-bias
     update) of perfbench/configs/moonlight-16b-a3b-ep8.json at 8 x 8,192
     tokens: 45 kernel launches (9 forwards, 9 recomputes, 9 backwards of
     3), the plain version never called, and every MoE layer routing over
     64 experts and computing its 8; the kernels line reports that step's
     launches. `--mla_only` runs phase 23 alone (it builds the CUDA
     libraries first).

Prints JSON lines; the line before the last lists the kernels, and the last
is {"ok": true, "device": {...}}. Without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from itertools import islice

import numpy as np
import torch

from lr2ppo_torch.cli import preprocess, preprocess_data, pretrain, serve
from lr2ppo_torch.cli._common import (force_family, letor_pointwise_loaders,
                                      letor_ppo_loaders,
                                      letor_reward_loaders,
                                      letor_two_data_loaders)
from lr2ppo_torch.config import ModelConfig, parse_config
from lr2ppo_torch.data.letor import (LetorQueries, group_queries,
                                     parse_svmlight_file, read_tsv, write_tsv)
from lr2ppo_torch.data.tokenizers import SpaceTokenizer, XLMRobertaTokenizer
from lr2ppo_torch.device import require_cuda
from lr2ppo_torch.kernels import build
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import (ActorCritic, ScoreModel,
                                        SeqScoreModel, TwoDataScoreModel)
from lr2ppo_torch.ops.adamw import adamw, adamw_reference
from lr2ppo_torch.ops.attention import (fused_attention, reference_attention,
                                        reset_launches)
from lr2ppo_torch.ops.dropout import philox_dropout, philox_dropout_reference
from lr2ppo_torch.ops.hash_dropout import hash_dropout, hash_dropout_reference
from lr2ppo_torch.ops import int8 as int8_ops
from lr2ppo_torch.ops.int8 import quantize_rows, quantize_weight
from lr2ppo_torch.ops.int8_matmul import (int8_dot_s32, int8_dot_s32_reference,
                                          int8_matmul, int8_matmul_reference,
                                          s32_epilogue, s32_epilogue_reference)
from lr2ppo_torch.ops.int8_mlp import int8_mlp, int8_mlp_reference
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.checkpoints import load_any, trad_dims_from_state_dict
from lr2ppo_torch.train.common import init_state, save_train_state
from lr2ppo_torch.train.evaluate import evaluate_cases
from lr2ppo_torch.train.optim import (AdamW, build_optimizer, decays,
                                      no_decay_names)
from lr2ppo_torch.train.pointwise import (PointwiseTrainer, TwoDataTrainer,
                                          project_tsv)
from lr2ppo_torch.train.reward import RewardTrainer
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint)
from lr2ppo_torch.towers.extract import (ImageFeatureExtractor,
                                         TextFeatureExtractor)
from lr2ppo_torch.towers.model import init_weights as init_tower_weights
from lr2ppo_torch.towers.torch_import import encoder_state
from lr2ppo_torch.train.ppo import (PPOTrainer, frozen_copy,
                                    make_rollout_step, make_update_step)
from lr2ppo_torch.train.pretrain import PretrainTrainer
from lr2ppo_torch.train.pretrain import form_args as pretrain_form_args
# the H100's published rates, the roofline bound and the CUDA-event timer
# the benchmark takes its kernel figures with (kernel_ab.py reads
# HBM_BYTES_PER_S and cuda_ms through this module)
from perfbench.common.chipmath import (BF16_TENSOR_OPS_PER_S,
                                       HBM_BYTES_PER_S,
                                       INT8_TENSOR_OPS_PER_S,
                                       VECTOR_OPS_PER_S, bound, cuda_ms)

D, H = 768, 3072
SERVE_ROWS = 32 * 32 * 196            # items x tag bucket x text tokens
TRAIN_BS, PAIR = 256, 2               # PPO batch: 256 items x 2 tags
ROLLOUT_ROWS = TRAIN_BS * PAIR * 196  # K1's rows in a rollout forward
ITEMS, BUCKET, TAGS = 32, 32, (5, 20)
BATCHES = 4                           # served on the main path
TRAIN_BATCHES = 4                     # rollouts of the training run


def timed(res: dict, fn, plain, nbytes: float, ops: float, rate: float,
          reps: int) -> None:
    """The kernel's and its plain version's median ms into `res` (`reps`
    calls a timed run), with the bound and the share of it the kernel
    reached."""
    res["ms"] = cuda_ms(fn, reps=reps)
    res["plain_ms"] = cuda_ms(plain, reps=reps)
    res.update(bound(nbytes, ops, rate))
    res["bound_share"] = res["bound_ms"] / res["ms"]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


def ffn_inputs(rows: int, seed: int, dev, d: int = D, h: int = H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d), dtype=np.float32)
    w1 = rng.standard_normal((h, d), dtype=np.float32) * 0.05
    b1 = rng.standard_normal(h, dtype=np.float32) * 0.01
    w2 = rng.standard_normal((d, h), dtype=np.float32) * 0.05
    b2 = rng.standard_normal(d, dtype=np.float32) * 0.01
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(dev)
                         for a in (x, w1, b1, w2, b2))
    q1, s1 = quantize_weight(w1)
    q2, s2 = quantize_weight(w2)
    return x, q1, s1, b1, q2, s2, b2


def check_kernel(rows: int, out_dtype, seed: int, dev, time_it: bool,
                 card_line: str, d: int = D, h: int = H) -> dict:
    x, *w = ffn_inputs(rows, seed, dev, d, h)
    x = x.to(out_dtype)
    got = int8_mlp(x, *w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = int8_mlp_reference(x, *w, out_dtype=out_dtype)
    diff = (got.float() - ref.float()).abs()
    res = {"rows": rows, "d": d, "h": h,
           "dtype": str(out_dtype).replace("torch.", ""),
           "bit_equal": float((got == ref).float().mean()),
           "max_abs_err": float(diff.max()),
           "mean_abs_err": float(diff.mean())}
    # the kernel does the plain version's operations in the same order
    # with integer-exact products: bit for bit
    if res["bit_equal"] != 1.0:
        emit(phase="kernel_vs_plain", failed=True, **res)
        raise AssertionError(f"int8_mlp is not bit-equal to its plain "
                             f"version: {res}")
    if time_it:
        ops = 2 * 2 * rows * d * h
        esize = torch.tensor([], dtype=out_dtype).element_size()
        weights = 2 * d * h + 4 * 2 * (d + h)
        timed(res, lambda: int8_mlp(x, *w, out_dtype=out_dtype),
              lambda: int8_mlp_reference(x, *w, out_dtype=out_dtype),
              2 * rows * d * esize + weights, ops, INT8_TENSOR_OPS_PER_S,
              reps=3)
        res["kernel_tops"] = ops / (res["ms"] * 1e-3) / 1e12
        res["card"] = card_line
    emit(phase="kernel_vs_plain", **res)
    return res


class SyntheticItems:
    """What serve_batches reads of a dataset: examples and tag names."""

    def __init__(self, tag_counts):
        self.examples = [(f"item{i}", list(range(t)))
                         for i, t in enumerate(tag_counts)]
        self.tag_names = {f"item{i}": [f"tag{j}" for j in range(t)]
                          for i, t in enumerate(tag_counts)}


def synthetic_batches(n: int, mcfg: ModelConfig, seed: int,
                      items: int = ITEMS, bucket: int = BUCKET,
                      tags=TAGS):
    """EvalLoader-format batches: `items` items of tags[0]-tags[1] tags
    each, padded to the `bucket`-tag bucket (zero text, masked out), made
    with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(tags[0], tags[1] + 1, size=n * items)
    batches = []
    for b in range(n):
        text = np.zeros((items, bucket, mcfg.seq_length, mcfg.feat_size),
                        np.float32)
        tgts = np.zeros((items, bucket), np.int32)
        mask = np.zeros((items, bucket), bool)
        for i in range(items):
            t = counts[b * items + i]
            text[i, :t] = rng.standard_normal(
                (t, mcfg.seq_length, mcfg.feat_size), dtype=np.float32)
            tgts[i, :t] = rng.integers(0, 3, size=t)
            tgts[i, 0] = 2                     # every item has gold labels
            mask[i, :t] = True
        img = rng.standard_normal((items, mcfg.max_imgs, mcfg.feat_size),
                                  dtype=np.float32)
        idx = np.arange(b * items, (b + 1) * items, dtype=np.int64)
        batches.append({"text": text, "img": img, "tgts": tgts,
                        "mask": mask, "_idx": idx})
    return batches, SyntheticItems(counts.tolist())


def read_rankings(path: str, ds: SyntheticItems) -> dict:
    """Parse and check the jsonl; returns {id: scores in tag order}."""
    out = {}
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    for ln in lines:
        n = len(ds.tag_names[ln["id"]])
        order, s = ln["pred_order"], ln["pred_scores"]
        if not (set(ln) >= {"id", "pred_order", "pred_scores", "tags",
                            "tags_rearranged", "ndcg"}
                and sorted(order) == list(range(n))
                and s == sorted(s, reverse=True)
                and np.isfinite(s).all()
                and [ln["tags"][j] for j in order] == ln["tags_rearranged"]
                and len(ln["ndcg"]) == 6
                and all(0.0 <= v <= 1.0 + 1e-6 for v in ln["ndcg"])):
            raise AssertionError(f"malformed ranking line: {ln}")
        tag_scores = np.empty(n)
        tag_scores[order] = s
        out[ln["id"]] = tag_scores
    if len(out) != len(lines) or len(out) != len(ds.examples):
        raise AssertionError(f"{len(lines)} ranking lines for "
                             f"{len(ds.examples)} items")
    return out


def main_path(args, dev, card_line: str) -> int:
    mcfg = ModelConfig()                       # flagship widths, one XiT
    dtype = torch.bfloat16                     # the CLI's --profile fast
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = ScoreModel(mcfg, dtype, device=dev)
    init_weights(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "actor.bin")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        del model
        state = load_any(ckpt)
        int8_model = serve.load_model(dataclasses.replace(mcfg, int8=True),
                                      state, dtype, dev)
        bf16_model = serve.load_model(mcfg, state, dtype, dev)
        del state
        batches, ds = synthetic_batches(BATCHES, mcfg, args.seed + 1)
        int8_mlp.launches = 0
        path_int8 = os.path.join(tmp, "rankings_int8.jsonl")
        with open(path_int8, "w") as sink:
            res = serve.serve_batches(int8_model, batches, ds, sink, dev)
        launches = int8_mlp.launches

        if launches != 2 * len(batches):
            raise AssertionError(f"int8_mlp launched {launches} times for "
                                 f"{len(batches)} batches, expected 2 each")
        path_bf16 = os.path.join(tmp, "rankings_bf16.jsonl")
        with open(path_bf16, "w") as sink:
            serve.serve_batches(bf16_model, batches, ds, sink, dev)
        got, ref = read_rankings(path_int8, ds), read_rankings(path_bf16, ds)
    spread = max(float(np.abs(v).max()) for v in ref.values())
    err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
    emit(phase="main_path", params=n_params, batches=len(batches),
         items=res["items"], kernel_launches=launches,
         int8_vs_bf16_max_err=err, score_spread=spread, card=card_line)
    # tests/test_int8.py's bound for int8 against float scores
    if not err < 0.05 * spread:
        raise AssertionError(f"int8 scores off the bf16 scores by {err}, "
                             f"spread {spread}")
    # phase 12 serves one of these batches again in K2's routing
    served = {"int8": int8_model, "bfloat16": bf16_model,
              "batch": batches[0],
              "ds": SyntheticItems([len(ds.examples[i][1])
                                    for i in range(ITEMS)])}
    return launches, served


DROPOUT_KERNELS = {
    "hash_dropout": (hash_dropout, hash_dropout_reference,
                     "lr2ppo_tpu/ops/hash_dropout.py:89"),
    "philox_dropout": (philox_dropout, philox_dropout_reference,
                       "lr2ppo_tpu/ops/pallas_dropout.py:70"),
}
DROP_RATE = 0.1                        # ModelConfig.drop_p / forward_drop_p
# hash dropout at a split place (col0 != 0, width != w) of ragged rows that
# straddle the ring's 16 KB chunks and its stages, 12,288 x 3,077 values:
# larger than the L2 in both dtypes, so the ring runs them, ~9 (float32)
# and ~4 (bfloat16) passes of 264 blocks x 4 stages; the ragged (1000,
# 3077) case beside it takes the register path
RING_SHAPE = (12288, 3077)
RING_PLACE = (5, 1234, 7001, 3077)


def check_dropout(name: str, shape, dtype, seed: int, dev, time_it: bool,
                  card_line: str, extra=(), x=None,
                  rate: float = DROP_RATE) -> dict:
    """One dropout kernel against its plain version at `rate`: the forward
    and the backward (the cotangent) bit for bit, the same mask in both,
    and the keep share within 5 sigma of 1 - rate. `extra` are the
    arguments after the rate: a shard's place (hash) or its offset
    (Philox). `x`, where given, is the input (a site's tensor from a real
    pass), else a random one without zeros."""
    fn0, ref0, _ = DROPOUT_KERNELS[name]

    def fn(x, seed, rate):
        return fn0(x, seed, rate, *extra)

    def ref(x, seed, rate):
        return ref0(x, seed, rate, *extra)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if x is None:
        # no zeros in the input, so a zero in the output is a dropped
        # element
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        x[x == 0] = 1.0
    # nor in the cotangent: its gradient is zero exactly where dropped
    g = torch.randn(shape, device=dev, generator=gen).to(dtype)
    g[g == 0] = 1.0
    xr = x.clone().requires_grad_(True)
    y = fn(xr, seed, rate)
    y.backward(g)
    y = y.detach()
    torch.cuda.synchronize()
    want_y, want_g = ref(x, seed, rate), ref(g, seed, rate)
    n = x.numel()
    share = float((xr.grad != 0).float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    nonzero = x != 0
    res = {"kernel": name, "shape": list(shape), "shard": list(extra),
           "dtype": str(dtype).replace("torch.", ""), "rate": rate,
           "forward_bit_equal": bool(torch.equal(y, want_y)),
           "backward_bit_equal": bool(torch.equal(xr.grad, want_g)),
           "same_mask": bool(torch.equal((y == 0) & nonzero,
                                         (xr.grad == 0) & nonzero)),
           "max_abs_err": max(float((y.float() - want_y.float()).abs().max()),
                              float((xr.grad.float()
                                     - want_g.float()).abs().max())),
           "keep_share": share, "keep_sigmas": abs(share - (1 - rate))
           / sigma}
    if not (res["forward_bit_equal"] and res["backward_bit_equal"]
            and res["same_mask"] and res["keep_sigmas"] < 5):
        emit(phase="dropout_vs_plain", failed=True, **res)
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{res}")
    del xr, y, want_y, want_g, g, nonzero
    if time_it:
        res["ms"] = cuda_ms(lambda: fn(x, seed, rate))
        res["plain_ms"] = cuda_ms(lambda: ref(x, seed, rate), iters=3,
                                  warmup=1)
        # the same work with another random stream; the port never calls it
        res["library_ms"] = cuda_ms(lambda: torch.nn.functional.dropout(
            x, rate, training=True))
        # one read and one write of every element; ~12 (hash) or ~30
        # (Philox: 10 rounds of 4 multiplies, 4 xors, 2 adds per 4
        # elements) integer operations per element
        ops = n * (12 if name == "hash_dropout" else 30)
        res.update(bound(2 * n * x.element_size(), ops, VECTOR_OPS_PER_S))
        res["card"] = card_line
    emit(phase="dropout_vs_plain", **res)
    return res


def dropout_kernels(seed: int, dev, card_line: str) -> dict:
    """Phase 6: both dropout kernels at a ragged small size and at the
    update's FFN-inner site (100,352 x 3072), float32 and bfloat16, hash
    dropout also at RING_PLACE. The bfloat16 site's numbers go to the
    kernels line."""
    out = {}
    for name in DROPOUT_KERNELS:
        runs = [check_dropout(name, (1000, 3077), dt, seed - 77, dev, False,
                              card_line)
                for dt in (torch.float32, torch.bfloat16)]
        if name == "hash_dropout":
            runs += [check_dropout(name, RING_SHAPE, dt, seed - 78, dev,
                                   False, card_line, (RING_PLACE,))
                     for dt in (torch.float32, torch.bfloat16)]
        runs += [check_dropout(name, (ROLLOUT_ROWS, H), dt, seed + 1, dev,
                               dt == torch.bfloat16, card_line)
                 for dt in (torch.float32, torch.bfloat16)]
        torch.cuda.empty_cache()
        out[name] = {**runs[-1],
                     "max_abs_err": max(r["max_abs_err"] for r in runs)}
    return out


class BatchList:
    """What a trainer's fit reads of a loader, over a list of host batches."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch: int) -> None:
        pass

    def first_batch(self):
        return self.batches[0]


def item_batches(n: int, mcfg: ModelConfig, seed: int, bs: int, tags: int,
                 **extra) -> list:
    """`n` training batches made with numpy from `seed`, float32 as a
    loader emits them without ml_dtypes: text (bs, tags, S, D), img
    (bs, I, D), tgts (bs, tags) in 0-2; `extra` maps a key to a function
    of the numpy generator that makes it."""
    rng = np.random.default_rng(seed)
    return [{"text": rng.standard_normal(
                 (bs, tags, mcfg.seq_length, mcfg.feat_size),
                 dtype=np.float32),
             "img": rng.standard_normal((bs, mcfg.max_imgs, mcfg.feat_size),
                                        dtype=np.float32),
             "tgts": rng.integers(0, 3, size=(bs, tags)).astype(np.int32),
             **{k: fn(rng) for k, fn in extra.items()}} for _ in range(n)]


class SyntheticTrainLoader(BatchList):
    """What PPOTrainer.fit reads of a loader: `n` ppo-mode batches (text
    (B, 2, S, D), img (B, I, D), tgts (B, 2)) made with numpy from
    `seed`."""

    def __init__(self, mcfg: ModelConfig, seed: int, n: int = TRAIN_BATCHES):
        super().__init__(item_batches(n, mcfg, seed, TRAIN_BS, PAIR))


def train_config(tmp: str, seed: int, **model_kw):
    """The trainer's configuration under --profile fast at batch 256."""
    cfg = parse_config(["--profile", "fast", "--batch_size", str(TRAIN_BS),
                        "--max_tags", str(PAIR), "--max_timesteps", "1",
                        "--update_timesteps", "2", "--epochs_num", "1",
                        "--eval_steps", "2", "--seed", str(seed),
                        "--output_model_path", os.path.join(tmp, "best.bin"),
                        "--log_path", os.path.join(tmp, "train.log")])
    return cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))


def train_path(args, dev, card_line: str) -> dict:
    """Phase 7: PPOTrainer.fit at the flagship width under --profile fast
    (bf16 compute and moments, hash dropout, int8 reward and actor twin):
    4 rollouts, 2 sweeps of 2 updates, one eval and one best save; its
    launches, losses, moved parameters and the best save reloaded strict.
    Returns what phase 21 reads: the trained states, their checksums and an
    update closure on them."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_config(tmp, args.seed)
        loader = SyntheticTrainLoader(cfg.model, args.seed + 3)
        evb, _ = synthetic_batches(2, cfg.model, args.seed + 4, items=8,
                                   bucket=8, tags=(2, 8))
        trainer = PPOTrainer(cfg, dev)
        built = {}

        def init_params(seed):
            built["models"] = models = PPOTrainer.init_params(trainer, seed)
            built["before"] = {k: p.detach().clone() for k, p in (
                ("actor.head.weight", models[0].head.weight),
                ("critic.head.weight", models[1].head.weight),
                ("actor.xit.ffn.fc1", models[0].xit._modules["0"][0][1]
                 .fn[1][0].weight))}
            return models

        trainer.init_params = init_params
        int8_mlp.launches = hash_dropout.launches = 0
        philox_dropout.launches = adamw.launches = 0
        astate, cstate, best = trainer.fit(lambda epoch: loader, evb)
        torch.cuda.synchronize()
        launches = {"int8_mlp": int8_mlp.launches,
                    "hash_dropout": hash_dropout.launches,
                    "philox_dropout": philox_dropout.launches,
                    "adamw": adamw.launches}
        rollouts, updates = TRAIN_BATCHES, astate.step
        # AdamW: one launch a tensor of each model, each update
        tensors = sum(len(list(m.parameters())) for m in built["models"][:2])
        want = {"int8_mlp": 4 * rollouts, "hash_dropout": 18 * updates,
                "philox_dropout": 0, "adamw": tensors * updates}
        if updates != 4 or cstate.step != 4 or launches != want:
            raise AssertionError(f"{updates} updates, launches {launches}; "
                                 f"expected 4 updates and {want}")
        with open(cfg.log_path + ".jsonl") as f:
            recs = [json.loads(line) for line in f]
        losses = [[r["policy_loss"], r["value_loss"]] for r in recs]
        if not (len(recs) == 2 and np.isfinite(losses).all()
                and np.isfinite(best) and "ndcg_full" in recs[-1]):
            raise AssertionError(f"sweep records {recs}, best {best}")
        actor, critic, reward = built["models"]
        now = {"actor.head.weight": actor.head.weight,
               "critic.head.weight": critic.head.weight,
               "actor.xit.ffn.fc1": actor.xit._modules["0"][0][1].fn[1][0]
               .weight}
        moved = {k: float((now[k].detach() - v).abs().max())
                 for k, v in built["before"].items()}
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"parameters did not move: {moved}")
        fit_sums = state_sums(astate, cstate)
        state = torch.load(cfg.output_model_path, weights_only=True)
        ActorCritic(cfg.model, device="meta").load_state_dict(
            state, strict=True, assign=True)
        reloaded = len(state)
        del state
        emit(phase="train", params_per_model=sum(
                 p.numel() for p in actor.parameters()),
             rollouts=rollouts, updates=int(updates), kernel_launches=launches,
             sweep_losses=losses, best_ndcg_full=best, moved=moved,
             reloaded_keys=reloaded, card=card_line)
        # phase 21 (a) writes these states and runs this update while its
        # async write is in flight; (b) holds its fit to fit_sums
        one_update = update_closure(trainer, built["models"], astate, cstate,
                                    loader.batches[0], args.seed)
        return {"launches": launches, "fit_sums": fit_sums,
                "one_update": one_update,
                "trainer": trainer, "states": (astate, cstate),
                "best": best}


def state_sums(astate, cstate) -> dict:
    """checksum of every tensor of the actor's and the critic's models and
    AdamW moments (at world 1, whole)."""
    out = {}
    for side, s in (("actor", astate), ("critic", cstate)):
        for k, v in s.model.state_dict().items():
            out[f"{side}.{k}"] = checksum(v)
        for table in ("mu", "nu"):
            for k, v in getattr(s.opt, table).items():
                out[f"{side}.{table}.{k}"] = checksum(v)
    return out


def update_closure(trainer, models, astate, cstate, batch, seed: int):
    """One update of the stage-3 step on `batch` and one rollout's outputs,
    on the trained models."""
    cfg = trainer.cfg
    actor, critic, reward = models
    b = trainer.ctx.put(batch)
    st = trainer.ctx.put_array(np.broadcast_to(
        np.arange(PAIR, dtype=np.int32), (TRAIN_BS, PAIR)).copy())
    twin = frozen_copy(ScoreModel, cfg.model, actor.state_dict(),
                       trainer.dtype, True)
    roll = make_rollout_step(cfg.model.mode)
    upd = make_update_step(cfg)
    gen = torch.Generator().manual_seed(seed)
    out = roll(twin, critic, reward, b["text"], b["img"], st)

    def one_update():
        upd(astate, cstate, gen, b["text"], b["img"], st, out[2], out[0],
            out[3], out[1])
    return one_update


def k3_path(args, dev, card_line: str) -> int:
    """Phase 8: the trainer's update step twice at batch 256 with
    pallas_dropout=True, hash_dropout=False: the FFN-inner site of each
    trained model (256 x 2 x 196 x 3072 elements, above the 128 x 2^20
    gate) takes the Philox kernel, forward and backward; the other sites
    are canonical dropout."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_config(tmp, args.seed, hash_dropout=False,
                           pallas_dropout=True)
        trainer = PPOTrainer(cfg, dev)
        actor, critic = (ScoreModel(cfg.model, trainer.dtype, device=dev),
                         SeqScoreModel(cfg.model, trainer.dtype, device=dev))
        gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
        init_weights(actor, gen)
        init_weights(critic, gen)

        def state(model):
            return init_state(model, build_optimizer(
                cfg.optim, dict(model.named_parameters()), 10,
                lr=cfg.optim.learning_rate))
        astate, cstate = state(actor), state(critic)
        batch = SyntheticTrainLoader(cfg.model, args.seed + 6).batches[0]
        b = trainer.ctx.put(batch)
        rng = np.random.default_rng(args.seed + 7)
        st = torch.arange(PAIR, device=dev, dtype=torch.int32).expand(
            TRAIN_BS, PAIR).contiguous()
        perm = torch.from_numpy(np.stack([rng.permutation(PAIR)
                                          for _ in range(TRAIN_BS)])).to(dev)
        nxt = torch.cat([st, perm.to(torch.int32)], dim=1)
        small = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, trainer.dtype)
            for shape in ((TRAIN_BS, PAIR), (TRAIN_BS,), (TRAIN_BS,))]
        upd = make_update_step(cfg)
        cpu_gen = torch.Generator().manual_seed(args.seed + 8)
        philox_dropout.launches = hash_dropout.launches = 0
        metrics = []
        for _ in range(2):
            m = upd(astate, cstate, cpu_gen, b["text"], b["img"], st, nxt,
                    *small)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = philox_dropout.launches
        if launches != 2 * 4 or hash_dropout.launches != 0:
            raise AssertionError(f"philox_dropout launched {launches} times "
                                 "in 2 updates, expected 2 forward and 2 "
                                 "backward each")
        if not all(np.isfinite(list(m.values())).all() for m in metrics):
            raise AssertionError(f"non-finite update metrics {metrics}")
        emit(phase="k3_updates", updates=2, philox_launches=launches,
             policy_loss=[m["policy_loss"] for m in metrics],
             value_loss=[m["value_loss"] for m in metrics], card=card_line)
    return launches


# (B, H, S, dh) of phase 9
ATTN_SHAPES = {
    "ragged": (3, 5, 77, 64),
    "long": (2, 12, 514, 64),             # XLM-R's max_seq_length
    "dh128": (2, 4, 130, 128),
    "s256": (4, 12, 256, 64),             # the short path's longest
    "s257": (4, 12, 257, 64),             # the long path's shortest
    "text": (32, 12, 196, 64),            # one XLM-R encode at batch 32
    "image": (32, 12, 197, 64),           # one ViT-B/16 encode at batch 32
}
# kernel against plain version, |got - ref| <= atol + rtol * |ref|. The two
# sum in other orders and nowhere else differ. float32: the JAX package's
# kernel-vs-reference bound (tests/test_pallas_attention.py). bfloat16: a
# probability may round to the neighbouring bfloat16 (2^-8 of it, times
# |v| < 5) and the output to its neighbouring step (2^-8 of |ref|).
ATTN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2.0 ** -7)}


def key_bias(name: str, b: int, s: int, rng) -> tuple:
    """The (B, S) 0 / -10000 bias and the real keys per row: every key of
    an image is real; a text row has 8-40 real tokens, as tags have; the
    other shapes 1..S, one row full."""
    if name == "image":
        real = np.full(b, s)
    elif name == "text":
        real = rng.integers(8, 41, size=b)
    else:
        real = rng.integers(1, s + 1, size=b)
        real[0] = s
    bias = np.where(np.arange(s)[None] < real[:, None], 0.0, -10000.0)
    return bias.astype(np.float32), real


def check_attention(name: str, dtype, seed: int, dev, card_line: str) -> dict:
    """Phase 9, one shape and dtype: the kernel against its plain version;
    at the tower shapes, the times and the bound."""
    b, h, s, dh = ATTN_SHAPES[name]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, dh, device=dev, generator=gen).to(dtype)
               for _ in range(3))
    bias_np, real = key_bias(name, b, s, rng)
    bias = torch.from_numpy(bias_np).to(dev)
    scale = 1.0 / math.sqrt(dh)
    atol, rtol = ATTN_TOL[dtype]
    with torch.inference_mode():
        reset_launches()
        got = fused_attention(q, k, v, bias, scale)
        torch.cuda.synchronize()
        path = [p for p, n in fused_attention.path_launches.items() if n]
        ref = reference_attention(q, k, v, bias, scale)
        diff = (got.float() - ref.float()).abs()
        res = {"shape": name, "bhsd": [b, h, s, dh],
               "dtype": str(dtype).replace("torch.", ""),
               "path": path[0] if len(path) == 1 else path,
               "real_keys": [int(real.min()), int(real.max())],
               "max_abs_err": float(diff.max()),
               "bit_equal": float((got == ref).float().mean()),
               "atol": atol, "rtol": rtol,
               "within_tol": bool((diff <= atol + rtol * ref.float().abs())
                                  .all())}
        if not (res["within_tol"] and got.shape == ref.shape
                and got.dtype == dtype
                and res["path"] == ("short" if s <= 256 else "long")):
            emit(phase="attention_vs_plain", failed=True, **res)
            raise AssertionError(f"fused_attention disagrees with its plain "
                                 f"version: {res}")
        if name in ("text", "image"):
            # q, k, v read and out written once, the bias read once; two
            # products of 2 * S * S * dh operations per (b, h)
            rate = (VECTOR_OPS_PER_S if dtype == torch.float32
                    else BF16_TENSOR_OPS_PER_S)
            timed(res, lambda: fused_attention(q, k, v, bias, scale),
                  lambda: reference_attention(q, k, v, bias, scale),
                  4 * b * h * s * dh * q.element_size() + 4 * b * s,
                  4 * b * h * s * s * dh, rate, reps=20)
            # the library's fused attention on the same inputs; the port
            # never calls it
            mask = bias[:, None, None, :].to(dtype)
            res["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), reps=20)
            res["card"] = card_line
    emit(phase="attention_vs_plain", **res)
    return res


def attention_kernels(seed: int, dev, card_line: str) -> dict:
    """Phase 9: every shape in float32 and bfloat16; returns the runs by
    (shape, dtype)."""
    return {(name, dt): check_attention(name, dt, seed + i, dev, card_line)
            for i, name in enumerate(ATTN_SHAPES)
            for dt in (torch.float32, torch.bfloat16)}


# TencentPretrain's models/xlm-roberta/base_config.json as SURVEY.md section
# 2.6 gives it: 12 layers of 768, 12 heads, FFN 3072, word + pos + seg
# embeddings, post-LN, fully visible, max_seq_length 514, vocab 250,002.
XLMR_BASE = {
    "emb_size": 768, "hidden_size": 768, "feedforward_size": 3072,
    "heads_num": 12, "layers_num": 12, "max_seq_length": 514,
    "vocab_size": 250002, "embedding": ["word", "pos", "seg"],
    "encoder": "transformer", "mask": "fully_visible",
    "layernorm_positioning": "post", "target": ["mlm"],
    # assumed, not in the SURVEY: the activation, and the dropout, which
    # encode does not apply
    "hidden_act": "gelu", "dropout": 0.1,
}
# models/vit/base-16-224_config.json as SURVEY.md section 2.6 gives it:
# 12 layers of 768, 12 heads, FFN 3072, patch + pos embeddings, pre-LN,
# 224 x 224 in patches of 16 (197 tokens).
VIT_B16 = {
    "emb_size": 768, "hidden_size": 768, "feedforward_size": 3072,
    "heads_num": 12, "layers_num": 12, "embedding": ["patch", "pos"],
    "remove_embedding_layernorm": True, "encoder": "transformer",
    "mask": "fully_visible", "layernorm_positioning": "pre",
    "image_height": 224, "image_width": 224, "patch_size": 16,
    "channels_num": 3,
    # assumed, not in the SURVEY: 197 position rows, the target, the
    # activation, the dropout (not applied by encode)
    "max_seq_length": 197, "target": ["cls"], "hidden_act": "gelu",
    "dropout": 0.1,
}
EXTRACT_ITEMS, EXTRACT_FRAMES, EXTRACT_BATCH = 8, 16, 32
EXTRACT_TAGS = (5, 20)
TEXT_SEQ = 196
# K4 on against K4 off on the same items, float32: only the attention's
# order of summation differs, and 12 layers carry those ~1e-7 relative
# differences into features of magnitude ~1-5
EXTRACT_TOL = 1e-3


def synthetic_vocab(path: str, rng) -> list:
    """A Unigram vocabulary (token<TAB>score) with XLM-R's specials at ids
    0-3, the letters, 1,500 whole words and 400 two- and three-letter
    pieces; returns 2,000 words, a quarter of them not whole pieces."""
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = sorted({"".join(rng.choice(letters, n))
                    for n in rng.integers(3, 9, size=2400)})[:2000]
    pieces = ["<s>", "<pad>", "</s>", "<unk>"] + letters
    pieces += ["\u2581" + c for c in letters]
    pieces += ["\u2581" + w for w in words[:1500]]
    pieces += ["".join(rng.choice(letters, n)) for n in (2, 3)
               for _ in range(200)]
    seen, lines = set(), []
    for p in pieces:
        if p not in seen:
            seen.add(p)
            lines.append(f"{p}\t{-rng.uniform(1.0, 12.0):.4f}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return words


def tower_checkpoint(raw: dict, path: str, seed: int, dev) -> int:
    """Seeded weights of one tower, saved as a reference-keyed `.bin`;
    returns the parameter count."""
    model = TowerModel(TowerConfig.from_dict(raw), device=dev)
    init_tower_weights(model, torch.Generator(device=dev).manual_seed(seed))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    return sum(p.numel() for p in model.parameters())


def extract_path(args, dev, card_line: str) -> int:
    """Phase 10: the CLI's per-item loop (preprocess.extract_items) over
    synthetic items with both towers at full width, K4 on; then the same
    items with K4 off."""
    rng = np.random.default_rng(args.seed + 9)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, raw in (("text", XLMR_BASE), ("vit", VIT_B16)):
            paths[name] = os.path.join(tmp, f"{name}_config.json")
            with open(paths[name], "w") as f:
                json.dump({**raw, "pallas_attention": True}, f)
        n_params = {name: tower_checkpoint(raw, os.path.join(tmp, f"{name}"
                                                             ".bin"),
                                           args.seed + 10 + i, dev)
                    for i, (name, raw) in enumerate((("text", XLMR_BASE),
                                                     ("vit", VIT_B16)))}
        words = synthetic_vocab(os.path.join(tmp, "vocab.tsv"), rng)
        tok = XLMRobertaTokenizer(vocab_path=os.path.join(tmp, "vocab.tsv"))
        text_cfg = TowerConfig.from_json(paths["text"])
        vit_cfg = TowerConfig.from_json(paths["vit"])
        states = {name: encoder_state(load_tower_checkpoint(
            os.path.join(tmp, f"{name}.bin"))) for name in ("text", "vit")}
    text_x = TextFeatureExtractor(text_cfg, states["text"], tok, TEXT_SEQ,
                                  device=dev)
    img_x = ImageFeatureExtractor(vit_cfg, states["vit"], device=dev)

    items, frames = [], {}
    for i in range(EXTRACT_ITEMS):
        n_tags = int(rng.integers(EXTRACT_TAGS[0], EXTRACT_TAGS[1] + 1))
        tags = [" ".join(rng.choice(words, int(rng.integers(1, 7))))
                for _ in range(n_tags)]
        items.append({"id": f"item{i}", "tags": [
            {"tag": t, "target": int(rng.integers(0, 3))} for t in tags]})
        frames[f"item{i}"] = rng.random(
            (EXTRACT_FRAMES, 3, vit_cfg.image_height, vit_cfg.image_width),
            dtype=np.float32)
    tokens = [int((text_x.prepare([t["tag"] for t in it["tags"]])[1] > 0)
                  .sum(1).max()) for it in items]

    def run(tx, ix):
        feats = {}
        res = preprocess.extract_items(
            items, lambda item: frames[item["id"]],
            lambda iid, t, im: feats.__setitem__(iid, (t, im)), tx, ix,
            EXTRACT_BATCH, log=lambda line: None)
        return feats, res

    reset_launches()
    feats, res = run(text_x, img_x)
    torch.cuda.synchronize()
    launches = fused_attention.launches
    by_path = dict(fused_attention.path_launches)

    text_calls = sum(math.ceil(len(it["tags"]) / EXTRACT_BATCH)
                     for it in items)
    image_calls = EXTRACT_ITEMS * math.ceil(EXTRACT_FRAMES / EXTRACT_BATCH)
    # one launch per layer per encode
    want = (text_cfg.layers_num * text_calls
            + vit_cfg.layers_num * image_calls)
    # both towers' sequences (196 tokens, 197 patches) take the short path
    if (res["items"] != EXTRACT_ITEMS or launches != want
            or by_path != {"short": want, "long": 0}):
        raise AssertionError(f"{res['items']} items, fused_attention "
                             f"launched {launches} times ({by_path}), "
                             f"expected {want} on the short path "
                             f"({text_calls} text and {image_calls} image "
                             "encodes)")
    for it in items:
        t, im = feats[it["id"]]
        if not (t.shape == (len(it["tags"]), TEXT_SEQ, text_cfg.hidden_size)
                and im.shape == (EXTRACT_FRAMES, vit_cfg.hidden_size)
                and np.isfinite(t).all() and np.isfinite(im).all()):
            raise AssertionError(f"{it['id']}: text {t.shape}, img "
                                 f"{im.shape}, or not finite")

    # the same items with the kernel off: the plain attention on the card
    text_off = TextFeatureExtractor(
        dataclasses.replace(text_cfg, pallas_attention=False),
        states["text"], tok, TEXT_SEQ, device=dev)
    img_off = ImageFeatureExtractor(
        dataclasses.replace(vit_cfg, pallas_attention=False), states["vit"],
        device=dev)
    reset_launches()
    feats_off, _ = run(text_off, img_off)
    if fused_attention.launches != 0:
        raise AssertionError("pallas_attention off still launched the "
                             "kernel")
    err = {kind: max(float(np.abs(feats[k][j] - feats_off[k][j]).max())
                     for k in feats) for j, kind in enumerate(("text",
                                                               "img"))}
    spread = {kind: max(float(np.abs(feats_off[k][j]).max()) for k in feats)
              for j, kind in enumerate(("text", "img"))}
    if not max(err.values()) <= EXTRACT_TOL:
        raise AssertionError(f"K4 on vs off: max abs diff {err} above "
                             f"{EXTRACT_TOL}")

    emit(phase="extract", params=n_params, items=res["items"],
         tags=sum(len(it["tags"]) for it in items),
         max_real_tokens_per_item=tokens, frames_per_item=EXTRACT_FRAMES,
         text_encodes=text_calls, image_encodes=image_calls,
         kernel_launches=launches, kernel_launches_by_path=by_path,
         k4_on_vs_off_max_abs_err=err, feature_max_abs=spread,
         tolerance=EXTRACT_TOL, card=card_line)
    return launches


# (rows, K, N, x dtype, out dtype) of phase 11; the two fc2 sites are timed
K2_SHAPES = {
    "ragged": (1040, 256, 128, torch.float32, torch.float32),
    "rollout": (ROLLOUT_ROWS, H, D, torch.bfloat16, torch.bfloat16),
    "serve": (SERVE_ROWS, H, D, torch.bfloat16, torch.bfloat16),
    "serve_f32": (SERVE_ROWS, H, D, torch.float32, torch.float32),
    "corner_k": (512, 49152, 128, torch.bfloat16, torch.bfloat16),
    "corner_n": (512, 2048, 3072, torch.bfloat16, torch.float32),
    "corner_kn": (512, 6144, 1024, torch.float32, torch.bfloat16),
}
K2_TIMED = ("rollout", "serve")


@contextmanager
def int8_routing(**constants):
    """Set ops/int8.py's routing constants (FUSED_FFN, NARROW_SITES, the
    size gates) for the block and restore them after it."""
    old = {k: getattr(int8_ops, k) for k in constants}
    for k, v in constants.items():
        setattr(int8_ops, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(int8_ops, k, v)


def check_k2(name: str, seed: int, dev, card_line: str) -> dict:
    """Phase 11, one shape: K2 against its plain version, bit for bit; at
    the fc2 sites its time beside the plain version, the two routes of
    int8_linear it stands beside (dequant + bf16 product, the default at a
    narrow site; the unfused s8 route: quantize_rows, torch._int_mm and the
    epilogue), torch._int_mm alone on operands already quantized, and the
    bound."""
    rows, k, n, in_dt, out_dt = K2_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, k, device=dev, generator=gen).to(in_dt)
    q, s = quantize_weight(torch.randn(n, k, device=dev, generator=gen)
                           * 0.05)
    got = int8_matmul(x, q, s, out_dt)
    torch.cuda.synchronize()
    ref = int8_matmul_reference(x, q, s, out_dt)
    res = {"shape": name, "rows": rows, "k": k, "n": n,
           "x_dtype": str(in_dt).replace("torch.", ""),
           "out_dtype": str(out_dt).replace("torch.", ""),
           "bit_equal": bool(torch.equal(got, ref)),
           "max_abs_err": float((got.float() - ref.float()).abs().max())}
    del got, ref
    if not res["bit_equal"]:
        emit(phase="k2_vs_plain", failed=True, **res)
        raise AssertionError(f"int8_matmul disagrees with its plain "
                             f"version: {res}")
    if name in K2_TIMED:
        res["ms"] = cuda_ms(lambda: int8_matmul(x, q, s, out_dt))
        res["plain_ms"] = cuda_ms(
            lambda: int8_matmul_reference(x, q, s, out_dt), iters=3, warmup=1)
        res["dequant_bf16_route_ms"] = cuda_ms(
            lambda: int8_ops.int8_linear(x, q, s, out_dt))
        with int8_routing(INT8_DYNQUANT_MIN_WIDTH=0):
            res["s8_route_ms"] = cuda_ms(
                lambda: int8_ops.int8_linear(x, q, s, out_dt))
        xq, _ = quantize_rows(x.float())
        res["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(xq, q.t()))
        del xq
        ops = 2 * rows * k * n
        res["kernel_tops"] = ops / (res["ms"] * 1e-3) / 1e12
        nbytes = (rows * k * x.element_size() + n * k + 4 * n
                  + rows * n * torch.tensor([], dtype=out_dt).element_size())
        res.update(bound(nbytes, ops, INT8_TENSOR_OPS_PER_S))
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["card"] = card_line
    emit(phase="k2_vs_plain", **res)
    return res


def k2_kernel(seed: int, dev, card_line: str) -> dict:
    """Phase 11: every shape; returns the runs by name."""
    out = {name: check_k2(name, seed + i, dev, card_line)
           for i, name in enumerate(K2_SHAPES)}
    torch.cuda.empty_cache()
    return out


# Phase 22, AdamW at the main path's shapes: the actor's and the critic's
# `out_layer` weight (162,816 fan-in) under --profile fast, float32
# parameters (the compute dtype is bfloat16) and gradients with bfloat16
# moments, and XLM-R base's word table in tower pretraining, all float32;
# each also with bfloat16 parameters and gradients; then both models' whole
# sets, one update
ADAMW_TENSORS = {
    "out_layer": ((3072, 162816), torch.float32, torch.bfloat16),
    "out_layer_bf16": ((3072, 162816), torch.bfloat16, torch.bfloat16),
    "xlmr_word": ((250002, 768), torch.float32, torch.float32),
    "xlmr_word_bf16": ((250002, 768), torch.bfloat16, torch.float32)}
# lr, b1, b2, eps, weight decay and step scale: lr 1e-4, OptimConfig's
# defaults besides
ADAMW_HYPER = (1e-4, 0.9, 0.999, 1e-6, 0.01, 1.0)
# float32 operations an element (the clip's two left out), counted against
# the card's float32 rate: far below the bytes' bound
ADAMW_OPS = 20


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so -0 and +0 differ."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def adamw_bytes(p: torch.Tensor, m: torch.Tensor) -> int:
    """What an AdamW step must move: p, its gradient (p's dtype), m and v
    read once, p, m and v written once."""
    return p.numel() * (3 * p.element_size() + 4 * m.element_size())


def adamw_inputs(shape, p_dtype, m_dtype, seed: int, dev) -> tuple:
    """Seeded p, g, m and v (v positive) at the scales of a trained
    model's."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(scale, dtype):
        return (torch.randn(shape, device=dev, generator=gen)
                * scale).to(dtype)
    v = draw(1e-4, torch.float32).square_().to(m_dtype)
    return (draw(0.02, p_dtype), draw(1e-3, p_dtype), draw(1e-4, m_dtype),
            v)


def fused_adamw_ms(params: list, grads: list) -> float:
    """torch.optim.AdamW(fused=True) over the same tensors (its state in
    their dtype): the library's yardstick, timed only; the port never calls
    it."""
    lr, b1, b2, eps, wd, _ = ADAMW_HYPER
    wrapped = [torch.nn.Parameter(p) for p in params]
    for w, g in zip(wrapped, grads):
        w.grad = g
    opt = torch.optim.AdamW(wrapped, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=wd, fused=True)
    ms = cuda_ms(opt.step, iters=5, warmup=1)
    del opt
    torch.cuda.empty_cache()
    return ms


def check_adamw(name: str, seed: int, dev, card_line: str) -> dict:
    """Phase 22, one tensor: the AdamW kernel against its plain version
    over 3 steps, p, m and v bit for bit, one launch a step; then its time
    beside the plain version's, the fused library step's and the bound."""
    shape, p_dtype, m_dtype = ADAMW_TENSORS[name]
    p, g, m, v = adamw_inputs(shape, p_dtype, m_dtype, seed, dev)
    rp, rm, rv = p.clone(), m.clone(), v.clone()
    before = adamw.launches
    for _ in range(3):
        adamw(p, g, m, v, *ADAMW_HYPER)
        adamw_reference(rp, g, rm, rv, *ADAMW_HYPER)
    torch.cuda.synchronize()
    pairs = (("p", p, rp), ("m", m, rm), ("v", v, rv))
    res = {"tensor": name, "shape": list(shape),
           "dtype": str(p_dtype).replace("torch.", ""),
           "moment_dtype": str(m_dtype).replace("torch.", ""),
           "launches": adamw.launches - before,
           "bit_equal": {k: bool(torch.equal(bits(a), bits(b)))
                         for k, a, b in pairs},
           "max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for _, a, b in pairs)}
    del rp, rm, rv, pairs
    if res["launches"] != 3 or not all(res["bit_equal"].values()):
        emit(phase="adamw_vs_plain", failed=True, **res)
        raise AssertionError(f"the AdamW kernel disagrees with its plain "
                             f"version: {res}")
    res["ms"] = cuda_ms(lambda: adamw(p, g, m, v, *ADAMW_HYPER))
    res["plain_ms"] = cuda_ms(lambda: adamw_reference(p, g, m, v,
                                                      *ADAMW_HYPER),
                              iters=3, warmup=1)
    torch.cuda.empty_cache()
    res["library_ms"] = fused_adamw_ms([p], [g])
    res.update(bound(adamw_bytes(p, m), ADAMW_OPS * p.numel(),
                     VECTOR_OPS_PER_S))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["card"] = card_line
    emit(phase="adamw_vs_plain", **res)
    return res


def adamw_update_set(seed: int, dev, card_line: str) -> dict:
    """Phase 22, one update's AdamW: the actor's and the critic's steps at
    the flagship width under --profile fast (float32 parameters and
    gradients, bfloat16 moments; the decay mask of each model), the port's
    AdamW.step on seeded tensors. Two steps against the plain version bit
    for bit and one launch a tensor; then the two steps' time (CUDA
    events, the host's launching included), the host's time to enqueue
    them, the kernels' device time in a trace, the plain version's time,
    the fused library step's and the bound."""
    cfg = train_config("", seed)
    lr, b1, b2, eps, wd, _ = ADAMW_HYPER
    sets = []
    for i, cls in enumerate((ScoreModel, SeqScoreModel)):
        model = cls(cfg.model, torch.bfloat16, device="meta")
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        params = {k: torch.randn(p.shape, device=dev, generator=gen) * 0.02
                  for k, p in model.named_parameters()}
        grads = {k: torch.randn(p.shape, device=dev, generator=gen) * 1e-3
                 for k, p in params.items()}
        opt = AdamW(params, lambda t: lr, b1, b2, eps, wd,
                    moment_dtype=getattr(torch, cfg.optim.moment_dtype),
                    no_decay=no_decay_names(model))
        sets.append((opt, grads))
    tensors = sum(len(o.params) for o, _ in sets)
    numel = sum(p.numel() for o, _ in sets for p in o.params.values())
    nbytes = sum(adamw_bytes(p, o.mu[k]) for o, _ in sets
                 for k, p in o.params.items())

    def both():
        for o, gr in sets:
            o.step(gr)

    plain = [({k: p.clone() for k, p in o.params.items()},
              {k: t.clone() for k, t in o.mu.items()},
              {k: t.clone() for k, t in o.nu.items()}) for o, _ in sets]

    def plain_both():
        for (o, gr), (ps, ms, vs) in zip(sets, plain):
            for k, p in ps.items():
                adamw_reference(p, gr[k], ms[k], vs[k], lr, b1, b2, eps,
                                wd if decays(k, o.no_decay) else 0.0, 1.0)

    before = adamw.launches
    for _ in range(2):
        both()
        plain_both()
    torch.cuda.synchronize()
    equal = all(torch.equal(bits(a), bits(b))
                for (o, _), (ps, ms, vs) in zip(sets, plain)
                for mine, theirs in ((o.params, ps), (o.mu, ms), (o.nu, vs))
                for a, b in ((mine[k], theirs[k]) for k in mine))
    res = {"tensors": tensors, "params": numel,
           "launches_per_update": (adamw.launches - before) / 2,
           "bit_equal": equal}
    if not equal or res["launches_per_update"] != tensors:
        emit(phase="adamw_update_set", failed=True, **res)
        raise AssertionError(f"one update's AdamW disagrees with its plain "
                             f"version or launched other than once a "
                             f"tensor: {res}")
    res["ms"] = cuda_ms(both, iters=5, warmup=1)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        both()
        host.append((time.perf_counter() - t0) * 1e3)
    res["host_ms"] = statistics.median(host)
    res["trace_ms"] = sum(traced_ms(steady_trace(both), "adamw"))
    res["plain_ms"] = cuda_ms(plain_both, iters=3, warmup=1)
    del plain
    torch.cuda.empty_cache()
    res["library_ms"] = fused_adamw_ms(
        [p for o, _ in sets for p in o.params.values()],
        [gr[k] for o, gr in sets for k in o.params])
    res.update(bound(nbytes, ADAMW_OPS * numel, VECTOR_OPS_PER_S))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["bound_share_trace"] = res["bound_ms"] / res["trace_ms"]
    res["card"] = card_line
    emit(phase="adamw_update_set", **res)
    return res


def adamw_kernel(seed: int, dev, card_line: str) -> dict:
    """Phase 22: the AdamW kernel at each tensor of ADAMW_TENSORS and over
    one update's whole set; returns the runs by name."""
    out = {}
    for i, name in enumerate(ADAMW_TENSORS):
        out[name] = check_adamw(name, seed + i, dev, card_line)
        torch.cuda.empty_cache()
    out["update"] = adamw_update_set(seed, dev, card_line)
    torch.cuda.empty_cache()
    return out


MLA_SHAPE = (8, 16, 8192, 192, 128)
MLA_FWD_GAP, MLA_GRAD_GAP, MLA_ELEMENT_GAP = 1e-2, 2e-2, 6e-2
# the Triton backward's time at MLA_SHAPE on an H100 at 700 W, before the
# CUDA backward replaced it (PERF.md's kernel table)
MLA_TRITON_BWD_MS = 24.876
# the CUDA backward's tiles (kernels/csrc/mla_attention_bwd.cu)
MLA_BWD_TILES = {"keys_a_block": 128, "keys_a_warpgroup": 64,
                 "queries_a_stage": 64, "stages": 2, "threads": 256}
MLA_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "perfbench", "configs", "moonlight-16b-a3b-ep8.json")


def mla_check(q, k, v, do, scale: float) -> dict:
    """The kernel's output and gradients (do given) against the plain
    version's on the same inputs, one sequence at a time: per result the
    norm-relative gap over the batch and the worst element over the plain
    result's largest magnitude; raises past the card test's gaps."""
    from lr2ppo_torch.ops.mla_attention import (mla_attention,
                                                reference_mla_attention)

    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = mla_attention(*qkv, scale)
    o.backward(do)
    got = [o.detach(), *(t.grad for t in qkv)]
    del o, qkv
    sums = [[0.0, 0.0, 0.0, 0.0] for _ in got]   # |d|², |w|², max|d|, max|w|
    for i in range(q.shape[0]):
        one = [t[i:i + 1].detach() for t in (q, k, v)]
        with torch.no_grad():
            want = [reference_mla_attention(*one, scale)]
        ref = [t.float().requires_grad_(True) for t in one]
        reference_mla_attention(*ref, scale).backward(do[i:i + 1].float())
        want += [t.grad for t in ref]
        for acc, g, w in zip(sums, got, want):
            g, w = g[i:i + 1].float(), w.float()
            d = g - w
            acc[0] += float(d.square().sum())
            acc[1] += float(w.square().sum())
            acc[2] = max(acc[2], float(d.abs().max()))
            acc[3] = max(acc[3], float(w.abs().max()))
        del one, ref, want
        torch.cuda.empty_cache()
    out = {}
    for name, acc, gap in zip(("o", "dq", "dk", "dv"), sums,
                              (MLA_FWD_GAP,) + (MLA_GRAD_GAP,) * 3):
        rel = math.sqrt(acc[0] / max(acc[1], 1e-30))
        el = acc[2] / max(acc[3], 1e-30)
        out[name] = {"rel": rel, "element": el, "limit": gap}
        if not (rel < gap and el < MLA_ELEMENT_GAP):
            raise AssertionError(f"mla_attention's {name} disagrees with its "
                                 f"plain version: {out[name]}")
    return out


def mla_tower_step(seed: int, dev, rows: int = 8, tokens: int = 8192) -> dict:
    """One training step of the moe-lm-s8192 cell's tower at its 8 x 8,192
    tokens (forward with remat, backward, the correction-bias update),
    the kernel's counters set to 0 before it; raises unless every
    attention call took the kernel and every MoE layer routes over the
    router's 64 experts and computes its 8."""
    from lr2ppo_torch.ops.mla_attention import mla_attention
    from lr2ppo_torch.towers.model import (TowerConfig, TowerModel,
                                           init_weights as init_tower)
    from lr2ppo_torch.towers.moe import MoeFeedForward

    with open(MLA_CONFIG) as f:
        cfg = TowerConfig.from_dict(json.load(f))
    model = TowerModel(cfg, torch.bfloat16, dev, with_target=True)
    init_tower(model, torch.Generator(device=dev).manual_seed(seed))
    moe = [m for m in model.modules() if isinstance(m, MoeFeedForward)]
    routing = sorted({(m.gate.out_features, len(m.held)) for m in moe})
    g = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randint(5, cfg.vocab_size, (rows, tokens), generator=g,
                        device=dev)
    tgt, seg = torch.roll(src, -1, 1), torch.ones_like(src)
    mla_attention.launches = mla_attention.plain_calls = 0
    mla_attention.kernel_calls = {"fwd": 0, "bwd": 0}
    loss = model(src, tgt, seg, deterministic=False)[0]
    loss.backward()
    model.after_update()
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach()),
           "layers": cfg.layers_num, "moe_layers": len(moe),
           "routing": routing, "launches": mla_attention.launches,
           "kernel_calls": dict(mla_attention.kernel_calls),
           "plain_calls": mla_attention.plain_calls}
    n = cfg.layers_num
    if (out["launches"] != 5 * n or out["plain_calls"]
            or out["kernel_calls"] != {"fwd": 2 * n, "bwd": n}
            or routing != [(64, 8)] or len(moe) != n - 1
            or not math.isfinite(out["loss"])):
        raise AssertionError(f"the tower step missed the kernel or the "
                             f"experts: {out}")
    del model, loss
    return out


def mla_kernel(seed: int, dev, card_line: str, built: dict) -> dict:
    """Phase 23: the causal attention kernels' forward and backward at
    MLA_SHAPE, their bound, the plain version's and SDPA's times, the
    backward's tiles and ptxas report (from `built`, build.build()'s
    result), the kernels against the plain version there, and the launches
    of one step of the Moonlight tower."""
    import torch.nn.functional as F

    from lr2ppo_torch.ops.mla_attention import (mla_attention,
                                                reference_mla_attention)

    b, h, s, dqk, dv = MLA_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(b, h, s, dqk, generator=g, device=dev)
            .to(torch.bfloat16).requires_grad_(True) for _ in range(2))
    v = torch.randn(b, h, s, dv, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    do = torch.randn(b, h, s, dv, generator=g, device=dev).to(torch.bfloat16)
    scale = dqk ** -0.5
    pairs = b * h * s * (s + 1) / 2
    ops_fwd, ops_bwd = 2 * pairs * (dqk + dv), 2 * pairs * (3 * dqk + 2 * dv)
    out = {"shape": list(MLA_SHAPE)}

    def fwd():
        with torch.no_grad():
            mla_attention(q, k, v, scale)

    o = mla_attention(q, k, v, scale)

    def bwd():
        torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

    out["fwd_ms"] = cuda_ms(fwd, iters=5)
    out["bwd_ms"] = cuda_ms(bwd, iters=5)
    for part, ops in (("fwd", ops_fwd), ("bwd", ops_bwd)):
        out[part + "_bound_ms"] = ops / BF16_TENSOR_OPS_PER_S * 1e3
        out[part + "_share"] = out[part + "_bound_ms"] / out[part + "_ms"]
    out["bwd_triton_ms"] = MLA_TRITON_BWD_MS
    out["bwd_tiles"] = MLA_BWD_TILES
    log = built.get("mla_attention_bwd", {}).get("log", "")
    out["bwd_ptxas"] = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln] or "reused"
    del o

    def plain_fwd():
        with torch.no_grad():
            for i in range(b):
                reference_mla_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        scale)

    def plain_bwd():
        for i in range(b):
            qi, ki, vi = (t[i:i + 1].detach().requires_grad_(True)
                          for t in (q, k, v))
            torch.autograd.grad(reference_mla_attention(qi, ki, vi, scale),
                                (qi, ki, vi), do[i:i + 1])

    out["plain_fwd_ms"] = cuda_ms(plain_fwd, iters=2, warmup=1)
    out["plain_fwd_bwd_ms"] = cuda_ms(plain_bwd, iters=2, warmup=1)
    torch.cuda.empty_cache()
    try:
        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=scale)

        so = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                            scale=scale)

        def sdpa_bwd():
            torch.autograd.grad(so, (q, k, v), do, retain_graph=True)

        out["sdpa_fwd_ms"] = cuda_ms(sdpa_fwd, iters=5)
        out["sdpa_bwd_ms"] = cuda_ms(sdpa_bwd, iters=5)
        del so
    except RuntimeError as e:                 # no backend takes the shape
        out["sdpa"] = str(e)[:200]
    out["check"] = mla_check(q, k, v, do, scale)
    del q, k, v, do
    torch.cuda.empty_cache()
    out["tower_step"] = mla_tower_step(seed, dev)
    out["launches"] = out["tower_step"]["launches"]
    emit(phase="mla_attention", card=card_line, **out)
    torch.cuda.empty_cache()
    return out


STAGE_BS, STAGE_STEPS = 32, 4          # stages 1 and 2 of phase 12
NDCG_FULL = 100000000


def stage_config(tmp: str, name: str, seed: int, tags: int):
    """Stages 1 and 2 under --profile fast at batch 32, an eval after every
    step, one epoch."""
    return parse_config(["--profile", "fast", "--batch_size", str(STAGE_BS),
                         "--max_tags", str(tags), "--epochs_num", "1",
                         "--report_steps", "1", "--seed", str(seed),
                         "--output_model_path",
                         os.path.join(tmp, f"{name}.bin"),
                         "--log_path", os.path.join(tmp, f"{name}.log")])


def records(cfg) -> list:
    with open(cfg.log_path + ".jsonl") as f:
        return [json.loads(line) for line in f]


def watch_params(trainer, names):
    """Wrap trainer.init_model to keep the model it builds and copies of
    the parameters `names` as they start."""
    seen = {}
    real = trainer.init_model

    def init_model(seed):
        seen["model"] = model = real(seed)
        params = dict(model.named_parameters())
        seen["before"] = {k: params[k].detach().clone() for k in names}
        return model

    trainer.init_model = init_model
    return seen


def moved(seen) -> dict:
    params = dict(seen["model"].named_parameters())
    return {k: float((params[k].detach() - v).abs().max())
            for k, v in seen["before"].items()}


WATCHED = ("head.weight", "xit.0.0.1.fn.1.0.weight", "text_proj.fc2.weight")


def stage1(tmp: str, seed: int, dev, card_line: str, evb) -> str:
    """Phase 12, stage 1: PointwiseTrainer.fit at batch 32 x 32 tags, 4
    steps ('reg': SmoothL1), 6 hash-dropout launches a step (3 XiT sites,
    forward and backward); the best `.bin` reloaded strict."""
    cfg = stage_config(tmp, "stage1", seed, BUCKET)
    trainer = PointwiseTrainer(cfg, dev)
    seen = watch_params(trainer, WATCHED)
    loader = BatchList(item_batches(STAGE_STEPS, cfg.model, seed, STAGE_BS,
                                    BUCKET))
    hash_dropout.launches = 0
    state, best = trainer.fit(loader, evb)
    torch.cuda.synchronize()
    launches, steps = hash_dropout.launches, state.step
    recs = records(cfg)
    losses = [r["loss"] for r in recs]
    move = moved(seen)
    ScoreModel(cfg.model, trainer.dtype, device="meta").load_state_dict(
        load_any(cfg.output_model_path), strict=True, assign=True)
    emit(phase="stage1", steps=steps, losses=losses,
         ndcg_full=[r["ndcg_full"] for r in recs], best_ndcg_full=best,
         moved=move, hash_dropout_launches=launches, card=card_line)
    if not (steps == STAGE_STEPS and len(losses) == STAGE_STEPS
            and np.isfinite(losses).all() and 0.0 <= best <= 1.0
            and all(v > 0 for v in move.values())
            and launches == 6 * STAGE_STEPS):
        raise AssertionError(f"stage 1: {steps} steps, losses {losses}, "
                             f"best {best}, moved {move}, {launches} hash "
                             "dropout launches")
    return cfg.output_model_path


def reward_batches(n: int, mcfg: ModelConfig, seed: int, bs: int,
                   eval_mode: bool) -> list:
    """Stage-2 batches made with numpy: training pairs (2 tags, the chosen
    and rejected 4-index orderings with a fair coin swap,
    data/movienet.py's reward mode) or eval triples (one tag of each class,
    its reward_eval mode)."""
    def orderings(rng):
        if eval_mode:
            ch, rj = [], []
            for _ in range(bs):
                i, j = (int(v) for v in rng.permutation(3)[:2])
                right, wrong = [i, j, i, j], [i, j, j, i]
                ch.append(right if i >= j else wrong)
                rj.append(wrong if i >= j else right)
            return np.asarray(ch, np.int32), np.asarray(rj, np.int32)
        swap = rng.random(bs) < 0.5
        ch = np.where(swap[:, None], [1, 0, 0, 1], [0, 1, 0, 1])
        rj = np.where(swap[:, None], [1, 0, 1, 0], [0, 1, 1, 0])
        return ch.astype(np.int32), rj.astype(np.int32)

    batches = item_batches(n, mcfg, seed, bs, 3 if eval_mode else 2)
    rng = np.random.default_rng(seed + 1)
    for b in batches:
        b["chosen_index"], b["reject_index"] = orderings(rng)
        if eval_mode:                   # targets 0, 1, 2 in tag order
            b["tgts"] = np.broadcast_to(np.arange(3, dtype=np.int32),
                                        (bs, 3)).copy()
    return batches


def stage2(tmp: str, seed: int, dev, card_line: str) -> str:
    """Phase 12, stage 2: RewardTrainer.fit at batch 32 pairs, 4 steps, 24
    hash-dropout launches a step (two forwards of 6 sites, and their
    backward), the pairwise accuracy on 2 eval batches of 8; the best
    `.bin` reloaded strict into a SeqScoreModel."""
    cfg = stage_config(tmp, "stage2", seed, PAIR)
    trainer = RewardTrainer(cfg, dev)
    seen = watch_params(trainer, WATCHED)
    loader = BatchList(reward_batches(STAGE_STEPS, cfg.model, seed,
                                      STAGE_BS, False))
    evb = reward_batches(2, cfg.model, seed + 7, 8, True)
    hash_dropout.launches = 0
    state, best = trainer.fit(loader, evb)
    torch.cuda.synchronize()
    launches, steps = hash_dropout.launches, state.step
    recs = records(cfg)
    losses = [r["loss"] for r in recs]
    move = moved(seen)
    SeqScoreModel(cfg.model, trainer.dtype, device="meta").load_state_dict(
        load_any(cfg.output_model_path), strict=True, assign=True)
    emit(phase="stage2", steps=steps, losses=losses,
         accuracy=[r["acc"] for r in recs], best_accuracy=best, moved=move,
         hash_dropout_launches=launches, card=card_line)
    if not (steps == STAGE_STEPS and len(losses) == STAGE_STEPS
            and np.isfinite(losses).all() and 0.0 <= best <= 1.0
            and all(v > 0 for v in move.values())
            and launches == 24 * STAGE_STEPS):
        raise AssertionError(f"stage 2: {steps} steps, losses {losses}, "
                             f"best {best}, moved {move}, {launches} hash "
                             "dropout launches")
    return cfg.output_model_path


NARROW = {"FUSED_FFN": False, "NARROW_SITES": True}


def stage3(tmp: str, seed: int, dev, card_line: str, actor_bin: str,
           reward_bin: str, evb, eval_items) -> int:
    """Phase 12, stage 3 and ppo_eval: PPOTrainer.fit from the two `.bin`s,
    2 rollouts and one sweep of 2 updates, in K2's routing (4 launches a
    rollout, K1 none); one more rollout in that routing and one in the
    default one (4 K1 launches); then evaluate_cases on the best `.bin`.
    Returns K2's launches."""
    cfg = train_config(tmp, seed).replace(pretrained_model_path=actor_bin,
                                          reward_model_path=reward_bin)
    loader = SyntheticTrainLoader(cfg.model, seed, n=2)
    trainer = PPOTrainer(cfg, dev)
    built = {}

    def init_params(s):
        built["models"] = PPOTrainer.init_params(trainer, s)
        return built["models"]

    trainer.init_params = init_params
    with int8_routing(**NARROW):
        int8_matmul.launches = int8_mlp.launches = 0
        astate, cstate, best = trainer.fit(lambda epoch: loader, evb)
        torch.cuda.synchronize()
        launches = {"int8_matmul": int8_matmul.launches,
                    "int8_mlp": int8_mlp.launches}
    recs = records(cfg)
    losses = [[r["policy_loss"], r["value_loss"]] for r in recs
              if "policy_loss" in r]
    if not (launches == {"int8_matmul": 4 * 2, "int8_mlp": 0}
            and astate.step == cstate.step == 2 and len(losses) == 1
            and np.isfinite(losses).all() and np.isfinite(best)):
        raise AssertionError(f"stage 3: launches {launches}, "
                             f"{astate.step}/{cstate.step} updates, losses "
                             f"{losses}, best {best}")

    actor, critic, reward = built["models"]
    twin = frozen_copy(ScoreModel, cfg.model, actor.state_dict(),
                       trainer.dtype, True)
    roll = make_rollout_step(cfg.model.mode)
    b = trainer.ctx.put(loader.batches[0])
    st = trainer.ctx.put_array(np.broadcast_to(
        np.arange(PAIR, dtype=np.int32), (TRAIN_BS, PAIR)).copy())

    def rollout():
        roll(twin, critic, reward, b["text"], b["img"], st)

    with int8_routing(**NARROW):
        int8_matmul.launches = 0
        rollout()
        torch.cuda.synchronize()
        per_rollout = int8_matmul.launches
    int8_mlp.launches = 0
    rollout()
    k1_per_rollout = int8_mlp.launches
    del twin, b
    if per_rollout != 4 or k1_per_rollout != 4:
        raise AssertionError(f"a rollout launched K2 {per_rollout} times "
                             f"in its routing and K1 {k1_per_rollout} times "
                             "in the default one; expected 4 each")

    # ppo_eval: the stage-3 best .bin through load_any, strict
    sd = load_any(cfg.output_model_path, kind="actor_critic")
    model = ScoreModel(cfg.model, trainer.dtype, device=dev)
    model.load_state_dict(sd["actor"], strict=True)
    del sd
    path = os.path.join(tmp, "cases.json")
    result = evaluate_cases(model, eval_items, evb, path, trainer.ctx.put)
    with open(path) as f:
        cases = json.load(f)
    keys = {"pred_order", "pred_scores", "gold", "gold_rearranged", "ndcg",
            "id", "tags", "tags_rearranged"}
    n_items = sum(int(np.asarray(bt["mask"]).any(1).sum()) for bt in evb)
    good = all(set(c) == keys and sorted(c["pred_order"])
               == list(range(len(c["gold"])))
               and [c["gold"][j] for j in c["pred_order"]]
               == c["gold_rearranged"] for c in cases)
    emit(phase="stage3", rollouts=2, updates=int(astate.step),
         kernel_launches=launches, sweep_losses=losses, best_ndcg_full=best,
         k2_launches_per_rollout=per_rollout, ppo_eval_cases=len(cases),
         ppo_eval_ndcg_full=result[NDCG_FULL],
         ppo_eval_vs_best=abs(result[NDCG_FULL] - best), card=card_line)
    if not (len(cases) == n_items and good
            and abs(result[NDCG_FULL] - best) <= 1e-6):
        raise AssertionError(f"ppo_eval: {len(cases)} cases for {n_items} "
                             f"items, schema ok {good}, NDCG "
                             f"{result[NDCG_FULL]} against the best {best}")
    return launches["int8_matmul"]


def served_narrow(served: dict, dev, card_line: str) -> int:
    """Phase 12, last: one served batch of phase 4's int8 model in K2's
    routing (2 launches: text_proj and the XiT FFN's fc2), its scores
    within phase 4's gate of the same weights served in bfloat16."""
    ds = served["ds"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("int8", "bfloat16"):
            paths[name] = os.path.join(tmp, f"{name}.jsonl")
            with int8_routing(**NARROW), open(paths[name], "w") as sink:
                if name == "int8":
                    int8_matmul.launches = 0
                serve.serve_batches(served[name], [served["batch"]], ds,
                                    sink, dev)
                if name == "int8":
                    launches = int8_matmul.launches
        got = read_rankings(paths["int8"], ds)
        ref = read_rankings(paths["bfloat16"], ds)
    spread = max(float(np.abs(v).max()) for v in ref.values())
    err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
    emit(phase="serve_narrow", kernel_launches=launches, items=len(got),
         int8_vs_bf16_max_err=err, score_spread=spread, card=card_line)
    if launches != 2 or not err < 0.05 * spread:
        raise AssertionError(f"served batch in K2's routing: {launches} "
                             f"launches, error {err}, spread {spread}")
    return launches


def recipe_path(args, dev, card_line: str, served: dict) -> int:
    """Phase 12: stages 1, 2 and 3, ppo_eval and a served batch; returns
    K2's launches on these paths."""
    mcfg = ModelConfig()
    evb, eval_items = synthetic_batches(2, mcfg, args.seed + 20, items=8,
                                        bucket=8, tags=(2, 8))
    with tempfile.TemporaryDirectory() as tmp:
        actor_bin = stage1(tmp, args.seed + 21, dev, card_line, evb)
        torch.cuda.empty_cache()
        reward_bin = stage2(tmp, args.seed + 22, dev, card_line)
        torch.cuda.empty_cache()
        launches = stage3(tmp, args.seed + 23, dev, card_line, actor_bin,
                          reward_bin, evb, eval_items)
    torch.cuda.empty_cache()
    return launches + served_narrow(served, dev, card_line)


# Phase 13: the tabular (LETOR) recipe. MQ2008 and MSLR-Web10K in their
# published shapes (SURVEY.md section 5): (training rows, features,
# relevance labels, mean documents a query). The Web10K file is cut from
# 723,412 rows to 60,000 (about 500 queries of ~120 documents) to keep the
# phase inside the time limit; every query is resampled to 20 documents, as
# convert_to_h5py.py does.
LETOR_SHAPES = {"mq2008": (9630, 46, 3, 20), "web10k": (60000, 136, 5, 120)}
LETOR_DOCS = 20
TAB_BS, TAB_STEPS = 32, 4        # the 2-data trainer and stages 1 and 2
TAB_ROLLOUTS = 4                 # stage 3: 2 sweeps of 2 updates
WEB10K_PROJECTED = 50            # Web10K queries projected for the merged set
XIT_SITES = 3                    # dropout sites of one XiT block
TAB_WATCHED = ("head.weight", "xit.0.0.1.fn.1.0.weight",
               "out_layer.fc1.weight")


class Capped:
    """A loader's first `n` batches of every epoch: the phase caps each
    trainer's run by its loader, as phase 7 caps PPO's with its list of
    batches. Everything else is the loader's."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def __len__(self):
        return min(self.n, len(self.loader))

    def __iter__(self):
        return islice(iter(self.loader), self.n)

    def __getattr__(self, name):
        return getattr(self.loader, name)


def letor_svmlight(path: str, name: str, seed: int) -> None:
    """Write an svmlight file in the shape of LETOR dataset `name`: queries
    of half to one and a half times the mean document count, standard
    normal features, and each query's labels the quantiles of a hidden
    linear score plus noise, so that NDCG can move."""
    rows, feat, labels, mean = LETOR_SHAPES[name]
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < rows:
        sizes.append(int(rng.integers(mean // 2, mean * 3 // 2 + 1)))
    sizes[-1] -= sum(sizes) - rows
    x = rng.standard_normal((rows, feat)).astype(np.float32)
    w = rng.standard_normal(feat)
    score = x @ w + 0.5 * np.linalg.norm(w) * rng.standard_normal(rows)
    label = np.zeros(rows)
    for start, n in zip(np.cumsum([0] + sizes[:-1]), sizes):
        rank = np.argsort(np.argsort(-score[start:start + n])) / n
        label[start:start + n] = labels - 1 - np.floor(rank * labels)
    qid = np.repeat(np.arange(1, len(sizes) + 1), sizes)
    np.savetxt(path, np.column_stack([label, qid, x]), delimiter=" ",
               fmt=["%d", "qid:%d"] + [f"{j + 1}:%.6g" for j in range(feat)])


def split_queries(groups: dict, test_qids=None):
    """(train, test) LetorQueries: the queries of `test_qids`, or every
    tenth query, held out."""
    qids = sorted(groups)
    test = set(qids[::10] if test_qids is None else test_qids)
    return (LetorQueries({q: g for q, g in groups.items() if q not in test}),
            LetorQueries({q: g for q, g in groups.items() if q in test}))


def letor_offline(tmp: str, seed: int, card_line: str) -> dict:
    """Phase 13, step 1: both svmlight files through preprocess_data
    svm2tsv (the native parser), each parse equal to the numpy parser's on
    the same file; disjoint on MQ2008's qids, then check; grouping to 20
    documents. Returns the tsv paths and the grouped (train, test) queries
    of each dataset."""
    res, out = {}, {}
    for i, name in enumerate(LETOR_SHAPES):
        rows, feat, labels, _ = LETOR_SHAPES[name]
        svm, tsv = (os.path.join(tmp, f"{name}.{ext}")
                    for ext in ("svm", "tsv"))
        letor_svmlight(svm, name, seed + i)
        native = parse_svmlight_file(svm, feat)
        plain = parse_svmlight_file(svm, feat, use_native=False)
        preprocess_data.main(["svm2tsv", svm, tsv, "--num_features",
                              str(feat)])
        arr = read_tsv(tsv)
        res[name] = {"rows": rows, "features": feat,
                     "queries": len(np.unique(native[:, 1])),
                     "native_equals_numpy": bool(np.array_equal(native,
                                                                plain)),
                     "tsv_equals_parse": bool(np.array_equal(arr, native)),
                     "labels": sorted(np.unique(native[:, 0]).tolist())}
        out[name] = (tsv, arr)
        if not (res[name]["native_equals_numpy"]
                and res[name]["tsv_equals_parse"]
                and native.shape == (rows, 2 + feat)
                and res[name]["labels"] == list(range(labels))):
            raise AssertionError(f"the {name} parse: {res[name]}")
    disjoint = os.path.join(tmp, "mq2008_disjoint.tsv")
    preprocess_data.main(["disjoint", out["mq2008"][0], disjoint])
    out["mq2008"] = (disjoint, read_tsv(disjoint))
    # exits 1 where the two share a qid
    preprocess_data.main(["check", disjoint, out["web10k"][0]])
    for name, (tsv, arr) in out.items():
        out[name] = (tsv, split_queries(group_queries(arr, LETOR_DOCS)))
    emit(phase="tabular_offline", **res, card=card_line)
    return out


def tab_config(tmp: str, name: str, seed: int, *flags):
    """A tabular stage under --profile fast, one epoch."""
    return force_family(parse_config(
        ["--profile", "fast", "--epochs_num", "1", "--seed", str(seed),
         "--output_model_path", os.path.join(tmp, f"{name}.bin"),
         "--log_path", os.path.join(tmp, f"{name}.log"), *flags]), "tabular")


def tab_fit(phase: str, trainer, fit, model_cls, want_steps: int,
            xit_blocks: int, card_line: str, watched=TAB_WATCHED, **extra):
    """One tabular training stage: `fit()` with hash dropout's count set to
    0 just before it and read just after; the best `.bin` reloaded strict
    into `model_cls`; the stage's line. Checks every step taken with a
    finite loss, the watched parameters moved, and 2 · 3 hash dropout
    launches a step for each XiT block a step runs (forward and backward, 3
    sites a block). Returns (state, launches)."""
    seen = watch_params(trainer, watched)
    hash_dropout.launches = 0
    state, best = fit()
    torch.cuda.synchronize()
    launches, steps = hash_dropout.launches, state.step
    recs = records(trainer.cfg)
    losses = [r["loss"] for r in recs if "loss" in r]
    move = moved(seen)
    model_cls(trainer.cfg.model, trainer.dtype, device="meta").load_state_dict(
        load_any(trainer.cfg.output_model_path), strict=True, assign=True)
    evals = {k: [r[k] for r in recs if k in r] for k in ("ndcg_full", "acc")}
    emit(phase=phase, params=sum(p.numel() for p in state.model.parameters()),
         steps=steps, losses=losses, **{k: v for k, v in evals.items() if v},
         best=best, moved=move, hash_dropout_launches=launches,
         card=card_line, **extra)
    want_launches = 2 * XIT_SITES * xit_blocks * want_steps
    if not (steps == want_steps == len(losses) and np.isfinite(losses).all()
            and 0.0 <= best <= 1.0 and all(v > 0 for v in move.values())
            and launches == want_launches):
        raise AssertionError(
            f"{phase}: {steps} steps, losses {losses}, best {best}, moved "
            f"{move}, {launches} hash dropout launches (expected "
            f"{want_steps} steps and {want_launches} launches)")
    return state, launches


def two_data(tmp: str, seed: int, dev, card_line: str, data: dict):
    """Phase 13, step 2: TwoDataTrainer.fit_two on the two datasets at
    batch 32 queries x 20 documents, 4 steps of each in turns (MQ2008's 46
    features through text_proj, Web10K's 136 through text_proj3), an eval
    of the mean NDCG@full over both test splits. Returns the config, the
    best `.bin` and hash dropout's launches."""
    cfg = tab_config(tmp, "two_data", seed, "--batch_size", str(TAB_BS),
                     "--report_steps", "1")
    cfg, loaders, evs = letor_two_data_loaders(
        cfg, [data[n][1][0] for n in LETOR_SHAPES],
        [data[n][1][1] for n in LETOR_SHAPES])
    if list(cfg.model.trad_dims) != [LETOR_SHAPES[n][1]
                                     for n in LETOR_SHAPES]:
        raise AssertionError(f"trad_dims {cfg.model.trad_dims}")
    trainer = TwoDataTrainer(cfg, dev)
    _, launches = tab_fit(
        "tabular_two_data", trainer, lambda: trainer.fit_two(
            [Capped(l, TAB_STEPS) for l in loaders], evs),
        TwoDataScoreModel, 2 * TAB_STEPS, 1, card_line,
        watched=TAB_WATCHED + ("text_proj.fc1.weight",
                               "text_proj3.fc1.weight"),
        trad_dims=cfg.model.trad_dims)
    return cfg, cfg.output_model_path, launches


def projection(tmp: str, cfg, two_bin: str, dev, card_line: str,
               data: dict):
    """Phase 13, step 3: project_tsv of MQ2008's 9,630 rows and of the
    first 50 Web10K queries to 768 wide, with the 2-data `.bin`'s dims;
    preprocess_data combine of the two into the merged set, grouped to 20
    documents. Returns the merged (train, test) queries: test is MQ2008's
    held-out queries, as the reference's merged test split is the
    target's."""
    sd = load_any(two_bin)
    dims = trad_dims_from_state_dict(sd)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trad_dims=dims))
    web_tsv = data["web10k"][0]
    web = read_tsv(web_tsv)
    keep = np.isin(web[:, 1], np.unique(web[:, 1])[:WEB10K_PROJECTED])
    write_tsv(web[keep], os.path.join(tmp, "web10k_part.tsv"))
    res, projected = {}, []
    for name, src in (("mq2008", data["mq2008"][0]),
                      ("web10k", os.path.join(tmp, "web10k_part.tsv"))):
        out = os.path.join(tmp, f"{name}_768.tsv")
        project_tsv(cfg, sd, src, out, device=dev)
        arr, rows = read_tsv(out), read_tsv(src)
        res[name] = {"shape": list(arr.shape),
                     "finite": bool(np.isfinite(arr).all()),
                     "head_kept": bool(np.array_equal(arr[:, :2],
                                                      rows[:, :2]))}
        if not (arr.shape == (rows.shape[0], 2 + D) and res[name]["finite"]
                and res[name]["head_kept"]):
            raise AssertionError(f"projected {name}: {res[name]}")
        projected.append(out)
    merged_tsv = os.path.join(tmp, "merged_768.tsv")
    preprocess_data.main(["combine", *projected, merged_tsv])
    merged = group_queries(read_tsv(merged_tsv), LETOR_DOCS)
    train, test = split_queries(merged, data["mq2008"][1][1].qids)
    emit(phase="tabular_projection", trad_dims=dims, **res,
         merged_queries={"train": len(train.qids), "test": len(test.qids)},
         card=card_line)
    if res["mq2008"]["shape"] != [LETOR_SHAPES["mq2008"][0], 2 + D]:
        raise AssertionError(f"projected MQ2008 {res['mq2008']['shape']}")
    return train, test


def tab_stage1(tmp: str, seed: int, dev, card_line: str, train, test):
    """Phase 13, step 4: PointwiseTrainer.fit on the merged set at batch 32
    queries x 20 documents, 4 steps ('reg'), an eval after each. Returns
    the best `.bin` and hash dropout's launches."""
    cfg = tab_config(tmp, "tab_stage1", seed, "--batch_size", str(TAB_BS),
                     "--report_steps", "1")
    trainer = PointwiseTrainer(cfg, dev)
    loader, ev = letor_pointwise_loaders(cfg, train, test)
    _, launches = tab_fit(
        "tabular_stage1", trainer,
        lambda: trainer.fit(Capped(loader, TAB_STEPS), ev), ScoreModel,
        TAB_STEPS, 1, card_line)
    return cfg.output_model_path, launches


def tab_stage2(tmp: str, seed: int, dev, card_line: str, train, test):
    """Phase 13, step 5: RewardTrainer.fit (margin 0.01) on the merged set
    at batch 32 pairs, 4 steps, the pairwise accuracy on 20 pairs of each
    test query after each; each step runs two forwards of the trunk's XiT
    and `xitt`. Returns the best `.bin` and hash dropout's launches."""
    cfg = tab_config(tmp, "tab_stage2", seed, "--batch_size", str(TAB_BS),
                     "--report_steps", "1")
    trainer = RewardTrainer(cfg, dev)
    if trainer.margin != 0.01:
        raise AssertionError(f"tabular margin {trainer.margin}")
    loader, ev = letor_reward_loaders(cfg, train_q=train, eval_q=test)
    _, launches = tab_fit(
        "tabular_stage2", trainer,
        lambda: trainer.fit(Capped(loader, TAB_STEPS), ev), SeqScoreModel,
        TAB_STEPS, 4, card_line)
    return cfg.output_model_path, launches


@contextmanager
def int8_sites():
    """The (rows, in, out) of every int8_linear call in the block."""
    seen, real = [], int8_ops.int8_linear

    def spy(x, weight, *a, **k):
        seen.append((x.numel() // x.shape[-1], weight.shape[1],
                     weight.shape[0]))
        return real(x, weight, *a, **k)

    int8_ops.int8_linear = spy
    try:
        yield seen
    finally:
        int8_ops.int8_linear = real


def tab_stage3(tmp: str, seed: int, dev, card_line: str, train, test,
               actor_bin: str, reward_bin: str) -> int:
    """Phase 13, steps 6 and 7: PPOTrainer.fit from both `.bin`s at batch
    256 x 2 documents, 4 rollouts and 2 sweeps of 2 updates, an eval after
    each sweep, under --profile fast (int8 actor twin, int8 reward, hash
    dropout: 9 forward and 9 backward launches an update); no K1 and every
    int8 site of one more rollout on the dequant route; then ppo_eval_trad's
    evaluate_cases on the best `.bin`, its NDCG equal to the trainer's
    best. Returns hash dropout's launches in the fit."""
    cfg = tab_config(tmp, "tab_stage3", seed, "--batch_size", str(TRAIN_BS),
                     "--max_tags", "20", "--max_timesteps", "1",
                     "--update_timesteps", "2", "--eval_steps", "1",
                     "--pretrained_model_path", actor_bin,
                     "--reward_model_path", reward_bin)
    make_train_loader, ev = letor_ppo_loaders(cfg, train, test)
    trainer = PPOTrainer(cfg, dev)
    built = {}

    def init_params(s):
        built["models"] = models = PPOTrainer.init_params(trainer, s)
        built["before"] = {k: dict(m.named_parameters())[k].detach().clone()
                           for m, k in ((models[0], "head.weight"),
                                        (models[1], "xitt.0.0.1.fn.1.0.weight"))}
        return models

    trainer.init_params = init_params
    hash_dropout.launches = 0
    astate, cstate, best = trainer.fit(
        lambda epoch: Capped(make_train_loader(epoch), TAB_ROLLOUTS), ev)
    torch.cuda.synchronize()
    launches = hash_dropout.launches
    updates = astate.step
    recs = [r for r in records(cfg) if "policy_loss" in r]
    losses = [[r["policy_loss"], r["value_loss"]] for r in recs]
    actor, critic, reward_model = built["models"]
    now = {"head.weight": actor.head.weight,
           "xitt.0.0.1.fn.1.0.weight": dict(critic.named_parameters())[
               "xitt.0.0.1.fn.1.0.weight"]}
    move = {k: float((now[k].detach() - v).abs().max())
            for k, v in built["before"].items()}
    if not (updates == cstate.step == TAB_ROLLOUTS and len(losses) == 2
            and np.isfinite(losses).all() and np.isfinite(best)
            and all(v > 0 for v in move.values())
            and launches == 2 * XIT_SITES * 3 * updates):
        raise AssertionError(f"tabular stage 3: {updates} updates, losses "
                             f"{losses}, best {best}, moved {move}, "
                             f"{launches} hash dropout launches")

    # one rollout on the trained models: the int8 sites it calls
    batch = next(iter(make_train_loader(1)))
    b = trainer.ctx.put(batch)
    st = trainer.ctx.put_array(np.broadcast_to(
        np.arange(PAIR, dtype=np.int32), (TRAIN_BS, PAIR)).copy())
    twin = frozen_copy(ScoreModel, cfg.model, actor.state_dict(),
                       trainer.dtype, True)
    roll = make_rollout_step(cfg.model.mode)
    with int8_sites() as sites:
        roll(twin, critic, reward_model, b["text"], None, st)
    dequant = all(2 * r * k * n < int8_ops.INT8_DYNQUANT_MIN_FLOPS
                  for r, k, n in sites)

    # ppo_eval_trad: the stage-3 best .bin through load_any, strict
    sd = load_any(cfg.output_model_path, kind="actor_critic")
    model = ScoreModel(cfg.model, trainer.dtype, device=dev)
    model.load_state_dict(sd["actor"], strict=True)
    path = os.path.join(tmp, "tab_cases.json")
    result = evaluate_cases(model, ev.ds, ev, path, trainer.ctx.put)
    with open(path) as f:
        cases = json.load(f)
    keys = {"pred_order", "pred_scores", "gold", "gold_rearranged", "ndcg",
            "id"}
    good = all(set(c) == keys and len(c["gold"]) == LETOR_DOCS
               and sorted(c["pred_order"]) == list(range(LETOR_DOCS))
               and [c["gold"][j] for j in c["pred_order"]]
               == c["gold_rearranged"] for c in cases)
    emit(phase="tabular_stage3", rollouts=TAB_ROLLOUTS, updates=updates,
         sweep_losses=losses, ndcg_full=[r["ndcg_full"] for r in recs],
         best_ndcg_full=best, moved=move, hash_dropout_launches=launches,
         int8_mlp_launches=int8_mlp.launches, int8_sites=sorted(set(sites)),
         int8_sites_dequant=dequant, ppo_eval_cases=len(cases),
         ppo_eval_ndcg_full=result[NDCG_FULL],
         ppo_eval_vs_best=abs(result[NDCG_FULL] - best), card=card_line)
    if not (dequant and sites and len(cases) == len(test.qids) and good
            and abs(result[NDCG_FULL] - best) <= 1e-6):
        raise AssertionError(f"int8 sites {sites} (dequant {dequant}); "
                             f"ppo_eval: {len(cases)} cases for "
                             f"{len(test.qids)} queries, schema ok {good}, "
                             f"NDCG {result[NDCG_FULL]} against the best "
                             f"{best}")
    return launches


# hash dropout at the tabular sites: a stage-3 update's (256 x 2 documents,
# the FFN-inner and the residual widths) and a stage-1 step's (32 x 20)
TAB_DROPOUT_SITES = ((TRAIN_BS * PAIR, H), (TRAIN_BS * PAIR, D),
                     (TAB_BS * LETOR_DOCS, H))


def tabular_path(args, dev, card_line: str) -> dict:
    """Phase 13: hash dropout at the tabular sites, then the tabular recipe
    on synthetic LETOR data: the offline pipeline, the 2-data trainer and
    the projection, stages 1, 2 and 3 and ppo_eval_trad. K1 is never
    launched: no int8 site of the path is compute-bound. Returns hash
    dropout's launches on the path and its runs at the tabular sites."""
    sites = [check_dropout("hash_dropout", shape, dt, args.seed + 30 + i,
                           dev, False, card_line)
             for i, shape in enumerate(TAB_DROPOUT_SITES)
             for dt in (torch.float32, torch.bfloat16)]
    int8_mlp.launches = int8_matmul.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        data = letor_offline(tmp, args.seed + 31, card_line)
        cfg, two_bin, n_two = two_data(tmp, args.seed + 32, dev, card_line,
                                       data)
        train, test = projection(tmp, cfg, two_bin, dev, card_line, data)
        del data
        actor_bin, n1 = tab_stage1(tmp, args.seed + 33, dev, card_line,
                                   train, test)
        reward_bin, n2 = tab_stage2(tmp, args.seed + 34, dev, card_line,
                                    train, test)
        n3 = tab_stage3(tmp, args.seed + 35, dev, card_line, train, test,
                        actor_bin, reward_bin)
    if int8_mlp.launches or int8_matmul.launches:
        raise AssertionError(
            f"the tabular path launched K1 {int8_mlp.launches} and K2 "
            f"{int8_matmul.launches} times; its int8 sites are not "
            "compute-bound")
    torch.cuda.empty_cache()
    return {"launches": n_two + n1 + n2 + n3, "sites": sites}


# Phase 14: MLM pretraining of XLM-R base (XLMR_BASE) at full width on a
# synthetic corpus, as lr2ppo_torch.cli.pretrain runs it
PRE_BS, PRE_ACCUM, PRE_SEQ, PRE_STEPS, ADA_STEPS = 32, 2, 128, 4, 2
PRE_VOCAB = 250002                     # XLM-R's vocabulary, specials first
PRE_SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
PRE_ROWS = 320                         # corpus rows of 128 tokens (5 steps)
PRE_WATCHED = ("embedding.word.embedding.weight",
               "encoder.transformer.0.self_attn.linear_layers.0.weight",
               "encoder.transformer.11.feed_forward.linear_2.weight",
               "target.mlm.linear_2.weight")
# the tower's two dropout shapes at batch 32 x 128: the embedding and the
# residual branches (B, S, 768), the attention probabilities (B, 12, S, S)
PRE_SITES = {"residual": (PRE_BS, PRE_SEQ, 768),
             "probs": (PRE_BS, 12, PRE_SEQ, PRE_SEQ)}


def pretrain_corpus(tmp: str, seed: int, vocab: int = PRE_VOCAB,
                    tower: dict = XLMR_BASE) -> dict:
    """The vocabulary (`vocab` lines: the specials, then synthetic words)
    and a corpus of Zipf-distributed words of it, about PRE_ROWS rows of
    PRE_SEQ tokens once packed; the tower config (XLMR_BASE by default)."""
    rng = np.random.default_rng(seed)
    words = PRE_SPECIALS + [f"w{i}" for i in range(vocab
                                                     - len(PRE_SPECIALS))]
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("vocab", "vocab.txt"), ("corpus", "corpus.txt"),
        ("tower", "tower_config.json"))}
    with open(paths["vocab"], "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    # a word's rank follows Zipf's law with exponent 1.1 over the vocabulary
    n_words = PRE_ROWS * PRE_SEQ
    ranks = rng.zipf(1.1, size=3 * n_words)
    ranks = ranks[ranks <= vocab - len(PRE_SPECIALS)][:n_words]
    lens = rng.integers(20, 120, size=n_words // 20)
    lines, start = [], 0
    for n in lens:
        if start >= len(ranks):
            break
        lines.append(" ".join(words[len(PRE_SPECIALS) - 1 + r]
                              for r in ranks[start:start + n]))
        start += n
    with open(paths["corpus"], "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(paths["tower"], "w") as f:
        json.dump(tower, f)
    return paths


def pretrain_argv(paths: dict, out: str, steps: int) -> list:
    return ["--corpus_path", paths["corpus"], "--tower_config",
            paths["tower"], "--data_processor", "mlm", "--tokenizer",
            "space", "--vocab_path", paths["vocab"], "--hash_dropout",
            "--batch_size", str(PRE_BS), "--accumulation_steps",
            str(PRE_ACCUM), "--seq_length", str(PRE_SEQ), "--total_steps",
            str(steps), "--report_steps", "1", "--output_model_path", out,
            "--log_path", out + ".log"]


@contextmanager
def watched_init(names=PRE_WATCHED):
    """PretrainTrainer.init_model keeps copies of `names` as they start,
    for each trainer built inside the block."""
    seen, real = [], PretrainTrainer.init_model

    def init_model(self):
        model = real(self)
        params = dict(model.named_parameters())
        seen.append({k: params[k].detach().cpu().clone() for k in names})
        return model

    PretrainTrainer.init_model = init_model
    try:
        yield seen
    finally:
        PretrainTrainer.init_model = real


def steady_trace(fn):
    """A torch.profiler trace of fn's second call: the first runs in the
    profiler's warm-up cycle, whose device records are not kept (a trace
    late in a long process can miss kernels of its first records)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def traced_ms(prof, name: str) -> list:
    """The device times (ms) of the traced kernels whose name holds
    `name`, in launch order."""
    from torch.autograd import DeviceType

    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.name]


def pretrain_path(args, dev, card_line: str) -> dict:
    """Phase 14: hash dropout against its plain version at the two tower
    shapes, float32; then the pretraining CLI at XLM-R base's width (4
    steps), its checkpoints and the Adafactor leg. Returns hash dropout's
    launches in the CLI's run and the sites' runs."""
    sites = {name: check_dropout("hash_dropout", shape, torch.float32,
                                 args.seed + 40 + i, dev, False, card_line)
             for i, (name, shape) in enumerate(PRE_SITES.items())}
    torch.cuda.empty_cache()
    cfg = TowerConfig.from_dict(XLMR_BASE)
    per_pass = 1 + 3 * cfg.layers_num        # the embedding + 3 a layer
    want = per_pass * 2 * PRE_ACCUM * PRE_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, args.seed + 41)
        out = os.path.join(tmp, "mlm")
        argv = pretrain_argv(paths, out, PRE_STEPS)
        reset_launches()
        hash_dropout.launches = 0
        with watched_init() as seen:
            best = pretrain.main(argv)
        torch.cuda.synchronize()
        launches = hash_dropout.launches
        with open(out + ".log.jsonl") as f:
            recs = [json.loads(line) for line in f]
        final = load_tower_checkpoint(out)
        move = {k: float((final[k] - v).abs().max())
                for k, v in seen[0].items()}
        n_params = sum(v.numel() for v in final.values())
        n_tower = sum(v.numel() for k, v in final.items()
                      if not k.startswith("target."))
        losses = [r["loss"] for r in recs]
        if not (len(recs) == PRE_STEPS and np.isfinite(losses).all()
                and all(v > 0 for v in move.values())
                and launches == want and fused_attention.launches == 0):
            raise AssertionError(
                f"pretrain: losses {losses}, moved {move}, {launches} hash "
                f"dropout launches (want {want}), "
                f"{fused_attention.launches} K4 launches")
        # the -best and final checkpoints load strict into a fresh tower
        # with its target; the final one's encoder keys feed extraction
        tcfg = dataclasses.replace(cfg, vocab_size=PRE_VOCAB,
                                   hash_dropout=True)
        for path in (out + "-best", out):
            TowerModel(tcfg, device="meta", with_target=True).load_state_dict(
                load_tower_checkpoint(path), strict=True, assign=True)
        tok = SpaceTokenizer(paths["vocab"])
        with open(paths["corpus"], encoding="utf-8") as f:
            texts = [next(f).strip() for _ in range(4)]
        text_x = TextFeatureExtractor(tcfg, encoder_state(final), tok,
                                      PRE_SEQ, device=dev)
        feats = text_x(texts, EXTRACT_BATCH)
        del final, text_x
        if not (feats.shape == (4, PRE_SEQ, cfg.hidden_size)
                and np.isfinite(feats).all()):
            raise AssertionError(f"encode of the pretrained tower: "
                                 f"{feats.shape}, finite "
                                 f"{np.isfinite(feats).all()}")
        torch.cuda.empty_cache()

        # Adafactor: the same trainer with cfg.optim.optimizer set
        ada_out = os.path.join(tmp, "ada")
        trainer, loader = pretrain.build(pretrain.parser().parse_args(
            pretrain_argv(paths, ada_out, ADA_STEPS)), dev)
        trainer.cfg.optim.optimizer = "adafactor"
        with watched_init() as ada_seen:
            ada_state, _ = trainer.fit(loader, ADA_STEPS)
        ada_params = dict(ada_state.model.named_parameters())
        ada_move = {k: float((ada_params[k].detach().cpu() - v).abs().max())
                    for k, v in ada_seen[0].items()}
        with open(ada_out + ".log.jsonl") as f:
            ada_losses = [json.loads(line)["loss"] for line in f]
        ada_opt = type(ada_state.opt).__name__
        del trainer, loader, ada_state, ada_params
        torch.cuda.empty_cache()
    if not (ada_opt == "Adafactor" and len(ada_losses) == ADA_STEPS
            and np.isfinite(ada_losses).all()
            and all(v > 0 for v in ada_move.values())):
        raise AssertionError(f"adafactor: {ada_opt}, losses {ada_losses}, "
                             f"moved {ada_move}")
    emit(phase="pretrain", params=n_params, tower_params=n_tower,
         head_params=n_params - n_tower, vocab=PRE_VOCAB,
         micro_batch=[PRE_BS, PRE_SEQ], accumulation=PRE_ACCUM,
         steps=PRE_STEPS, losses=losses, accs=[r["acc"] for r in recs],
         best_acc=best, moved=move, hash_dropout_launches=launches,
         hash_dropout_launches_expected=want,
         hash_dropout_sites_a_pass=per_pass, encode_shape=list(feats.shape),
         adafactor_losses=ada_losses, adafactor_moved=ada_move,
         card=card_line)
    return {"launches": launches, "sites": sites}


# -- phase 15: multi-GPU training ------------------------------------------
P15_ROLLOUTS = 2                      # one sweep of 2 updates
# the shared-card legs against the single-process run: float32 sums over
# other splits of bfloat16 products, through 2 updates
P15_RTOL, P15_ATOL = 5e-2, 5e-3
P15_KEYS = ("policy_loss", "value_loss", "rewards", "value", "advantages",
            "ndcg_full")
# the legs against the reference on the trained parameters: the largest,
# over the actor's and the critic's leaves, of ||p - p_ref|| / ||p_ref -
# p_init|| (every run starts from the same weights). Sound legs read up to
# 0.224 (tp 2: the int8 rollout twin's sums split over tp), a planted fault
# 1.03 (dp 2 without the gradient average) and 1.07 (tp 2 with copy_to_tp's
# backward left without its all-reduce); PERF.md section 6
P15_PARAM_GAP = 0.5
# leaves whose gradient is 0 in exact arithmetic, a softmax being blind to
# a shift of all its inputs: every attention's key bias, and the actor's
# biases that shift every tag's score alike (its policy is a softmax over
# them). AdamW scales their rounding noise to full-size steps, so they are
# read but not held.
P15_SHIFT_LEAVES = ("keys.bias", "actor.head.bias", "actor.out_layer.fc2.bias")


class ShardedBatches(BatchList):
    """This dp rank's rows of each global batch, as a Loader(shard=(rank,
    world)) hands them out."""

    def __init__(self, batches, shard=None):
        if shard is not None:
            rank, world = shard
            batches = [{k: v[rank * (len(v) // world):
                             (rank + 1) * (len(v) // world)]
                        for k, v in b.items()} for b in batches]
        super().__init__(batches)
        self.shard = shard


def checksum(t: torch.Tensor) -> list:
    """Two integer sums of a tensor's bits, the plain one and one weighted
    by position mod 65521, both mod 2^64: runs whose sums agree on every
    tensor hold the same bits, short of a collision."""
    b = t.detach().contiguous().view(-1)
    b = b.view(torch.int16 if b.element_size() == 2 else torch.int32)
    b = b.to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return [int(b.sum()), int((b * w).sum())]


def p15_config(tmp: str, seed: int, dp: int = 1, tp: int = 1,
               zero1: bool = False):
    """Phase 7's configuration on a mesh, at a constant learning rate: the
    default linear warmup gives a one-sweep run the rate 0 throughout, so
    no parameter would move."""
    cfg = train_config(tmp, seed)
    cfg.mesh.dp, cfg.mesh.tp, cfg.mesh.zero1 = dp, tp, zero1
    cfg.optim.scheduler = "constant"
    return cfg


def param_gap(full: dict, ref_path: str, init: dict = None) -> dict:
    """The reference run (`init` given: its weights before training)
    writes its trained parameters and each leaf's change ||p - p_init|| to
    `ref_path`; a leg's rank 0 reads them and returns, over the floating
    leaves, the largest ||p - p_ref|| / ||p_ref - p_init|| (`param_gap`,
    with its leaf) and the same ratio over all leaves at once."""
    if init is not None:
        moved = {k: float((v.float() - init[k].float()).norm())
                 for k, v in full.items() if v.is_floating_point()}
        if not any(moved.values()):
            raise AssertionError("the reference run moved no parameter")
        torch.save({"final": {k: v.detach().cpu() for k, v in full.items()},
                    "moved": moved}, ref_path)
        return {"moved_leaves": sum(v > 0 for v in moved.values()),
                "leaves": len(moved)}
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    gaps, num, den = {}, 0.0, 0.0
    for k, moved in ref["moved"].items():
        d = float((full[k].float()
                   - ref["final"][k].to(full[k].device).float()).norm())
        gaps[k] = d / moved if moved else (0.0 if d == 0 else math.inf)
        num, den = num + d * d, den + moved * moved
    held = [k for k in gaps if not k.endswith(P15_SHIFT_LEAVES)]
    worst = max(held, key=gaps.get)
    return {"param_gap": gaps[worst], "param_gap_leaf": worst,
            "param_gap_all": math.sqrt(num / den), "param_gaps": gaps}


def p15_run(cfg, dev, batch: int, seed: int, ref_path: str) -> dict:
    """PPOTrainer.fit over P15_ROLLOUTS global batches of `batch` items
    (this rank's rows of each) at the flagship width under --profile fast,
    on this process's mesh. Returns the sweep's records (rank 0), checksums
    of the full-width actor and critic, their gap to the reference's
    (param_gap; the reference, without torch.distributed, writes them to
    `ref_path`) and the launches."""
    trainer = PPOTrainer(cfg, dev)
    ctx, built = trainer.ctx, {}

    reference = dist_backend() == ""

    def init_params(seed):
        built["models"] = PPOTrainer.init_params(trainer, seed)
        if reference:
            built["init"] = {f"{side}.{k}": v.detach().clone()
                             for side, model in zip(("actor", "critic"),
                                                    built["models"])
                             for k, v in model.state_dict().items()}
        return built["models"]

    trainer.init_params = init_params
    m = ctx.mesh
    loader = ShardedBatches(item_batches(P15_ROLLOUTS, cfg.model, seed + 3,
                                         batch, PAIR),
                            (m.dp_rank, m.dp) if m.dp > 1 else None)
    evb, _ = synthetic_batches(2, cfg.model, seed + 4, items=8, bucket=8,
                               tags=(2, 8))
    int8_mlp.launches = hash_dropout.launches = 0
    hash_dropout.place_launches = 0
    astate, cstate, best = trainer.fit(lambda epoch: loader, evb)
    torch.cuda.synchronize()
    res = {"rank": m.rank, "dp": m.dp, "tp": m.tp, "zero1": ctx.zero1,
           "batch": batch, "local_batch": batch // m.dp,
           "k1_launches": int8_mlp.launches,
           "hash_dropout_launches": hash_dropout.launches,
           "hash_dropout_place_launches": hash_dropout.place_launches,
           "updates": int(astate.step), "best": float(best)}
    if m.is_main:
        with open(cfg.log_path + ".jsonl") as f:
            res["records"] = [{k: r[k] for k in P15_KEYS if k in r}
                              for r in map(json.loads, f)]
    actor, critic, _ = built["models"]
    full = {f"{side}.{k}": v
            for side, model in (("actor", actor), ("critic", critic))
            for k, v in ctx.full_state_dict(model).items()}
    res["sums"] = {k: checksum(v) for k, v in full.items()}
    if m.is_main:
        res.update(param_gap(full, ref_path, built.pop("init", None)))
    del full
    res["fc1_rows"] = ctx.named_parameters(actor)[
        "out_layer.fc1.weight"].shape[0]
    if dist_backend() == "gloo":
        res["checkpoints"] = shards_leg(ctx, astate, cstate, best,
                                        res["sums"],
                                        os.path.dirname(ref_path), dev)
    return res


def dist_backend() -> str:
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else ""


def p15_rank(rank, world, url, backend, job, queue) -> None:
    """One rank of a phase-15 leg, in its own process: NCCL ranks each on
    their card, gloo ranks sharing card 0, and the reference ("none") in
    one process without torch.distributed. Every leg runs with the same
    deterministic algorithms (the critic's gather backward otherwise adds
    in a racing order), so runs that do the same arithmetic give the same
    bits."""
    import traceback

    import torch.distributed as dist

    dp, tp, zero1, batch, seed, ref_path = job
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        require_cuda()
        if backend != "none":
            dist.init_process_group(backend, init_method=url, rank=rank,
                                    world_size=world)
        with tempfile.TemporaryDirectory() as tmp:
            res = p15_run(p15_config(tmp, seed, dp, tp, zero1), dev, batch,
                          seed, ref_path)
        res["backend"] = backend
        res["card"] = card()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def p15_leg(world: int, backend: str, dp: int, tp: int, zero1: bool,
            batch: int, seed: int, ref_path: str,
            timeout: float = 600.0) -> list:
    """Spawn the ranks of one leg (spawn_leg) and collect their results.
    The reference leg (backend "none") writes its trained parameters to
    `ref_path`, which the other legs read."""
    return spawn_leg(f"phase 15 leg {backend} dp {dp} tp {tp}", world,
                     backend, (dp, tp, zero1, batch, seed, ref_path),
                     p15_rank, timeout)


def spawn_leg(name: str, world: int, backend: str, job, target,
              timeout: float = 600.0) -> list:
    """target(rank, world, url, backend, job, queue) in `world` spawned
    processes; returns their results in rank order. Every process is
    joined, or killed at the time limit; a rank that dies without a result
    or raises fails the leg."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    url = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=target,
                         args=(r, world, url, backend, job, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.time() + timeout
        while len(got) < world:
            try:
                rank, res = queue.get(timeout=5.0)
            except queue_mod.Empty:
                # a rank that died without a result fails the leg now
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead or time.time() > deadline:
                    raise RuntimeError(
                        f"{name}: ranks {dead} exited without a result, or "
                        f"the leg outlived {timeout} s")
                continue
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: v["error"] for r, v in got.items() if "error" in v}
    if errors:
        raise RuntimeError(f"{name}: {errors}")
    return [got[r] for r in range(world)]


def p15_close(ref: list, got: list) -> float:
    """The largest |got - ref| / (P15_ATOL + P15_RTOL |ref|) over the
    sweep's records; at most 1 passes."""
    worst = 0.0
    for r, g in zip(ref, got):
        for k in P15_KEYS:
            if k in r:
                worst = max(worst, abs(g[k] - r[k])
                            / (P15_ATOL + P15_RTOL * abs(r[k])))
    return worst


def p15_held(name: str, ref: dict, ranks: list, phase: str, **extra
             ) -> None:
    """Emit each rank of a leg and hold its rank 0 against the reference:
    the sweep's records within P15_RTOL / P15_ATOL and the trained
    parameters within P15_PARAM_GAP."""
    worst = p15_close(ref["records"], ranks[0]["records"])
    for r in ranks:
        if "param_gaps" in r:
            # the five widest leaves
            r["param_gaps"] = dict(sorted(r["param_gaps"].items(),
                                          key=lambda kv: -kv[1])[:5])
        emit(phase=phase, leg=name, worst_over_tolerance=worst,
             param_gap_limit=P15_PARAM_GAP, **extra,
             **{k: v for k, v in r.items() if k != "sums"})
    if worst > 1.0 or not ranks[0]["param_gap"] <= P15_PARAM_GAP:
        raise AssertionError(
            f"phase 15 leg {name}: records {worst} of their tolerance, "
            f"parameters {ranks[0]['param_gap']} from the reference's "
            f"(limit {P15_PARAM_GAP}, at {ranks[0]['param_gap_leaf']})")


def parallel_path(args, dev, card_line: str, shared: bool = True) -> dict:
    """Phase 15: multi-GPU training. Hash dropout's global-index form and
    Philox's offset against their plain versions at the update's site;
    the stage-3 trainer in one process without torch.distributed as the
    reference; (a) the same run over NCCL at world = the card count,
    bit-equal at world 1; (b) two ranks sharing card 0 over gloo with CUDA
    tensors: dp 2 with zero1 and tp 2, held by p15_held. Without `shared` (the
    four-card call) (b) gives way to dp with zero1 over NCCL, bit-equal to
    (a), and dp x tp 2. Each leg runs in processes of its own."""
    rows = ROLLOUT_ROWS // 2
    sites = {
        "dp_shard": check_dropout("hash_dropout", (rows, H), torch.bfloat16,
                                  args.seed + 50, dev, True, card_line,
                                  ((rows, 0, H, H),)),
        "tp_columns": check_dropout("hash_dropout", (ROLLOUT_ROWS, H // 2),
                                    torch.bfloat16, args.seed + 51, dev,
                                    False, card_line,
                                    ((0, H // 2, H, H // 2),)),
        "odd_width": check_dropout("hash_dropout", (1000, 3077),
                                   torch.float32, args.seed + 52, dev, False,
                                   card_line, ((1000, 5, 6159, 3077),)),
        "philox_dp_shard": check_dropout("philox_dropout", (rows, H),
                                         torch.bfloat16, args.seed + 53, dev,
                                         False, card_line, (rows * H,))}
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "reference.pt")

        def leg(world, backend, dp, tp, zero1=False):
            return p15_leg(world, backend, dp, tp, zero1, TRAIN_BS,
                           args.seed, ref_path)

        ref = leg(1, "none", 1, 1)[0]
        nccl = leg(world, "nccl", world, 1)
        if world == 1:
            for r in nccl:
                emit(phase="parallel_nccl", world=world,
                     **{k: v for k, v in r.items()
                        if k not in ("sums", "param_gaps")})
            same_sums = nccl[0]["sums"] == ref["sums"]
            if not (same_sums and nccl[0]["records"] == ref["records"]
                    and nccl[0]["k1_launches"] == 4 * P15_ROLLOUTS
                    and nccl[0]["hash_dropout_launches"]
                    == ref["hash_dropout_launches"]):
                raise AssertionError(
                    f"NCCL at world 1 is not the single-process run: sums "
                    f"equal {same_sums}, records {nccl[0].get('records')} "
                    f"against {ref['records']}, K1 "
                    f"{nccl[0]['k1_launches']}")
        else:
            p15_held(f"dp{world}", ref, nccl, "parallel_nccl", world=world)
        if shared:
            legs = {"dp2_zero1": leg(2, "gloo", 2, 1, True),
                    "tp2": leg(2, "gloo", 1, 2)}
        else:
            legs = {}
            if world >= 2:
                # zero1 over NCCL: the same bits as plain dp
                zero1 = leg(world, "nccl", world, 1, True)
                p15_held(f"dp{world}_zero1", ref, zero1, "parallel_nccl",
                         world=world,
                         sums_equal_plain_dp=zero1[0]["sums"]
                         == nccl[0]["sums"])
                if zero1[0]["sums"] != nccl[0]["sums"]:
                    raise AssertionError(f"zero1 at dp {world} is not plain "
                                         "dp's bits")
            if world >= 4:
                p15_held(f"dp{world // 2}_tp2", ref,
                         leg(world, "nccl", world // 2, 2), "parallel_nccl",
                         world=world)
    for name, ranks in legs.items():
        # phase 21 (c): the sharded write against the pickle route's
        shards = [r.pop("checkpoints") for r in ranks]
        emit(phase="checkpoints", leg=f"shards_{name}", card=card_line,
             ranks=shards, sharded_bytes=sum(r["rank_file_bytes"]
                                             for r in shards))
        if not shards[0]["held"]:
            raise AssertionError(f"phase 21 leg {name}: the sharded state "
                                 f"differs at {shards[0]['differ']}")
        p15_held(name, ref, ranks, "parallel_shared_card",
                 reference=ref["records"])
        # K1 on each dp rank (50,176 rows, above its gate); none under tp
        k1 = 0 if name == "tp2" else 4 * P15_ROLLOUTS
        tp_ok = all(r["k1_launches"] == k1 for r in ranks) and (
            name != "tp2" or all(2 * r["fc1_rows"] == ref["fc1_rows"]
                                 for r in ranks))
        place = sum(r["hash_dropout_place_launches"] for r in ranks)
        if not tp_ok or place == 0:
            raise AssertionError(f"phase 15 leg {name}: tp checks {tp_ok}, "
                                 f"{place} launches with a place")
    ref_out = {k: v for k, v in ref.items() if k != "sums"}
    emit(phase="parallel_reference", **ref_out)
    return {"sites": sites, "ref": ref_out, "nccl": nccl, "legs": legs,
            "place_launches": sum(r["hash_dropout_place_launches"]
                                  for ranks in legs.values()
                                  for r in ranks)}


# -- phase 16: pipeline stages, sequence parallelism, Adafactor under tp,
# serving on a mesh ---------------------------------------------------------
P16_STEPS = 2                          # optimizer steps of every leg
# XLM-R base cut to 4 of its 12 layers in this phase's runs (pp 2 and pp 4
# still split it evenly), to keep the whole script in its 1,200 s with
# phase 21 (on an NVIDIA H100 80GB HBM3, 700.00 W: 1,069 s at 12 layers
# with phase 20 on a slow host, 953 at 8, 1,010.3 at 4 with phase 21)
P16_LAYERS = 4
P16_TOWER = {**XLMR_BASE, "layers_num": P16_LAYERS}
P16_MICRO = 4                          # --pp_microbatches
P16_SERVE_BATCHES = 2
# the hash dropout site at the sp place: (B, S/2, 768) of XLM-R base's
# residual stream at batch 32 x 128, the second tp rank's tokens
P16_SP_SHAPE = (PRE_BS, PRE_SEQ // 2, 768)
P16_SP_PLACE = (0, PRE_SEQ // 2 * 768, PRE_SEQ * 768, PRE_SEQ // 2 * 768)
# a leg against its one-process run from the same weights: the largest,
# over the held leaves, of ||p - p_ref|| / ||p_ref - p_init|| (param_gap).
# Sound legs read 3.1e-5 (pp 2), 7.3e-5 (tp 2 + sp under Adafactor) and 0
# (sp against tp); planted faults 0.372 (pp 2 with one microbatch's
# gradient sent back as zeros) and 0.443 (sp with the norms' and biases'
# gradients summed over the rank's own tokens only); PERF.md section 6
P16_PARAM_GAP = 0.01
# the losses of a leg against its one-process run, relative
P16_LOSS_RTOL = 1e-3
# leaves whose gradient is 0 but for rounding (a softmax ignores a shift
# shared by every key): read, not held
P16_SHIFT_LEAVES = ("self_attn.linear_layers.1.bias",)


def p16_files(tmp: str, seed: int) -> dict:
    """Phase 14's vocabulary and corpus, and P16_TOWER's config at dropout
    0.1 and at dropout 0."""
    paths = pretrain_corpus(tmp, seed, tower=P16_TOWER)
    paths["tower0"] = os.path.join(tmp, "xlmr_base_dropout0.json")
    with open(paths["tower0"], "w") as f:
        json.dump({**P16_TOWER, "dropout": 0.0}, f)
    return paths


def p16_argv(paths: dict, out: str, dropout: bool, *extra) -> list:
    argv = pretrain_argv(paths, out, P16_STEPS)
    if not dropout:
        argv[argv.index("--tower_config") + 1] = paths["tower0"]
    return argv + ["--pp_microbatches", str(P16_MICRO), *extra]


def p16_init(argv: list, dev) -> dict:
    """The weights every run of `argv` starts from (PretrainTrainer.
    init_model's seeded draw at full width on card 0)."""
    args = pretrain.parser().parse_args(argv)
    cfg = TowerConfig.from_json(args.tower_config, vocab_size=PRE_VOCAB,
                                max_seq_length=max(args.seq_length, 514))
    model = TowerModel(cfg, None, dev, with_target=True)
    init_tower_weights(model, torch.Generator(device=dev).manual_seed(
        args.seed))
    return {k: v.detach() for k, v in model.state_dict().items()}


def p16_records(path: str) -> list:
    with open(path) as f:
        return [{k: r[k] for k in ("loss", "acc")} for r in map(json.loads, f)]


def p16_held_gap(full: dict, ref_path: str) -> dict:
    """param_gap against the one-process run at `ref_path`, with the shift
    leaves read but not held."""
    res = param_gap(full, ref_path)
    held = {k: v for k, v in res["param_gaps"].items()
            if not k.endswith(P16_SHIFT_LEAVES)}
    worst = max(held, key=held.get)
    res.update(param_gap=held[worst], param_gap_leaf=worst,
               param_gaps=dict(sorted(res["param_gaps"].items(),
                                      key=lambda kv: -kv[1])[:5]))
    return res


def p16_pretrain_run(argv: list, dev, adafactor: bool, ref_path: str,
                     reference: bool = False) -> dict:
    """One pretraining leg on this process's mesh: cli.pretrain's build and
    fit (Adafactor where asked), hash dropout's launches over the fit, the
    full-width trained weights' checksums, the share of each stage's tensors
    that moved, and their gap to the run that wrote `ref_path` (with
    `reference`: this run writes it)."""
    trainer, loader = pretrain.build(pretrain.parser().parse_args(argv), dev)
    if adafactor:
        trainer.cfg.optim.optimizer = "adafactor"
    m = trainer.ctx.mesh
    hash_dropout.launches = hash_dropout.place_launches = 0
    state, best = trainer.fit(loader, P16_STEPS)
    torch.cuda.synchronize()
    res = {"rank": m.rank, "dp": m.dp, "tp": m.tp, "pp": m.pp,
           "stage": m.pp_rank, "hash_dropout_launches": hash_dropout.launches,
           "hash_dropout_place_launches": hash_dropout.place_launches,
           "optimizer": type(getattr(state.opt, "inner", state.opt)).__name__,
           "best_acc": float(best)}
    out = trainer.cfg.output_model_path
    full = trainer.ctx.full_state_dict(state.model)
    if m.is_main:
        from lr2ppo_torch.parallel.pipeline import stage_owns

        res["records"] = p16_records(out + ".log.jsonl")
        res["sums"] = {k: checksum(v) for k, v in full.items()}
        start = p16_init(argv, dev)
        if reference:
            res.update(param_gap(full, ref_path, start))
        else:
            res.update(p16_held_gap(full, ref_path))
            # the unpacked -best loads strict into a plain tower
            TowerModel(trainer.tower_cfg, device="meta",
                       with_target=True).load_state_dict(
                load_tower_checkpoint(out + "-best"), strict=True,
                assign=True)
        res["moved_by_stage"] = {}
        for s in range(m.pp):
            keys = [k for k in full if stage_owns(
                k, trainer.tower_cfg.layers_num, m.pp, s)]
            res["moved_by_stage"][s] = sum(
                not torch.equal(full[k], start[k]) for k in keys) / len(keys)
        del start
    del full
    return res


def p16_serve_run(dev, seed: int, path: str, cfg=None) -> dict:
    """The int8 service of phase 4's weights (ScoreModel at flagship width,
    seeded on card 0) on this process's mesh, P16_SERVE_BATCHES of phase
    4's batches, through serve.serving_model and serve.serve_batches as
    serve.main runs them; rank 0 writes `path`. Returns the K1 launches,
    the scores and the orders."""
    from lr2ppo_torch.train.common import device_ctx

    cfg = cfg or parse_config([], "phase 16")
    cfg.mesh.compute_dtype = "bfloat16"
    mcfg = cfg.model                     # ModelConfig(): the flagship
    model = ScoreModel(mcfg, torch.bfloat16, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    del model
    ctx = device_ctx(cfg, dev)
    model = serve.serving_model(cfg, state, True, ctx)
    del state
    batches, ds = synthetic_batches(P16_SERVE_BATCHES, mcfg, seed + 1)
    put = ctx.put_eval if ctx.mesh.world > 1 else None
    int8_mlp.launches = 0
    sink = open(path, "w") if ctx.is_main else None
    try:
        res = serve.serve_batches(model, batches, ds, sink, dev, put=put)
    finally:
        if sink is not None:
            sink.close()
    out = {"rank": ctx.mesh.rank, "dp": ctx.mesh.dp, "tp": ctx.mesh.tp,
           "k1_launches": int8_mlp.launches, "items": res["items"],
           "fc2_local_in": ctx.named_parameters(model)[
               "out_layer.fc2.weight"].shape[1]}
    if ctx.is_main:
        out["scores"] = {k: v.tolist() for k, v in
                         read_rankings(path, ds).items()}
        with open(path) as f:
            out["orders"] = {ln["id"]: ln["pred_order"]
                             for ln in map(json.loads, f)}
    return out


def p16_rank(rank, world, url, backend, job, queue) -> None:
    """One rank of a phase-16 leg, in its own process: NCCL ranks each on
    their card, gloo ranks sharing card 0. `job` is a pretraining leg
    ({"kind": "pretrain", "argv", "adafactor", "ref_path", "reference"}) or
    a serving leg ({"kind": "serve", "argv" (the mesh flags), "seed",
    "path"})."""
    import traceback

    import torch.distributed as dist

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        require_cuda()
        dist.init_process_group(backend, init_method=url, rank=rank,
                                world_size=world)
        if job["kind"] == "serve":
            res = p16_serve_run(dev, job["seed"], job["path"],
                                parse_config(job["argv"], "phase 16"))
        else:
            res = p16_pretrain_run(job["argv"], dev, job["adafactor"],
                                   job["ref_path"], job["reference"])
        res["backend"] = backend
        res["card"] = card()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def p16_expected_launches(cfg, pp: int, stage: int) -> int:
    """Hash dropout's launches on one rank over a fit: the embedding's site
    (stage 0) once a micro-batch, each of the stage's layers' 3 sites once
    a pipeline microbatch; forward and backward."""
    per = (cfg.layers_num // pp) * 3 * (P16_MICRO if pp > 1 else 1)
    if stage == 0:
        per += 1
    return per * 2 * PRE_ACCUM * P16_STEPS


def p16_check(name: str, ranks: list, ref: dict, cfg, phase: str,
              bit_equal: bool = False) -> None:
    """Emit each rank of a pretraining leg and hold its rank 0 against the
    run it is compared with: the losses within P16_LOSS_RTOL (equal where
    `bit_equal` is asked, and then the trained bits are reported), the
    trained parameters within P16_PARAM_GAP, every stage's tensors moved,
    and hash dropout's launches on each rank the count its layers give."""
    main = ranks[0]
    losses, want = ([r["loss"] for r in main["records"]],
                    [r["loss"] for r in ref["records"]])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    dropout = any(r["hash_dropout_launches"] for r in ranks)
    expected = [p16_expected_launches(cfg, r["pp"], r["stage"]) if dropout
                else 0 for r in ranks]
    same_bits = main["sums"] == ref["sums"]
    for r, e in zip(ranks, expected):
        emit(phase=phase, leg=name, losses=losses, reference_losses=want,
             loss_gap=loss_gap, bit_equal=same_bits if bit_equal else None,
             param_gap_limit=P16_PARAM_GAP,
             hash_dropout_launches_expected=e,
             **{k: v for k, v in r.items() if k not in ("sums", "records")})
    ok = (len(losses) == P16_STEPS and np.isfinite(losses).all()
          and loss_gap <= P16_LOSS_RTOL
          and main["param_gap"] <= P16_PARAM_GAP
          and all(v >= 0.9 for v in main["moved_by_stage"].values())
          and [r["hash_dropout_launches"] for r in ranks] == expected)
    if not ok:
        raise AssertionError(
            f"phase 16 leg {name}: losses {losses} against {want}, "
            f"parameters {main['param_gap']} from the reference's (limit "
            f"{P16_PARAM_GAP}, at {main['param_gap_leaf']}), moved "
            f"{main['moved_by_stage']}, hash dropout launches "
            f"{[r['hash_dropout_launches'] for r in ranks]} (want "
            f"{expected})")


def p16_serve_check(name: str, ranks: list, ref: dict, card_line: str,
                    k1_each: int) -> None:
    """A serving leg against the one-process service: the same orders at
    dp, the scores within phase 4's gate (5% of their spread), K1's
    launches on each rank."""
    main = ranks[0]
    spread = max(float(np.abs(v).max()) for v in ref["scores"].values())
    err = max(float(np.abs(np.subtract(main["scores"][k], v)).max())
              for k, v in ref["scores"].items())
    same_orders = sum(main["orders"][k] == v for k, v in ref["orders"].items())
    for r in ranks:
        emit(phase="pipeline_serve", leg=name, max_score_err=err,
             score_spread=spread, same_orders=same_orders,
             reference_items=len(ref["orders"]), k1_launches_expected=k1_each,
             **{k: v for k, v in r.items() if k not in ("scores", "orders")})
    dp = main["dp"] > 1
    ok = (main["scores"].keys() == ref["scores"].keys()
          and err < 0.05 * spread
          and (not dp or same_orders == len(ref["orders"]))
          and all(r["k1_launches"] == k1_each for r in ranks))
    if not ok:
        raise AssertionError(
            f"phase 16 serving leg {name}: score error {err} (spread "
            f"{spread}), {same_orders} of {len(ref['orders'])} orders equal, "
            f"K1 {[r['k1_launches'] for r in ranks]} (want {k1_each} each)")


def pipeline_path(args, dev, card_line: str, shared: bool = True) -> dict:
    """Phase 16: pipeline stages, sequence parallelism, Adafactor under tp
    and serving on a mesh. Hash dropout at the sp place against its plain
    version; XLM-R base MLM through cli.pretrain in this process at dropout
    0 (AdamW) and at dropout 0.1 (Adafactor) as the references; then legs
    in processes of their own, gloo ranks sharing card 0 (`shared`): pp 2
    at dropout 0 against the reference, tp 2 and tp 2 with --sp at dropout
    0.1 against each other, pp 2 at dropout 0.1 (hash dropout's launches
    on each stage), tp 2 with --sp under Adafactor against its reference;
    and the int8 service of phase 4's weights at dp 2 and tp 2 against the
    service in this process. Without `shared` (four cards) the legs are pp
    4, pp 2 x tp 2, pp 2 x dp 2, fsdp at dp 4 and tp 2 with and without
    --sp over NCCL, and the service at dp 4."""
    site = check_dropout("hash_dropout", P16_SP_SHAPE, torch.float32,
                         args.seed + 60, dev, True, card_line,
                         (P16_SP_PLACE,))
    torch.cuda.empty_cache()
    cfg = TowerConfig.from_dict(P16_TOWER)
    world = torch.cuda.device_count()
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = p16_files(tmp, args.seed + 61)

        def job(name, dropout, *extra, adafactor=False, ref="ref0",
                reference=False):
            return {"kind": "pretrain", "adafactor": adafactor,
                    "argv": p16_argv(paths, os.path.join(tmp, name),
                                     dropout, *extra),
                    "ref_path": os.path.join(tmp, ref + ".pt"),
                    "reference": reference}

        refs = {}
        for name, dropout, ada in (("ref0", False, False),
                                   ("ref_ada", True, True))[:2 if shared
                                                            else 1]:
            j = job(name, dropout, adafactor=ada, ref=name, reference=True)
            refs[name] = p16_pretrain_run(j["argv"], dev, ada,
                                          j["ref_path"], True)
            emit(phase="pipeline_reference", leg=name, card=card_line,
                 **{k: v for k, v in refs[name].items() if k != "sums"})
            torch.cuda.empty_cache()
        if shared:
            specs = {
                "pp2": (2, job("pp2", False, "--pp", "2"), "ref0", False),
                "tp2_dropout": (2, job("tp2d", True, "--tp", "2",
                                       ref="tp2d", reference=True),
                                None, False),
                "tp2_sp_dropout": (2, job("sp2d", True, "--tp", "2", "--sp",
                                          ref="tp2d"), "tp2_dropout", True),
                "pp2_dropout": (2, job("pp2d", True, "--pp", "2",
                                       ref="pp2d", reference=True), None,
                                False),
                "tp2_sp_adafactor": (2, job("sp2ada", True, "--tp", "2",
                                            "--sp", adafactor=True,
                                            ref="ref_ada"), "ref_ada",
                                     False)}
            backend = "gloo"
        else:
            specs = {
                f"pp{world}": (world, job("ppw", False, "--pp", str(world)),
                               "ref0", False),
                "pp2_tp2": (4, job("pptp", False, "--pp", "2", "--tp", "2"),
                            "ref0", False),
                "pp2_dp2": (4, job("ppdp", False, "--pp", "2", "--dp", "2"),
                            "ref0", False),
                f"fsdp{world}": (world, job("fsdp", False, "--dp",
                                            str(world), "--fsdp"), "ref0",
                                 False),
                # --sp's reduce-scatter over NCCL, against tp 2 there
                "tp2_dropout": (2, job("tp2d", True, "--tp", "2",
                                       ref="tp2d", reference=True),
                                None, False),
                "tp2_sp_dropout": (2, job("sp2d", True, "--tp", "2", "--sp",
                                          ref="tp2d"), "tp2_dropout", True)}
            backend = "nccl"
            specs = {k: v for k, v in specs.items() if v[0] <= world}
        for name, (w, j, against, bits) in specs.items():
            ranks = spawn_leg(f"phase 16 leg {name}", w, backend, j,
                              p16_rank)
            legs[name] = ranks
            torch.cuda.empty_cache()
            if against is None:
                # the reference of the next leg, or pp 2 at dropout 0.1:
                # finite losses, moved stages and the launch counts
                ref = {"records": ranks[0]["records"],
                       "sums": ranks[0]["sums"]}
                ranks[0].update(param_gap=0.0, param_gap_leaf=None)
            else:
                ref = refs.get(against) or legs[against][0]
            p16_check(name, ranks, ref, cfg, f"pipeline_{backend}", bits)

        # serving: the one-process service here, then the mesh legs
        one = p16_serve_run(dev, args.seed, os.path.join(tmp, "one.jsonl"))
        emit(phase="pipeline_serve_reference", card=card_line,
             **{k: v for k, v in one.items() if k not in ("scores",
                                                           "orders")})
        serve_specs = ({"serve_dp2": (2, ["--dp", "2", "--tp", "1"]),
                        "serve_tp2": (2, ["--dp", "1", "--tp", "2"])}
                       if shared else
                       {f"serve_dp{world}": (world, ["--dp", str(world),
                                                     "--tp", "1"])})
        for name, (w, mesh_argv) in serve_specs.items():
            ranks = spawn_leg(f"phase 16 leg {name}", w, backend, {
                "kind": "serve", "argv": mesh_argv, "seed": args.seed,
                "path": os.path.join(tmp, name + ".jsonl")}, p16_rank)
            legs[name] = ranks
            dp = ranks[0]["dp"] > 1
            p16_serve_check(name, ranks, one, card_line,
                            2 * P16_SERVE_BATCHES if dp else 0)
            if not dp and not all(2 * r["fc2_local_in"] == one["fc2_local_in"]
                                  for r in ranks):
                raise AssertionError(f"{name}: fc2 is not split over tp")
            torch.cuda.empty_cache()
    sp_legs = [r for k, v in legs.items() if "_sp_" in k for r in v]
    return {
        "site": site,
        "sp_place_launches": sum(r["hash_dropout_place_launches"]
                                 for r in sp_legs),
        "pp_launches": sum(r["hash_dropout_launches"]
                           for r in legs.get("pp2_dropout", [])),
        "serve_k1_launches": sum(r["k1_launches"] for k, v in legs.items()
                                 if k.startswith("serve_dp") for r in v)}


# -- phase 17: the encoder-only pretraining processors, K2 under tp, the
# trace window ---------------------------------------------------------------
P17_STEPS = 3                       # bert's optimizer steps
P17_DOCS = 260                      # documents of the synthetic bert corpus
# a tp-2 rank's half of the rollout's fc2 site: (rows, K / 2, N)
K2_TP_SHAPE = (ROLLOUT_ROWS, H // 2, D)
P17_TSV_ROWS = 9630                 # MQ2008's rows, phase 13's shape
P17_PROFILE_STEPS = 21              # stage 1 past the window (10 to 20)


def bert_files(tmp: str, seed: int) -> dict:
    """Phase 14's vocabulary, a corpus of P17_DOCS documents (blank-line
    separated, 4 to 9 sentences of 8 to 40 Zipf-distributed words each),
    and XLM-R base's config with the mlm and sp targets (bert's)."""
    paths = pretrain_corpus(tmp, seed)
    rng = np.random.default_rng(seed + 1)
    n_words = PRE_VOCAB - len(PRE_SPECIALS)
    lines = []
    for _ in range(P17_DOCS):
        for _ in range(int(rng.integers(4, 10))):
            ranks = rng.zipf(1.1, size=int(rng.integers(8, 41)))
            lines.append(" ".join(f"w{min(r, n_words) - 1}" for r in ranks))
        lines.append("")
    paths["docs"] = os.path.join(tmp, "docs.txt")
    with open(paths["docs"], "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    paths["bert_tower"] = os.path.join(tmp, "xlmr_base_bert.json")
    with open(paths["bert_tower"], "w") as f:
        json.dump({**XLMR_BASE, "target": ["mlm", "sp"]}, f)
    return paths


def bert_path(seed: int, dev, card_line: str) -> dict:
    """Phase 17, first: hash dropout against its plain version at bert's
    two sites, then `cli.pretrain` at --data_processor bert --hash_dropout
    (XLM-R base, the mlm and sp targets, 2 micro-batches of 32 x 128, the
    pair_sp form) for P17_STEPS steps, built as main builds it; the
    launches, finite losses and moved weights held. Returns the sites and
    the launches."""
    sites = {name: check_dropout("hash_dropout", shape, torch.float32,
                                 seed + i, dev, False, card_line)
             for i, (name, shape) in enumerate(PRE_SITES.items())}
    cfg = TowerConfig.from_dict(XLMR_BASE)
    want = (1 + 3 * cfg.layers_num) * 2 * PRE_ACCUM * P17_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        paths = bert_files(tmp, seed + 2)
        out = os.path.join(tmp, "bert")
        argv = pretrain_argv(paths, out, P17_STEPS)
        for flag, key in (("--corpus_path", "docs"),
                          ("--tower_config", "bert_tower")):
            argv[argv.index(flag) + 1] = paths[key]
        argv[argv.index("--data_processor") + 1] = "bert"
        trainer, loader = pretrain.build(pretrain.parser().parse_args(argv),
                                         dev)
        hash_dropout.launches = 0
        with watched_init() as seen:
            state, best = trainer.fit(loader, P17_STEPS)
        torch.cuda.synchronize()
        launches = hash_dropout.launches
        with open(out + ".log.jsonl") as f:
            recs = [json.loads(line) for line in f]
        params = dict(state.model.named_parameters())
        move = {k: float((params[k].detach().cpu() - v).abs().max())
                for k, v in seen[0].items()}
        losses = [r["loss"] for r in recs]
        instances = len(loader.ds)
        if not (trainer.form == "pair_sp" and len(recs) == P17_STEPS
                and np.isfinite(losses).all()
                and all(v > 0 for v in move.values())
                and launches == want):
            raise AssertionError(
                f"bert: form {trainer.form}, losses {losses}, moved {move}, "
                f"{launches} hash dropout launches (want {want})")
        del trainer, loader, state, params
    torch.cuda.empty_cache()
    emit(phase="bert", processor="bert", form="pair_sp",
         targets=["mlm", "sp"], micro_batch=[PRE_BS, PRE_SEQ],
         accumulation=PRE_ACCUM, steps=P17_STEPS, instances=instances,
         losses=losses, accs=[r["acc"] for r in recs], best_acc=best,
         moved=move, hash_dropout_launches=launches,
         hash_dropout_launches_expected=want,
         sites={k: v["forward_bit_equal"] and v["backward_bit_equal"]
                for k, v in sites.items()},
         card=card_line)
    return {"sites": sites, "launches": launches}


def check_k2_tp(seed: int, dev, card_line: str) -> dict:
    """Phase 17: the tp entry's two kernels against their plain versions,
    bit for bit, at a tp-2 rank's shard of the rollout's fc2 site, with
    their times beside the plain versions', the bounds and torch._int_mm's
    (the same int32 product from the same int8 operands)."""
    rows, k, n = K2_TP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, k, device=dev, generator=gen).to(torch.bfloat16)
    q, s = quantize_weight(torch.randn(n, k, device=dev, generator=gen)
                           * 0.05)
    xq, xs = quantize_rows(x.float())
    del x
    acc = int8_dot_s32(xq, q)
    y = s32_epilogue(acc, xs, s, torch.bfloat16)
    torch.cuda.synchronize()
    acc_ref = int8_dot_s32_reference(xq, q)
    y_ref = s32_epilogue_reference(acc, xs, s, torch.bfloat16)
    out = {
        "int8_dot_s32": {"bit_equal": bool(torch.equal(acc, acc_ref)),
                         "max_abs_err": float((acc - acc_ref).abs().max())},
        "s32_epilogue": {"bit_equal": bool(torch.equal(y, y_ref)),
                         "max_abs_err": float((y.float() - y_ref.float())
                                              .abs().max())}}
    del acc_ref, y, y_ref
    if not all(r["bit_equal"] for r in out.values()):
        emit(phase="k2_tp_vs_plain", failed=True, **out)
        raise AssertionError(f"the tp entry disagrees with its plain "
                             f"versions: {out}")
    r = out["int8_dot_s32"]
    r["ms"] = cuda_ms(lambda: int8_dot_s32(xq, q))
    r["plain_ms"] = cuda_ms(lambda: int8_dot_s32_reference(xq, q), iters=3,
                            warmup=1)
    r["library_ms"] = cuda_ms(lambda: torch._int_mm(xq, q.t()))
    r.update(bound(rows * k + n * k + 4 * rows * n, 2 * rows * k * n,
                   INT8_TENSOR_OPS_PER_S))
    r = out["s32_epilogue"]
    r["ms"] = cuda_ms(lambda: s32_epilogue(acc, xs, s, torch.bfloat16))
    r["plain_ms"] = cuda_ms(
        lambda: s32_epilogue_reference(acc, xs, s, torch.bfloat16))
    r["library_ms"] = None          # no one PyTorch call rescales int32
    r.update(bound(4 * rows * n + 4 * rows + 4 * n + 2 * rows * n,
                   2 * rows * n, VECTOR_OPS_PER_S))
    for name, r in out.items():
        r["bound_share"] = r["bound_ms"] / r["ms"]
        emit(phase="k2_tp_vs_plain", kernel=name, rows=rows, k=k, n=n,
             card=card_line, **r)
    del xq, xs, acc
    torch.cuda.empty_cache()
    return out


def p17_k2_leg(mesh, dev, seed: int) -> dict:
    """The rollout's fc2 site at tp 2 with NARROW_SITES on: this rank's
    half of K through int8_linear (the tp entry, its int32 parts summed
    over tp), held bit for bit against K2 on the whole arrays, which each
    rank also computes. The tp entry's launches are counted from 0 over
    the tp call alone."""
    rows, k, n = ROLLOUT_ROWS, H, D
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, k, device=dev, generator=gen).to(torch.bfloat16)
    q, s = quantize_weight(torch.randn(n, k, device=dev, generator=gen)
                           * 0.05)
    half = slice(mesh.tp_rank * k // 2, (mesh.tp_rank + 1) * k // 2)
    xh, qh = x[:, half].contiguous(), q[:, half].contiguous()
    with int8_routing(NARROW_SITES=True):
        int8_dot_s32.launches = s32_epilogue.launches = 0
        int8_matmul.launches = 0
        got = int8_ops.int8_linear(xh, qh, s, torch.bfloat16, shape=(n, k),
                                   mesh=mesh)
        torch.cuda.synchronize()
        counts = {"int8_dot_s32": int8_dot_s32.launches,
                  "s32_epilogue": s32_epilogue.launches,
                  "int8_matmul": int8_matmul.launches}
    want = int8_matmul(x, q, s, torch.bfloat16)
    torch.cuda.synchronize()
    return {"launches": counts, "bit_equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got.float() - want.float()).abs().max())}


def p17_project_leg(job: dict, dp: int, tp: int, dev) -> str:
    """project_tsv of the phase's tsv at (dp, tp) on this rank's device;
    rank 0 writes. Returns the file rank 0 wrote."""
    from lr2ppo_torch.parallel.mesh import active

    cfg = tab_config(job["tmp"], f"p17_dp{dp}_tp{tp}", job["seed"],
                     "--dp", str(dp), "--tp", str(tp))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                trad_dims=job["dims"]))
    out = os.path.join(job["tmp"], f"projected_dp{dp}_tp{tp}.tsv")
    sd = torch.load(job["state"], map_location=dev)
    project_tsv(cfg, sd, job["tsv"], out, device=dev)
    return out if active().is_main else None


def p17_rank(rank, world, url, backend, job, queue) -> None:
    """One gloo rank of phase 17's spawn, sharing card 0: the K2 tp leg,
    then project_tsv at dp 2 and at tp 2."""
    import traceback

    import torch.distributed as dist

    from lr2ppo_torch.parallel.mesh import make_mesh, set_active

    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=url, rank=rank,
                                world_size=world)
        mesh = make_mesh(1, 2)
        set_active(mesh)
        res = {"k2": p17_k2_leg(mesh, dev, job["seed"])}
        torch.cuda.empty_cache()
        res["projected"] = {f"dp{dp}_tp{tp}": p17_project_leg(job, dp, tp,
                                                              dev)
                            for dp, tp in ((2, 1), (1, 2))}
        res["card"] = card()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_legs(seed: int, dev, card_line: str) -> dict:
    """Phase 17's one spawn of two gloo ranks sharing card 0: K2's tp route
    at the rollout's fc2 site bit-equal to K2 at world 1 on each rank; the
    export of a seeded flagship-width 2-data model's projection of an
    MQ2008-shaped tsv at dp 2 (world 1's file byte for byte) and at tp 2
    (within float32 rounding of world 1's), rank 0 writing."""
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(seed)
        n, feats = P17_TSV_ROWS, LETOR_SHAPES["mq2008"][1]
        rows = np.concatenate(
            [rng.integers(0, 3, (n, 1)), np.sort(rng.integers(0, 400, (n, 1)),
                                                 axis=0),
             rng.standard_normal((n, feats))], axis=1).astype(np.float32)
        tsv = os.path.join(tmp, "mq2008.tsv")
        write_tsv(rows, tsv)
        dims = [feats, LETOR_SHAPES["web10k"][1]]
        cfg = tab_config(tmp, "p17_world1", seed)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    trad_dims=dims))
        model = TwoDataScoreModel(cfg.model, device=dev)
        init_weights(model, torch.Generator(device=dev).manual_seed(seed))
        state = os.path.join(tmp, "two_data.pt")
        torch.save(model.state_dict(), state)
        one = os.path.join(tmp, "projected_world1.tsv")
        project_tsv(cfg, model.state_dict(), tsv, one, device=dev)
        del model
        job = {"tmp": tmp, "seed": seed, "dims": dims, "tsv": tsv,
               "state": state}
        ranks = spawn_leg("phase 17", 2, "gloo", job, p17_rank,
                          timeout=300)
        with open(one) as f:
            want = f.read()
        files = ranks[0]["projected"]
        with open(files["dp2_tp1"]) as f:
            dp_equal = f.read() == want
        a, b = read_tsv(files["dp1_tp2"]), read_tsv(one)
        tp_gap = float(np.abs(a - b).max())
        tp_scale = float(np.abs(b[:, 2:]).max())
        rank1_wrote = any(v is not None
                          for v in ranks[1]["projected"].values())
    k2 = [r["k2"] for r in ranks]
    res = {"k2_tp_bit_equal": [r["bit_equal"] for r in k2],
           "k2_tp_launches": [r["launches"] for r in k2],
           "project_dp2_byte_equal": dp_equal,
           "project_tp2_max_abs_diff": tp_gap,
           "project_tp2_scale": tp_scale, "project_head_equal":
               bool(np.array_equal(a[:, :2], b[:, :2])),
           "rank1_wrote": rank1_wrote,
           "ranks_card": [r["card"] for r in ranks], "card": card_line}
    emit(phase="p17_mesh_legs", **res)
    if not (all(res["k2_tp_bit_equal"]) and dp_equal
            and res["project_head_equal"] and not rank1_wrote
            and tp_gap <= 1e-5 * tp_scale
            and all(c == {"int8_dot_s32": 1, "s32_epilogue": 1,
                          "int8_matmul": 0} for c in res["k2_tp_launches"])):
        raise AssertionError(f"phase 17's mesh legs: {res}")
    return {"launches": {name: sum(c[name] for c in res["k2_tp_launches"])
                         for name in ("int8_dot_s32", "s32_epilogue")},
            "max_abs_err": max(r["max_abs_err"] for r in k2)}


def traced_stage1(seed: int, dev, card_line: str) -> dict:
    """Phase 17, last: stage 1 at phase 12's geometry (batch 32 x 32 tags,
    --profile fast) for P17_PROFILE_STEPS steps with --profile_dir: the
    window of steps 10 to 20 is written as one Chrome trace, which must
    name the hash dropout kernel (6 launches a step) and the products."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = stage_config(tmp, "p17_stage1", seed, BUCKET)
        cfg = cfg.replace(profile_dir=os.path.join(tmp, "profile"),
                          report_steps=P17_PROFILE_STEPS)
        trainer = PointwiseTrainer(cfg, dev)
        # three batches in turn: 21 of 616 MB would take a while to draw
        batches = item_batches(3, cfg.model, seed, STAGE_BS, BUCKET)
        loader = BatchList([batches[i % 3]
                            for i in range(P17_PROFILE_STEPS)])
        evb, _ = synthetic_batches(1, cfg.model, seed + 1, items=8,
                                   bucket=8, tags=(2, 8))
        state, _ = trainer.fit(loader, evb)
        torch.cuda.synchronize()
        path = trainer.trace_path
        if not (path and os.path.exists(path)):
            raise AssertionError(f"stage 1 with --profile_dir wrote no "
                                 f"trace (trace_path {path})")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernels = sorted({e["name"] for e in events
                          if e.get("cat") == "kernel"})
        hash_n = sum(1 for e in events if e.get("cat") == "kernel"
                     and "hash_dropout" in e.get("name", ""))
        steps = state.step
        del trainer, state, loader, batches, events
    torch.cuda.empty_cache()
    res = {"steps": steps, "trace": os.path.basename(path),
           "trace_bytes": size, "kernel_names": len(kernels),
           "kernels": kernels[:40], "hash_dropout_kernels_traced": hash_n,
           "hash_dropout_launches_in_window": 6 * 10,
           "ops_named": sorted(n for n in names if n.startswith("aten::"))[
               :20], "card": card_line}
    emit(phase="p17_profile_dir", **res)
    if not (steps == P17_PROFILE_STEPS and size > 0 and hash_n > 0
            and "aten::mm" in names):
        raise AssertionError(f"stage 1 with --profile_dir: {res}")
    return res


def processors_path(args, dev, card_line: str) -> dict:
    """Phase 17: bert at XLM-R base width, the tp entry's kernels, the
    spawn of two gloo ranks (K2 at tp 2, project_tsv at dp 2 and tp 2) and
    stage 1's trace window. Returns the kernels' runs and launches."""
    bert = bert_path(args.seed + 70, dev, card_line)
    k2tp = check_k2_tp(args.seed + 71, dev, card_line)
    legs = mesh_legs(args.seed + 72, dev, card_line)
    traced_stage1(args.seed + 73, dev, card_line)
    return {"bert": bert, "k2_tp": k2tp, "legs": legs}



# -- phase 18: the seq2seq towers -------------------------------------------
# T5-base as Raffel et al. (2020) publish it: google-t5/t5-base's
# config.json, which TencentPretrain's models/t5/base_config.json mirrors
# (12 + 12 layers of 768, 12 heads, FFN 3072, ReLU, RMS norms at pre-LN, no
# biases, no attention scale, no embedding norm, 32 relative-position
# buckets, untied target-side words, no LM-head bias)
T5_BASE = {
    "emb_size": 768, "hidden_size": 768, "feedforward_size": 3072,
    "heads_num": 12, "layers_num": 12, "decoder_layers_num": 12,
    "hidden_act": "relu", "dropout": 0.1, "embedding": ["word"],
    "tgt_embedding": ["word"], "encoder": "transformer",
    "mask": "fully_visible", "decoder": "transformer", "target": ["lm"],
    "layernorm": "t5", "layernorm_positioning": "pre",
    "feed_forward": "dense", "remove_transformer_bias": True,
    "remove_attention_scale": True, "remove_embedding_layernorm": True,
    "relative_position_embedding": True,
    "relative_attention_buckets_num": 32, "has_lmtarget_bias": False,
}
# Transformer base as Vaswani et al. (2017, Table 3 "base") publish it:
# 6 + 6 layers of 512, 8 heads, FFN 2048, ReLU, word + sinusoidal positions
# on both sides, post-LN, dropout 0.1
TRANSFORMER_BASE = {
    "emb_size": 512, "hidden_size": 512, "feedforward_size": 2048,
    "heads_num": 8, "layers_num": 6, "decoder_layers_num": 6,
    "hidden_act": "relu", "dropout": 0.1,
    "embedding": ["word", "sinusoidalpos"],
    "tgt_embedding": ["word", "sinusoidalpos"], "encoder": "transformer",
    "mask": "fully_visible", "decoder": "transformer", "target": ["lm"],
    "layernorm_positioning": "post",
}
# a space vocabulary of 32,028 entries, specials first; the t5 processor
# adds its 100 sentinels: T5's 32,128
S2S_VOCAB, S2S_SENTINELS = 32028, 100
S2S_BS, S2S_ACCUM, S2S_SEQ, S2S_TGT = 32, 2, 128, 128
S2S_STEPS = 4                       # leg A: optimizer steps
S2S_SHORT_TGT = 64                  # the batch of the non-square site
MT_STEPS, MT_ROWS = 2, 96           # leg B: optimizer steps, tsv rows
S2S_WATCHED = ("decoder.transformer_decoder.11.context_attn.linear_layers."
               "1.weight",
               "encoder.relative_pos_emb.relative_attention_bias.weight",
               "target.lm.output_layer.weight")
# the first decoder layer's context probabilities in a pass's forward order
# of sites: 1 + 3 x 12 in the encoder, the target embedding, the decoder
# layer's self-attention probabilities and its branch
CONTEXT_SITE = 1 + 3 * 12 + 1 + 2


def s2s_sites_a_pass(cfg) -> int:
    """Hash-dropout sites of one training pass: the embedding and 3 a layer
    in the encoder, the target embedding and 5 a layer in the decoder."""
    return (1 + 3 * cfg.layers_num
            + 1 + 5 * (cfg.decoder_layers_num or cfg.layers_num))


def s2s_argv(paths: dict, out: str, processor: str, steps: int,
             tgt: int = None) -> list:
    return ["--corpus_path", paths["corpus"], "--tower_config",
            paths["tower"], "--data_processor", processor, "--tokenizer",
            "space", "--vocab_path", paths["vocab"], "--hash_dropout",
            "--batch_size", str(S2S_BS), "--accumulation_steps",
            str(S2S_ACCUM), "--seq_length", str(S2S_SEQ),
            "--tgt_seq_length", str(tgt or S2S_TGT), "--total_steps",
            str(steps),
            "--report_steps", "1", "--output_model_path", out,
            "--log_path", out + ".log"]


def mt_tsv(path: str, seed: int) -> None:
    """MT_ROWS 'source<TAB>target' rows of Zipf-distributed words of the
    phase's vocabulary, 20 to 120 words a side."""
    rng = np.random.default_rng(seed)
    n_words = S2S_VOCAB - len(PRE_SPECIALS)

    def side():
        ranks = rng.zipf(1.1, size=int(rng.integers(20, 121)))
        return " ".join(f"w{min(r, n_words) - 1}" for r in ranks)

    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(f"{side()}\t{side()}\n" for _ in range(MT_ROWS)))


def site_input(model, mb: dict, index: int, seed: int,
               form: str = "seq2seq"):
    """The input and seed of the index-th hash-dropout site of one training
    forward of `model` on micro-batch `mb` (of batch form `form`)."""
    from lr2ppo_torch.ops import hash_dropout as hd

    real, calls, kept = hd.hash_dropout, [0], {}

    def rec(x, seed, rate, *place):
        if calls[0] == index:
            kept["x"], kept["seed"] = x.detach().clone(), seed
        calls[0] += 1
        return real(x, seed, rate, *place)

    # the kernel's wrapper counts its launches on the module's entry
    rec.launches, rec.place_launches = real.launches, real.place_launches
    hd.hash_dropout = rec
    try:
        with torch.no_grad():
            model(*pretrain_form_args(form, mb), deterministic=False,
                  generator=torch.Generator().manual_seed(seed))
    finally:
        hd.hash_dropout = real
        real.launches, real.place_launches = (rec.launches,
                                              rec.place_launches)
    return kept["x"], kept["seed"]


def t5_path(seed: int, dev, card_line: str) -> dict:
    """Phase 18, leg A: T5-base span corruption through cli.pretrain's
    build and fit (--data_processor t5 --hash_dropout, full width, 2
    micro-batches of 32 x (128 + 128), float32, S2S_STEPS steps); the
    parameter count, losses that fall, moved leaves, the launches; then the
    first decoder layer's
    context-probability site of that batch (32, 12, 128, 128) and of a
    --tgt_seq_length 64 batch (32, 12, 64, 128) held against the plain hash
    dropout on the site's own input and seed."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, seed, S2S_VOCAB, T5_BASE)
        out = os.path.join(tmp, "t5")
        argv = s2s_argv(paths, out, "t5", S2S_STEPS)
        trainer, loader = pretrain.build(pretrain.parser().parse_args(argv),
                                         dev)
        cfg = trainer.tower_cfg
        want = s2s_sites_a_pass(cfg) * 2 * S2S_ACCUM * S2S_STEPS
        reset_launches()
        hash_dropout.launches = 0
        with watched_init(S2S_WATCHED) as seen:
            state, best = trainer.fit(loader, S2S_STEPS)
        torch.cuda.synchronize()
        launches = hash_dropout.launches
        k4_launches = fused_attention.launches
        with open(out + ".log.jsonl") as f:
            recs = [json.loads(line) for line in f]
        model = state.model
        params = dict(model.named_parameters())
        counts = {part: sum(p.numel() for k, p in params.items()
                            if k.startswith(part))
                  for part in ("embedding.", "encoder.", "tgt_embedding.",
                               "decoder.", "target.")}
        n_params = sum(p.numel() for p in params.values())
        move = {k: float((params[k].detach().cpu() - v).abs().max())
                for k, v in seen[0].items()}
        losses = [r["loss"] for r in recs]
        if not (trainer.form == "seq2seq"
                and cfg.vocab_size == S2S_VOCAB + S2S_SENTINELS
                and len(recs) == S2S_STEPS and np.isfinite(losses).all()
                and losses[-1] < losses[0]
                and all(v > 0 for v in move.values())
                and launches == want and k4_launches == 0):
            raise AssertionError(
                f"t5: form {trainer.form}, vocabulary {cfg.vocab_size}, "
                f"losses {losses}, moved {move}, {launches} hash dropout "
                f"launches (want {want}), {k4_launches} K4 launches")
        batch = trainer.ctx.put({k: v for k, v in next(iter(loader)).items()
                                 if not k.startswith("_")})
        tgt_tokens = int(batch["tgt_seg"].sum())
        micro = {k: v[:S2S_BS] for k, v in batch.items()}
        _, short_loader = pretrain.build(pretrain.parser().parse_args(
            s2s_argv(paths, out + "-short", "t5", 1, S2S_SHORT_TGT)), dev)
        short = trainer.ctx.put({k: v[:S2S_BS] for k, v in
                                 next(iter(short_loader)).items()
                                 if not k.startswith("_")})
        sites = {}
        for name, mb in (("context_square", micro),
                         ("context_non_square", short)):
            x, site_seed = site_input(model, mb, CONTEXT_SITE, seed)
            sites[name] = check_dropout("hash_dropout", tuple(x.shape),
                                        torch.float32, seed, dev, False,
                                        card_line, x=x)
            sites[name]["site_seed"] = site_seed
            del x
        shapes = [s["shape"] for s in sites.values()]
        if shapes != [[S2S_BS, 12, S2S_TGT, S2S_SEQ],
                      [S2S_BS, 12, S2S_SHORT_TGT, S2S_SEQ]]:
            raise AssertionError(f"t5: context sites {shapes}")
        del trainer, loader, state, model, params, batch, micro, short
    torch.cuda.empty_cache()
    emit(phase="t5", processor="t5", form="seq2seq", params=n_params,
         params_by_part=counts, vocab=cfg.vocab_size,
         micro_batch=[S2S_BS, S2S_SEQ, S2S_TGT], accumulation=S2S_ACCUM,
         steps=S2S_STEPS, losses=losses, accs=[r["acc"] for r in recs],
         best_acc=best, moved=move, hash_dropout_launches=launches,
         hash_dropout_launches_expected=want,
         hash_dropout_sites_a_pass=s2s_sites_a_pass(cfg),
         target_tokens_a_step=tgt_tokens,
         sites={k: {"shape": v["shape"], "bit_equal":
                    v["forward_bit_equal"] and v["backward_bit_equal"]}
                for k, v in sites.items()},
         card=card_line)
    return {"launches": launches, "sites": sites}


def mt_path(seed: int, dev, card_line: str) -> dict:
    """Phase 18, leg B: Transformer base through cli.pretrain at
    --data_processor mt --hash_dropout (sinusoidal positions, the post-LN
    decoder) on a synthetic tsv, MT_STEPS steps: finite losses, the
    launches, the checkpoint reloaded strict."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, seed, S2S_VOCAB, TRANSFORMER_BASE)
        paths["corpus"] = os.path.join(tmp, "mt.tsv")
        mt_tsv(paths["corpus"], seed + 1)
        out = os.path.join(tmp, "mt")
        trainer, loader = pretrain.build(pretrain.parser().parse_args(
            s2s_argv(paths, out, "mt", MT_STEPS)), dev)
        cfg = trainer.tower_cfg
        want = s2s_sites_a_pass(cfg) * 2 * S2S_ACCUM * MT_STEPS
        hash_dropout.launches = 0
        state, _ = trainer.fit(loader, MT_STEPS)
        torch.cuda.synchronize()
        launches = hash_dropout.launches
        with open(out + ".log.jsonl") as f:
            losses = [json.loads(line)["loss"] for line in f]
        n_params = sum(p.numel() for p in state.model.parameters())
        del trainer, state
        TowerModel(cfg, device="meta", with_target=True).load_state_dict(
            load_tower_checkpoint(out), strict=True, assign=True)
        if not (len(losses) == MT_STEPS and np.isfinite(losses).all()
                and launches == want):
            raise AssertionError(f"mt: losses {losses}, {launches} hash "
                                 f"dropout launches (want {want})")
    torch.cuda.empty_cache()
    emit(phase="mt", processor="mt", form="seq2seq", params=n_params,
         vocab=cfg.vocab_size, rows=len(loader.ds), steps=MT_STEPS,
         losses=losses, hash_dropout_launches=launches,
         hash_dropout_launches_expected=want, card=card_line)
    return {"launches": launches}


def seq2seq_path(args, dev, card_line: str) -> dict:
    """Phase 18: T5-base span corruption (leg A) and Transformer base MT
    (leg B). Returns the sites' runs and the launches."""
    t5 = t5_path(args.seed + 80, dev, card_line)
    mt = mt_path(args.seed + 81, dev, card_line)
    return {"sites": t5["sites"], "launches": t5["launches"]
            + mt["launches"]}

# -- phase 19: the other encoders ---------------------------------------------
# The large LSTM LM of Zaremba, Sutskever & Vinyals (2014, arXiv:1409.2329,
# section 4.1, "large"): 2 layers of 1,500 units, embedding 1,500, dropout
# 0.65 on the embedding, between the layers and at the output, 35 steps
# unrolled, batch 20, a 10,000-word vocabulary, no bias on the softmax layer
LSTM_LARGE = {
    "emb_size": 1500, "hidden_size": 1500, "layers_num": 2, "dropout": 0.65,
    "embedding": ["word"], "remove_embedding_layernorm": True,
    "encoder": "lstm", "target": ["lm"],
}
LSTM_VOCAB, LSTM_BS, LSTM_SEQ = 10000, 20, 35
LSTM_STEPS, BILM_STEPS, ZOO_STEPS = 4, 2, 1
LSTM_LR = 1e-3
# 15.0 M embedding + 2 x 18.012 M LSTM (4 gates x 1,500 x (1,500 + 1,500)
# weights, 2 x 6,000 biases) + 15.0 M softmax: the paper's 66 M
LSTM_PARAMS = 66_024_000
LSTM_WATCHED = ("embedding.word.embedding.weight",
                "encoder.rnn.weight_hh_l1", "target.lm.output_layer.weight")
# the card's float32 forward against the CPU's on the same weights and
# batch: the hidden states (|h| < 1) to LSTM_CPU_ATOL, the loss to
# LSTM_CPU_RTOL; float32 sums in other orders stay ~1e-6 off
LSTM_CPU_ATOL, LSTM_CPU_RTOL = 1e-4, 1e-5
# the rest of the zoo at the LSTM leg's widths, one step each: the encoder
# overlay and the processor (lm, or bilm where the tower has two halves)
ZOO = {
    "rnn": ({"encoder": "rnn"}, "lm"),
    "gru": ({"encoder": "gru"}, "lm"),
    "lstm_bidirectional": ({"encoder": "lstm", "bidirectional": True},
                           "bilm"),
    "birnn": ({"encoder": "birnn", "target": ["bilm"]}, "bilm"),
    "bigru": ({"encoder": "bigru", "target": ["bilm"]}, "bilm"),
    "gatedcnn": ({"encoder": "gatedcnn", "kernel_size": 4, "layers_num": 8,
                  "block_size": 2}, "lm"),
}
# CLIP ViT-B/16 at OpenAI's published widths (Radford et al. 2021;
# openai/clip-vit-base-patch16): a 12 x 512 causal text transformer (8
# heads, FFN 2,048, 77 tokens, vocabulary 49,408, pre-LN, no embedding norm,
# pooled at the last token) and a 12 x 768 ViT-B/16 (12 heads, FFN 3,072,
# 224 x 224 at patch 16 = 197 tokens, pre-LN with the embedding norm,
# pooled at [CLS]), both projected to 512 without bias, dropout 0. The JAX
# package has no quick-GELU, so the tanh GELU stands in.
CLIP_VIT_B16 = {
    "encoder": "dual", "target": ["clr"], "projection": True,
    "feature_size": 512, "dropout": 0.0, "hidden_act": "gelu_fast",
    "vocab_size": 49408, "image_height": 224, "image_width": 224,
    "patch_size": 16, "channels_num": 3,
    "stream_0": {"embedding": ["word", "pos"], "encoder": "transformer",
                 "emb_size": 512, "hidden_size": 512, "heads_num": 8,
                 "feedforward_size": 2048, "layers_num": 12,
                 "max_seq_length": 77, "mask": "causal",
                 "layernorm_positioning": "pre",
                 "remove_embedding_layernorm": True, "pooling": "last"},
    "stream_1": {"embedding": ["patch", "pos"], "encoder": "transformer",
                 "emb_size": 768, "hidden_size": 768, "heads_num": 12,
                 "feedforward_size": 3072, "layers_num": 12,
                 "max_seq_length": 197, "mask": "fully_visible",
                 "layernorm_positioning": "pre",
                 "remove_embedding_layernorm": False, "pooling": "first"},
}
# OpenAI's module shapes: text 49,408 x 512 tokens, 77 x 512 positions, 12
# blocks of 3,152,384, ln_final 1,024; vision conv1 768 x 3 x 16 x 16, class
# 768, 197 x 768 positions, ln_pre 1,536, 12 blocks of 7,087,872, ln_post
# 1,536; projections 512 x 512 and 768 x 512; logit_scale 1
OPENAI_CLIP_B16_PARAMS = 149_620_737
CLIP_MICRO, CLIP_ACCUM, CLIP_STEPS = 64, 2, 4
CLIP_TEXT, CLIP_IMAGE = 77, 197
# CLIP's learning rate for ViT-B/16 (Radford et al. 2021, Table 20)
CLIP_LR = 5e-4
# the first step's loss within this many nats of ln 64, the loss of a
# micro-batch whose pairs the towers cannot yet tell apart
CLIP_START_BAND = 1.0
CLIP_WATCHED = ("encoder.encoder_0.transformer.11.feed_forward.linear_2."
                "weight",
                "encoder.encoder_1.transformer.0.self_attn.linear_layers.0."
                "weight",
                "embedding_1.patch.projection.weight",
                "target.clr.encoder_0_projection",
                "target.clr.encoder_1_projection", "target.clr.logit_scale")


def rnn_sites_a_pass(cfg) -> int:
    """Hash-dropout sites of one training pass of a recurrent or gated-CNN
    tower: the embedding, then per stack one between each two layers and
    one at the output (two stacks for the bi-stacks, none in the CNN)."""
    if cfg.encoder == "gatedcnn":
        return 1
    stacks = 2 if cfg.encoder.startswith("bi") else 1
    return 1 + stacks * cfg.layers_num


def lstm_argv(paths: dict, out: str, processor: str, steps: int) -> list:
    return ["--corpus_path", paths["corpus"], "--tower_config",
            paths["tower"], "--data_processor", processor, "--tokenizer",
            "space", "--vocab_path", paths["vocab"], "--hash_dropout",
            "--batch_size", str(LSTM_BS), "--seq_length", str(LSTM_SEQ),
            "--total_steps", str(steps), "--learning_rate", str(LSTM_LR),
            "--report_steps", "1", "--output_model_path", out,
            "--log_path", out + ".log"]


def lstm_run(paths: dict, tmp: str, name: str, tower: dict,
             processor: str, steps: int, dev, watched=()) -> dict:
    """cli.pretrain's build and fit of `tower` at `processor` for `steps`
    steps: the trainer, its state, the records, the hash-dropout launches
    (and the expected count), the first batch on the card and the watched
    leaves' moves."""
    with open(paths["tower"], "w") as f:
        json.dump(tower, f)
    out = os.path.join(tmp, name)
    trainer, loader = pretrain.build(pretrain.parser().parse_args(
        lstm_argv(paths, out, processor, steps)), dev)
    want = (rnn_sites_a_pass(trainer.tower_cfg) * 2 * steps)
    hash_dropout.launches = 0
    with watched_init(watched) as seen:
        state, _ = trainer.fit(loader, steps)
    torch.cuda.synchronize()
    launches = hash_dropout.launches
    with open(out + ".log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    params = dict(state.model.named_parameters())
    losses = [r["loss"] for r in recs]
    batch = trainer.ctx.put({k: v for k, v in next(iter(loader)).items()
                             if not k.startswith("_")})
    if not (len(recs) == steps and np.isfinite(losses).all()
            and launches == want
            and batch["src"].shape == (LSTM_BS, LSTM_SEQ)):
        raise AssertionError(
            f"{name}: losses {losses}, {launches} hash dropout launches "
            f"(want {want}), batch {tuple(batch['src'].shape)}")
    return {"trainer": trainer, "state": state, "losses": losses,
            "launches": launches, "want": want, "batch": batch,
            "params": sum(p.numel() for p in params.values()),
            "moved": {k: float((params[k].detach().cpu() - v).abs().max())
                      for k, v in (seen[0].items() if seen else ())}}


def lstm_vs_cpu(run: dict) -> dict:
    """One deterministic forward of the trained tower on the card and of a
    CPU copy of its weights on the same batch: the hidden states' and the
    loss's gaps, held to LSTM_CPU_ATOL and LSTM_CPU_RTOL."""
    model, batch = run["state"].model, run["batch"]
    cpu = TowerModel(run["trainer"].tower_cfg, with_target=True)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        strict=True)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    with torch.no_grad():
        hid = model.encode(batch["src"], batch["seg"]).cpu()
        loss = float(model(*pretrain_form_args("simple", batch))[0])
        want_hid = cpu.encode(cpu_batch["src"], cpu_batch["seg"])
        want_loss = float(cpu(*pretrain_form_args("simple", cpu_batch))[0])
    res = {"hidden_max_abs_err": float((hid - want_hid).abs().max()),
           "loss_card": loss, "loss_cpu": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "atol": LSTM_CPU_ATOL, "rtol": LSTM_CPU_RTOL,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    if not (res["hidden_max_abs_err"] <= LSTM_CPU_ATOL
            and res["loss_rel_err"] <= LSTM_CPU_RTOL):
        raise AssertionError(f"lstm: the card's forward against the CPU's: "
                             f"{res}")
    return res


def lstm_path(seed: int, dev, card_line: str) -> dict:
    """Phase 19, legs (a)-(c): the large LSTM LM (LSTM_STEPS steps at
    --data_processor lm --hash_dropout), its three dropout sites held
    against the plain hash dropout on their own inputs and seeds, the
    card's forward against the CPU's; the ELMo-style bilm on bilstm
    (BILM_STEPS steps); the rest of the zoo (ZOO_STEPS each)."""
    out, launches = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, seed, LSTM_VOCAB, LSTM_LARGE)
        run = lstm_run(paths, tmp, "lstm", LSTM_LARGE, "lm", LSTM_STEPS,
                       dev, LSTM_WATCHED)
        launches += run["launches"]
        losses, move = run["losses"], run["moved"]
        if not (run["params"] == LSTM_PARAMS and losses[-1] < losses[0]
                and all(v > 0 for v in move.values())):
            raise AssertionError(f"lstm: {run['params']} parameters (want "
                                 f"{LSTM_PARAMS}), losses {losses}, moved "
                                 f"{move}")
        state, batch = run["state"], run["batch"]
        sites = {}
        for index, name in enumerate(("embedding", "between_layers",
                                      "output")):
            x, site_seed = site_input(state.model, batch, index, seed,
                                      form="simple")
            sites[name] = check_dropout(
                "hash_dropout", tuple(x.shape), torch.float32, site_seed,
                dev, False, card_line, x=x, rate=LSTM_LARGE["dropout"])
            sites[name]["site_seed"] = site_seed
            del x
        if [s["shape"] for s in sites.values()] != \
                [[LSTM_BS, LSTM_SEQ, LSTM_LARGE["hidden_size"]]] * 3:
            raise AssertionError(f"lstm: sites {sites}")
        cpu = lstm_vs_cpu(run)
        emit(phase="lstm", processor="lm", encoder="lstm",
             params=run["params"], vocab=run["trainer"].tower_cfg.vocab_size,
             batch=[LSTM_BS, LSTM_SEQ], steps=LSTM_STEPS, losses=losses,
             moved=move, hash_dropout_launches=run["launches"],
             hash_dropout_launches_expected=run["want"],
             hash_dropout_sites_a_pass=rnn_sites_a_pass(
                 run["trainer"].tower_cfg), vs_cpu=cpu,
             sites={k: {"shape": v["shape"], "rate": v["rate"],
                        "bit_equal": v["forward_bit_equal"]
                        and v["backward_bit_equal"]}
                    for k, v in sites.items()},
             card=card_line)
        out["sites"] = sites
        del run, state, batch
        torch.cuda.empty_cache()
        bilm = lstm_run(paths, tmp, "bilm", {**LSTM_LARGE,
                                             "encoder": "bilstm",
                                             "target": ["bilm"]},
                        "bilm", BILM_STEPS, dev)
        launches += bilm["launches"]
        emit(phase="bilm", processor="bilm", encoder="bilstm",
             params=bilm["params"], steps=BILM_STEPS,
             losses=bilm["losses"], hash_dropout_launches=bilm["launches"],
             hash_dropout_launches_expected=bilm["want"], card=card_line)
        del bilm
        torch.cuda.empty_cache()
        zoo = {}
        for name, (overlay, processor) in ZOO.items():
            tower = {**LSTM_LARGE, "target": [processor], **overlay}
            r = lstm_run(paths, tmp, name, tower, processor, ZOO_STEPS, dev)
            launches += r["launches"]
            zoo[name] = {"params": r["params"], "losses": r["losses"],
                         "hash_dropout_launches": r["launches"]}
            del r
            torch.cuda.empty_cache()
        emit(phase="encoder_zoo", processor_by_encoder={
            k: v[1] for k, v in ZOO.items()}, legs=zoo, card=card_line)
    out["launches"] = launches
    return out


class ClipPairs:
    """ClipPairDataset.get's keys, shapes and dtypes, made from a seed in
    memory (the card's machine has no PIL): n captions of Zipf-distributed
    words of the text vocabulary, framed [cls] ... [sep] (ids 0 and 2, pad
    1, as the dataset frames them) at 5 to 77 tokens, and n images of
    uniform pixels in [0, 1)."""

    def __init__(self, n: int, seed: int, vocab: int):
        rng = np.random.default_rng(seed)
        self.src = np.ones((n, CLIP_TEXT), np.int32)
        self.seg = np.zeros((n, CLIP_TEXT), np.int32)
        for i in range(n):
            words = np.minimum(rng.zipf(1.1, int(rng.integers(3, 76))),
                               vocab - 5) + 4
            ids = np.concatenate([[0], words, [2]])
            self.src[i, :len(ids)], self.seg[i, :len(ids)] = ids, 1
        self.pixels = rng.random((n, 3, 224, 224), dtype=np.float32)

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.src)

    def get(self, i: int) -> dict:
        return {"src_text": self.src[i], "seg_text": self.seg[i],
                "src_image": self.pixels[i],
                "seg_image": np.ones(CLIP_IMAGE, np.int32),
                "tgt": np.int32(i)}


def clip_path(seed: int, dev, card_line: str) -> dict:
    """Phase 19, leg (d): CLIP ViT-B/16 contrastive pretraining through the
    PretrainTrainer and make_pretrain_step(form="clip") that cli.pretrain
    builds, on one global batch of 2 x 64 seeded pairs (ClipPairs), CLIP_STEPS
    steps at CLIP's learning rate: the parameter count beside OpenAI's, a
    loss that starts near ln 64 and falls, moved leaves in both towers, the
    projections and logit_scale."""
    from lr2ppo_torch.config import Config
    from lr2ppo_torch.data.pipeline import Loader

    tower_cfg = TowerConfig.from_dict(CLIP_VIT_B16)
    cfg = Config().replace(seed=seed, report_steps=1, output_model_path="",
                           log_path=None)
    cfg.optim.learning_rate = CLIP_LR
    trainer = PretrainTrainer(cfg, tower_cfg, CLIP_ACCUM, device=dev,
                              form="clip")
    rows = CLIP_MICRO * CLIP_ACCUM
    loader = Loader(ClipPairs(rows, seed, tower_cfg.vocab_size), rows,
                    shuffle=True, seed=seed, reuse_buffers=True,
                    shard_chunks=CLIP_ACCUM)
    losses = []
    log = trainer.metrics.log

    def keep(step, **kw):
        losses.append(kw["loss"])
        log(step, **kw)

    trainer.metrics.log = keep
    hash_dropout.launches = 0
    reset_launches()
    with watched_init(CLIP_WATCHED) as seen:
        state, _ = trainer.fit(loader, CLIP_STEPS)
    torch.cuda.synchronize()
    params = dict(state.model.named_parameters())
    counts = {part: sum(p.numel() for k, p in params.items()
                        if k.startswith(part))
              for part in ("embedding_0.", "encoder.encoder_0.",
                           "embedding_1.", "encoder.encoder_1.",
                           "target.clr.")}
    n_params = sum(p.numel() for p in params.values())
    move = {k: float((params[k].detach().cpu() - v).abs().max())
            for k, v in seen[0].items()}
    if not (len(losses) == CLIP_STEPS and np.isfinite(losses).all()
            and abs(losses[0] - math.log(CLIP_MICRO)) < CLIP_START_BAND
            and losses[-1] < losses[0]
            and all(v > 0 for v in move.values())
            and hash_dropout.launches == 0
            and fused_attention.launches == 0):
        raise AssertionError(
            f"clip: losses {losses}, moved {move}, "
            f"{hash_dropout.launches} hash dropout and "
            f"{fused_attention.launches} K4 launches")
    emit(phase="clip", form="clip", params=n_params,
         params_by_part=counts, openai_params=OPENAI_CLIP_B16_PARAMS,
         params_minus_openai=n_params - OPENAI_CLIP_B16_PARAMS,
         micro_batch=CLIP_MICRO, accumulation=CLIP_ACCUM, steps=CLIP_STEPS,
         losses=losses, ln_micro_batch=math.log(CLIP_MICRO), moved=move,
         card=card_line)
    del trainer, state, params
    torch.cuda.empty_cache()


def encoders_path(args, dev, card_line: str) -> dict:
    """Phase 19: the large LSTM LM, bilm on bilstm, the rest of the zoo,
    and CLIP ViT-B/16. Returns the LSTM sites' runs and hash dropout's
    launches."""
    out = lstm_path(args.seed + 90, dev, card_line)
    clip_path(args.seed + 91, dev, card_line)
    return out


# -- phase 20: image and speech pretraining ------------------------------------
# BEiT-base (Bao et al. 2022, microsoft/beit-base-patch16-224-pt22k): ViT-B/16,
# 12 layers of 768, 12 heads, FFN 3,072, 224 x 224 in patches of 16 (197
# tokens), pre-LN, no embedding norm; the masked-patch embedding and the
# learned positions; an mlm head over the VQGAN's 1,024 codes, which stand in
# for BEiT's 8,192-entry dVAE
BEIT_BASE = {
    "emb_size": 768, "hidden_size": 768, "feedforward_size": 3072,
    "heads_num": 12, "layers_num": 12, "max_seq_length": 197,
    "embedding": ["masked_patch", "pos"], "remove_embedding_layernorm": True,
    "encoder": "transformer", "mask": "fully_visible",
    "layernorm_positioning": "pre", "target": ["mlm"], "hidden_act": "gelu",
    "dropout": 0.1, "image_height": 224, "image_width": 224,
    "patch_size": 16, "channels_num": 3,
}
# BEiT-B's published size (Bao et al. 2022, Table 1: 86 M), the encoder's
BEIT_PUBLISHED_PARAMS = 86e6
# ViLT-B/32 (Kim et al. 2021, dandelin/vilt-b32-mlm): ViT-B/32 at 384 x 384
# (144 patches + [CLS] = 145 image tokens), text of at most 40 tokens, a
# BERT-sized 30,522-entry vocabulary, pre-LN; word_patch + pos + seg (seg 1
# on the text, 2 on the image), the mlm and match (sp) targets
VILT_B32 = {
    "emb_size": 768, "hidden_size": 768, "feedforward_size": 3072,
    "heads_num": 12, "layers_num": 12, "max_seq_length": 185,
    "embedding": ["word_patch", "pos", "seg"], "encoder": "transformer",
    "mask": "fully_visible", "layernorm_positioning": "pre",
    "target": ["mlm", "sp"], "hidden_act": "gelu", "dropout": 0.1,
    "image_height": 384, "image_width": 384, "patch_size": 32,
    "channels_num": 3,
}
VILT_VOCAB, VILT_TEXT = 30522, 40
# S2T-small (fairseq s2t_transformer_s, Wang et al. 2020,
# facebook/s2t-small-librispeech-asr): 12 encoder and 6 decoder layers of
# 256, 4 heads, FFN 2,048, ReLU, dropout 0.1, pre-LN, no embedding norm, 2
# stride-2 convolutions of width 5 over 80 mel bins, sinusoidal positions
# on both sides, a 10,000-entry vocabulary
S2T_SMALL = {
    "emb_size": 256, "hidden_size": 256, "feedforward_size": 2048,
    "heads_num": 4, "layers_num": 12, "decoder_layers_num": 6,
    "max_seq_length": 1024, "hidden_act": "relu", "dropout": 0.1,
    "embedding": ["speech", "sinusoidalpos"],
    "tgt_embedding": ["word", "sinusoidalpos"],
    "remove_embedding_layernorm": True, "encoder": "transformer",
    "mask": "fully_visible", "decoder": "transformer", "target": ["lm"],
    "layernorm_positioning": "pre",
}
S2T_VOCAB, S2T_TGT = 10000, 128
# fairseq's 6,000 cut to the longest utterance here (16 s at a 10 ms shift),
# a multiple of 4 (the two stride-2 convolutions)
S2T_FRAMES = 1600
S2T_SECONDS, S2T_UTTERANCES = (12.0, 16.0), 32
S2T_BS = 16
# every leg: micro-batches of P20_BS (S2T: S2T_BS), P20_ACCUM of them a step
P20_BS, P20_ACCUM, P20_STEPS, P20_SHORT_STEPS = 32, 2, 4, 2
# the learning rates: BEiT's, vit's and dalle's below BEiT's published
# 1.5e-3; ViLT's published 1e-4 (at 5e-4 its loss rose at the fourth
# step); S2T's below fairseq's LibriSpeech recipe's 2e-3
P20_LR, VILT_LR, S2T_LR = 5e-4, 1e-4, 1e-3
# the vit leg's classes (ImageNet-1k's) and the dalle leg's text
VIT_CLASSES, DALLE_TEXT = 1000, 32
# a 12 x 768 causal tower over 32 text and 256 VQGAN tokens (256 x 256): a
# reduced width, no published DALL-E has this size
DALLE_SMALL = {
    "emb_size": 768, "hidden_size": 768, "feedforward_size": 3072,
    "heads_num": 12, "layers_num": 12, "max_seq_length": 288,
    "embedding": ["word", "pos", "seg"], "encoder": "transformer",
    "mask": "causal", "layernorm_positioning": "pre", "target": ["lm"],
    "hidden_act": "gelu", "dropout": 0.1,
}
BEIT_WATCHED = ("embedding.masked_patch.mask_emb",
                "embedding.masked_patch.patch.projection.weight",
                "encoder.transformer.11.feed_forward.linear_2.weight",
                "target.mlm.linear_2.weight")
VILT_WATCHED = ("embedding.word_patch.word.embedding.weight",
                "embedding.word_patch.patch.projection.weight",
                "encoder.transformer.0.self_attn.linear_layers.0.weight",
                "target.sp.linear_2.weight")
S2T_WATCHED = ("embedding.speech.conv_0.weight",
               "embedding.speech.conv_1.weight",
               "decoder.transformer_decoder.5.context_attn.linear_layers.1."
               "weight", "target.lm.output_layer.weight")
# the VQGAN's quant_conv output on the card against the CPU's from the same
# weights, float32 with TF32 off: within VQ_Z_RTOL of the largest |z| (~30
# convolutions and group norms summed in other orders)
VQ_Z_RTOL = 1e-3
VQ_IMAGES, VQ_SIZE = 8, 224
VQ_CONFIG: dict = {}                   # VQGANConfig()'s: imagenet f16-1024


def seeded_pixels(path: str, h: int, w: int, seed: int) -> np.ndarray:
    """The synthetic image 'img<k>' of a phase-20 manifest: uniform pixels
    in [0, 1), channels first, from (seed, k)."""
    rng = np.random.default_rng((seed, int(path[3:])))
    return rng.random((3, h, w), dtype=np.float32)


def seeded_dataset(cls, seed: int):
    """`cls` (one of the port's image datasets) with only `_pixels`
    overridden: the manifest's paths name seeded arrays (the card's machine
    has no PIL). Dalle reads at its tokenizer's resolution."""

    class Seeded(cls):
        def _pixels(self, path):
            if hasattr(self, "h"):
                return seeded_pixels(path, self.h, self.w, seed)
            r = self.image_tok.cfg.resolution
            return seeded_pixels(path, r, r, seed)

    Seeded.__name__ = Seeded.__qualname__ = f"Seeded{cls.__name__}"
    return Seeded


@contextmanager
def seeded_images(seed: int):
    """cli.pretrain builds its image datasets as seeded_dataset's inside the
    block."""
    names = ("VitImageDataset", "ViltPairsDataset", "BeitImageDataset",
             "DalleDataset")
    real = {n: getattr(pretrain, n) for n in names}
    for n, cls in real.items():
        setattr(pretrain, n, seeded_dataset(cls, seed))
    try:
        yield
    finally:
        for n, cls in real.items():
            setattr(pretrain, n, cls)


def zipf_text(rng, vocab: int, lo: int, hi: int) -> str:
    """lo to hi Zipf-distributed words of a pretrain_corpus vocabulary."""
    n_words = vocab - len(PRE_SPECIALS)
    ranks = rng.zipf(1.1, size=int(rng.integers(lo, hi + 1)))
    return " ".join(f"w{min(r, n_words) - 1}" for r in ranks)


def p20_argv(paths: dict, out: str, processor: str, steps: int, bs: int,
             *extra) -> list:
    return ["--corpus_path", paths["corpus"], "--tower_config",
            paths["tower"], "--data_processor", processor, "--tokenizer",
            "space", "--vocab_path", paths["vocab"], "--hash_dropout",
            "--batch_size", str(bs), "--accumulation_steps", str(P20_ACCUM),
            "--total_steps", str(steps), "--learning_rate", str(P20_LR),
            "--report_steps", "1", "--output_model_path", out, "--log_path",
            out + ".log", *extra]


def p20_sites_a_pass(cfg) -> int:
    """Hash-dropout sites of one training pass: the embedding and 3 a layer
    in the encoder; with a decoder, its embedding and 5 a layer."""
    if cfg.decoder:
        return s2s_sites_a_pass(cfg)
    return 1 + 3 * cfg.layers_num


def p20_fit(name: str, argv: list, dev, seed: int, watched=()) -> dict:
    """cli.pretrain's build and fit (image datasets seeded): the records,
    the launches against the sites counted from the config, the parameter
    count by part and the moved leaves; finite losses and moved leaves
    held."""
    with seeded_images(seed):
        trainer, loader = pretrain.build(pretrain.parser().parse_args(argv),
                                         dev)
    steps = int(argv[argv.index("--total_steps") + 1])
    cfg = trainer.tower_cfg
    want = p20_sites_a_pass(cfg) * 2 * P20_ACCUM * steps
    hash_dropout.launches = 0
    reset_launches()
    with watched_init(watched) as seen:
        state, best = trainer.fit(loader, steps)
    torch.cuda.synchronize()
    launches, k4 = hash_dropout.launches, fused_attention.launches
    out = argv[argv.index("--output_model_path") + 1]
    with open(out + ".log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    params = dict(state.model.named_parameters())
    move = {k: float((params[k].detach().cpu() - v).abs().max())
            for k, v in (seen[0].items() if seen else ())}
    losses = [r["loss"] for r in recs]
    if not (len(recs) == steps and np.isfinite(losses).all()
            and launches == want and k4 == 0
            and all(v > 0 for v in move.values())):
        raise AssertionError(
            f"{name}: losses {losses}, moved {move}, {launches} hash "
            f"dropout launches (want {want}), {k4} K4 launches")
    parts = ("embedding.", "encoder.", "tgt_embedding.", "decoder.",
             "target.")
    return {"trainer": trainer, "loader": loader, "state": state,
            "best": best, "losses": losses, "accs": [r["acc"] for r in recs],
            "launches": launches, "want": want, "moved": move,
            "params": sum(p.numel() for p in params.values()),
            "params_by_part": {p: sum(v.numel() for k, v in params.items()
                                      if k.startswith(p)) for p in parts}}


def p20_batch(run: dict) -> dict:
    """The loader's first batch, on the card."""
    return run["trainer"].ctx.put({k: v for k, v in next(iter(run["loader"]))
                                   .items() if not k.startswith("_")})


def p20_sites(run: dict, form: str, indices: dict, seed: int, dev,
              card_line: str, want_shapes: dict) -> dict:
    """The hash-dropout sites `indices` ({name: site index in a pass's
    order}) of one training forward on the first micro-batch, each held
    against the plain version on its own input and seed."""
    batch = run["batch"]
    micro = {k: v[:v.shape[0] // P20_ACCUM] for k, v in batch.items()}
    sites = {}
    for name, index in indices.items():
        x, site_seed = site_input(run["state"].model, micro, index, seed,
                                  form=form)
        sites[name] = check_dropout("hash_dropout", tuple(x.shape),
                                    torch.float32, site_seed, dev, False,
                                    card_line, x=x)
        sites[name]["site_seed"] = site_seed
        del x
    got = {k: v["shape"] for k, v in sites.items()}
    if got != {k: list(v) for k, v in want_shapes.items()}:
        raise AssertionError(f"{form}: sites {got}, want {want_shapes}")
    return sites


def p20_emit(phase: str, run: dict, card_line: str, **extra) -> None:
    emit(phase=phase, params=run["params"],
         params_by_part=run["params_by_part"],
         vocab=run["trainer"].tower_cfg.vocab_size,
         form=run["trainer"].form, losses=run["losses"], accs=run["accs"],
         moved=run["moved"],
         hash_dropout_launches=run["launches"],
         hash_dropout_launches_expected=run["want"],
         hash_dropout_sites_a_pass=p20_sites_a_pass(run["trainer"]
                                                    .tower_cfg),
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         card=card_line, **extra)


def vqgan_leg(seed: int, dev, card_line: str) -> None:
    """The VQGAN at the published imagenet f16-1024 widths, seeded: 8
    images at 224 x 224 encoded on the card and on the CPU from the same
    weights; quant_conv's output within VQ_Z_RTOL, the tokens equal wherever
    the CPU's margin between its two nearest codes exceeds twice the
    largest gap between the two sides' distances."""
    from lr2ppo_torch.towers.vqgan import (VQGANConfig, VQGANEncoder,
                                           init_vqgan)

    cfg = VQGANConfig(**VQ_CONFIG)
    cpu = VQGANEncoder(cfg)
    init_vqgan(cpu, torch.Generator().manual_seed(seed))
    card_model = VQGANEncoder(cfg, device=dev)
    card_model.load_state_dict(cpu.state_dict(), strict=True)
    px = torch.from_numpy(np.random.default_rng(seed).random(
        (VQ_IMAGES, 3, VQ_SIZE, VQ_SIZE), dtype=np.float32))
    with torch.inference_mode():
        z_cpu = cpu.features(px)
        idx_cpu, _ = cpu.quantize_features(z_cpu)
        z_card = card_model.features(px.to(dev))
        idx_card = card_model.quantize_features(z_card)[0].cpu()
        z_card = z_card.cpu()
    z_gap = float((z_card - z_cpu).abs().max())
    z_max = float(z_cpu.abs().max())
    e = cpu.quantize.embedding.weight.detach().double()

    def dist(z):
        z = z.double()
        return (z.pow(2).sum(-1, keepdim=True) - 2 * z @ e.t()
                + e.pow(2).sum(-1))

    d_cpu, d_card = dist(z_cpu), dist(z_card)
    d_gap = float((d_cpu - d_card).abs().max())
    two = d_cpu.topk(2, dim=-1, largest=False).values
    decided = (two[..., 1] - two[..., 0]) > 2 * d_gap
    equal = idx_card == idx_cpu
    grid = (VQ_SIZE // 2 ** (len(cfg.ch_mult) - 1)) ** 2
    res = {"images": VQ_IMAGES, "size": VQ_SIZE,
           "tokens_per_image": int(idx_cpu.shape[1]),
           "z_max_abs_err": z_gap, "z_max_abs": z_max,
           "z_rtol": VQ_Z_RTOL, "distance_max_abs_err": d_gap,
           "decided_share": float(decided.float().mean()),
           "equal_share": float(equal.float().mean()),
           "equal_where_decided": bool(equal[decided].all()),
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    if not (z_gap <= VQ_Z_RTOL * z_max and res["equal_where_decided"]
            and idx_cpu.shape == (VQ_IMAGES, grid)):
        emit(phase="vqgan", failed=True, **res)
        raise AssertionError(f"vqgan: the card against the CPU: {res}")
    res["card"] = card_line
    emit(phase="vqgan", config="imagenet f16-1024 (VQGANConfig()), seeded "
         "weights", **res)
    del cpu, card_model, z_cpu, z_card, px
    torch.cuda.empty_cache()


def beit_leg(seed: int, dev, card_line: str) -> dict:
    """BEiT-base through cli.pretrain at --data_processor beit
    --hash_dropout: 2 micro-batches of 32 seeded images a step, P20_STEPS
    steps; then the -best checkpoint loaded strict and one encode of 32
    images through the extraction path (K4, 12 launches)."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, seed, VILT_VOCAB, BEIT_BASE)
        paths["corpus"] = os.path.join(tmp, "beit.tsv")
        with open(paths["corpus"], "w") as f:
            f.write("".join(f"img{k}\n" for k in range(P20_BS * P20_ACCUM)))
        out = os.path.join(tmp, "beit")
        run = p20_fit("beit", p20_argv(paths, out, "beit", P20_STEPS,
                                       P20_BS), dev, seed, BEIT_WATCHED)
        if not (run["trainer"].tower_cfg.vocab_size == 1024
                and run["losses"][-1] < run["losses"][0]
                and "embedding.masked_patch.mask_emb" in run["moved"]):
            raise AssertionError(f"beit: vocabulary "
                                 f"{run['trainer'].tower_cfg.vocab_size}, "
                                 f"losses {run['losses']}")
        run["batch"] = p20_batch(run)
        ds = run["loader"].ds
        cfg = dataclasses.replace(run["trainer"].tower_cfg,
                                  pallas_attention=True)
        seq, hid = ds.seq, cfg.hidden_size
        sites = p20_sites(run, "beit", {"embedding": 0, "probs": 1}, seed,
                          dev, card_line,
                          {"embedding": (P20_BS, seq, hid),
                           "probs": (P20_BS, cfg.heads_num, seq, seq)})
        state = encoder_state(load_tower_checkpoint(out + "-best"))
        extractor = ImageFeatureExtractor(cfg, state, device=dev)
        pixels = np.stack([ds._pixels(f"img{k}") for k in range(P20_BS)])
        reset_launches()
        feats = extractor(pixels, P20_BS)
        torch.cuda.synchronize()
        k4 = fused_attention.launches
        if not (k4 == cfg.layers_num and feats.shape == (P20_BS, hid)
                and np.isfinite(feats).all()):
            raise AssertionError(f"beit: the -best encode launched K4 {k4} "
                                 f"times, features {feats.shape}")
        del extractor, state
    p20_emit("beit", run, card_line, processor="beit",
             published_params=BEIT_PUBLISHED_PARAMS,
             encoder_params=run["params_by_part"]["embedding."]
             + run["params_by_part"]["encoder."],
             micro_batch=[P20_BS, seq], accumulation=P20_ACCUM,
             steps=P20_STEPS, masked_patches=ds.n_mask, best_k4_launches=k4,
             sites={k: {"shape": v["shape"], "bit_equal":
                        v["forward_bit_equal"] and v["backward_bit_equal"]}
                    for k, v in sites.items()})
    launches = run["launches"]
    del run, ds
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites, "k4": k4}


def vilt_leg(seed: int, dev, card_line: str) -> dict:
    """ViLT-B/32 through cli.pretrain at --data_processor vilt
    --hash_dropout: 2 micro-batches of 32 seeded (caption, image) pairs a
    step, P20_STEPS steps; the match targets' share."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, seed, VILT_VOCAB, VILT_B32)
        rng = np.random.default_rng(seed)
        paths["corpus"] = os.path.join(tmp, "vilt.tsv")
        with open(paths["corpus"], "w") as f:
            f.write("".join(f"{zipf_text(rng, VILT_VOCAB, 5, 38)}\timg{k}\n"
                            for k in range(P20_BS * P20_ACCUM)))
        out = os.path.join(tmp, "vilt")
        run = p20_fit("vilt", p20_argv(paths, out, "vilt", P20_STEPS,
                                       P20_BS, "--seq_length",
                                       str(VILT_TEXT), "--learning_rate",
                                       str(VILT_LR)),
                      dev, seed, VILT_WATCHED)
        if run["losses"][-1] >= run["losses"][0]:
            raise AssertionError(f"vilt: losses {run['losses']}")
        batch = p20_batch(run)
        ds = run["loader"].ds
        if not (batch["src_text"].shape == (P20_BS * P20_ACCUM, VILT_TEXT)
                and batch["seg"].shape[1] == VILT_TEXT + ds.img_seq):
            raise AssertionError(f"vilt: batch {batch['src_text'].shape}, "
                                 f"seg {batch['seg'].shape}")
        img_seq = ds.img_seq
        ds.set_epoch(1)
        match_share = float(np.mean([ds.get(i)["tgt_match"]
                                     for i in range(len(ds))]))
        del batch, ds
    p20_emit("vilt", run, card_line, processor="vilt",
             micro_batch=[P20_BS, VILT_TEXT, img_seq],
             accumulation=P20_ACCUM, steps=P20_STEPS,
             match_share_epoch_1=match_share)
    launches = run["launches"]
    del run
    torch.cuda.empty_cache()
    return {"launches": launches}


def speech_files(tmp: str, seed: int, paths: dict) -> None:
    """S2T_UTTERANCES seeded 16-bit wavs of 12-16 s at 16 kHz (a tone with
    harmonics and noise) and their transcripts (20-126 Zipf words), as
    paths['corpus'], a tsv of 'transcript<TAB>wav path'."""
    import wave

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(S2T_UTTERANCES):
        n = int(16000 * rng.uniform(*S2T_SECONDS))
        t = np.arange(n) / 16000
        f0 = rng.uniform(90, 250)
        x = sum(0.3 / h * np.sin(2 * np.pi * f0 * h * t) for h in (1, 2, 3))
        x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
            + 0.02 * rng.standard_normal(n)
        path = os.path.join(tmp, f"u{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16)
                          .tobytes())
        rows.append(f"{zipf_text(rng, S2T_VOCAB, 20, 126)}\t{path}\n")
    paths["corpus"] = os.path.join(tmp, "s2t.tsv")
    with open(paths["corpus"], "w") as f:
        f.write("".join(rows))


def s2t_leg(seed: int, dev, card_line: str) -> dict:
    """S2T-small through cli.pretrain at --data_processor s2t --hash_dropout
    on S2T_UTTERANCES seeded wavs read by S2tDataset (read_wav, the log-mel
    filterbank, CMVN): 2 micro-batches of 16 a step, --max_audio_frames
    1600, targets of up to 128 tokens, P20_STEPS steps; its encoder's
    embedding site (16, 400, 256) against the plain hash dropout."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = pretrain_corpus(tmp, seed, S2T_VOCAB, S2T_SMALL)
        speech_files(tmp, seed, paths)
        out = os.path.join(tmp, "s2t")
        run = p20_fit("s2t", p20_argv(
            paths, out, "s2t", P20_STEPS, S2T_BS, "--max_audio_frames",
            str(S2T_FRAMES), "--tgt_seq_length", str(S2T_TGT),
            "--learning_rate", str(S2T_LR)), dev, seed,
            S2T_WATCHED)
        ds = run["loader"].ds
        frames = [int(ds.get(i)["seg"].sum()) for i in range(len(ds))]
        if not (len(ds) == S2T_UTTERANCES
                and run["losses"][-1] < run["losses"][0]):
            raise AssertionError(f"s2t: {len(ds)} utterances, losses "
                                 f"{run['losses']}")
        run["batch"] = p20_batch(run)
        sites = p20_sites(run, "seq2seq", {"encoder_embedding": 0}, seed,
                          dev, card_line,
                          {"encoder_embedding": (
                              S2T_BS, S2T_FRAMES // 4,
                              run["trainer"].tower_cfg.hidden_size)})
        tgt_tokens = int(run["batch"]["tgt_seg"].sum())
        del ds
    p20_emit("s2t", run, card_line, processor="s2t",
             micro_batch=[S2T_BS, S2T_FRAMES, S2T_TGT],
             accumulation=P20_ACCUM, steps=P20_STEPS,
             subsampled_frames_by_utterance=frames,
             target_tokens_a_step=tgt_tokens,
             sites={k: {"shape": v["shape"], "bit_equal":
                        v["forward_bit_equal"] and v["backward_bit_equal"]}
                    for k, v in sites.items()})
    launches = run["launches"]
    del run
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites}


def vit_dalle_legs(seed: int, dev, card_line: str) -> dict:
    """vit (ViT-B/16, a 1,000-class cls target) and dalle (DALLE_SMALL over
    32 text and 256 VQGAN tokens at 256 x 256) through cli.pretrain,
    P20_SHORT_STEPS steps each: finite losses and moved leaves."""
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(seed)
        vit = {**VIT_B16, "labels_num": VIT_CLASSES}
        paths = pretrain_corpus(tmp, seed, VILT_VOCAB, vit)
        paths["corpus"] = os.path.join(tmp, "vit.tsv")
        with open(paths["corpus"], "w") as f:
            f.write("".join(f"{int(rng.integers(VIT_CLASSES))}\timg{k}\n"
                            for k in range(P20_BS * P20_ACCUM)))
        run = p20_fit("vit", p20_argv(paths, os.path.join(tmp, "vit"),
                                      "vit", P20_SHORT_STEPS, P20_BS), dev,
                      seed, ("embedding.patch.projection.weight",
                             "target.cls.linear_2.weight"))
        launches += run["launches"]
        emit(phase="vit", processor="vit", params=run["params"],
             classes=VIT_CLASSES, steps=P20_SHORT_STEPS,
             losses=run["losses"], moved=run["moved"],
             hash_dropout_launches=run["launches"],
             hash_dropout_launches_expected=run["want"], card=card_line)
        del run
        torch.cuda.empty_cache()
        with open(paths["tower"], "w") as f:
            json.dump(DALLE_SMALL, f)
        paths["corpus"] = os.path.join(tmp, "dalle.tsv")
        with open(paths["corpus"], "w") as f:
            f.write("".join(f"{zipf_text(rng, VILT_VOCAB, 5, 29)}\timg{k}\n"
                            for k in range(P20_BS * P20_ACCUM)))
        run = p20_fit("dalle", p20_argv(
            paths, os.path.join(tmp, "dalle"), "dalle", P20_SHORT_STEPS,
            P20_BS, "--seq_length", str(DALLE_TEXT)), dev, seed,
            ("embedding.word.embedding.weight",
             "target.lm.output_layer.weight"))
        launches += run["launches"]
        batch = next(iter(run["loader"]))
        n_img = run["loader"].ds.n_img
        if not (run["trainer"].tower_cfg.vocab_size == VILT_VOCAB + 1024
                and batch["src"].shape[1] == DALLE_TEXT + n_img
                and int(batch["src"].max()) >= VILT_VOCAB):
            raise AssertionError(f"dalle: vocabulary "
                                 f"{run['trainer'].tower_cfg.vocab_size}, "
                                 f"batch {batch['src'].shape}")
        emit(phase="dalle", processor="dalle", params=run["params"],
             width="reduced: a 12 x 768 causal tower; no published DALL-E "
             "has this size", vocab=run["trainer"].tower_cfg.vocab_size,
             sequence=[DALLE_TEXT, n_img], steps=P20_SHORT_STEPS,
             losses=run["losses"], moved=run["moved"],
             hash_dropout_launches=run["launches"],
             hash_dropout_launches_expected=run["want"], card=card_line)
        del run, batch
    torch.cuda.empty_cache()
    return {"launches": launches}


def vision_speech_path(args, dev, card_line: str) -> dict:
    """Phase 20: the VQGAN card against CPU; BEiT-base, ViLT-B/32 and
    S2T-small at full width; vit and dalle. Returns hash dropout's
    launches, the sites' runs and K4's launches in the BEiT encode."""
    vqgan_leg(args.seed + 100, dev, card_line)
    beit = beit_leg(args.seed + 101, dev, card_line)
    vilt = vilt_leg(args.seed + 102, dev, card_line)
    s2t = s2t_leg(args.seed + 103, dev, card_line)
    rest = vit_dalle_legs(args.seed + 104, dev, card_line)
    return {"launches": beit["launches"] + vilt["launches"]
            + s2t["launches"] + rest["launches"],
            "sites": {**beit["sites"], **s2t["sites"]}, "k4": beit["k4"]}


# -- phase 21: the checkpoint backends ---------------------------------------
P21_CUT = 2                  # phase 7's batches before the cut: one sweep


class Cut(Exception):
    pass


class CutAfter(BatchList):
    """The batches of a loader, raising Cut when asked for batch n + 1: a
    run killed between two rollouts. Its length is the whole loader's, so
    the run's schedule is the uninterrupted run's."""

    def __init__(self, batches, n: int):
        super().__init__(batches)
        self.n = n

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if i == self.n:
                raise Cut
            yield batch


def disk_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def remove(path: str) -> None:
    import shutil

    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def payload_sums(payload: dict, dev) -> dict:
    """checksum of every tensor of a `.state` payload's models and moments,
    keyed as state_sums keys them."""
    out = {}
    for side in ("actor", "critic"):
        for k, v in payload["models"][side].items():
            out[f"{side}.{k}"] = checksum(v.to(dev))
        for table in ("mu", "nu"):
            for k, v in payload["optims"][side][table].items():
                out[f"{side}.{table}.{k}"] = checksum(v.to(dev))
    return out


def backends_leg(p7: dict, seed: int, dev, card_line: str) -> dict:
    """Phase 21 (a): phase 7's trained states written with each backend and
    read back, the pickle payload held by checksum to the states as they
    were at its save and the others bit-equal to it. While the async write
    is in flight, phase 7's update runs on the live states: it must not
    reach the directory."""
    astate, cstate = p7["states"]
    ctx = p7["trainer"].ctx
    want = state_sums(astate, cstate)
    gen = torch.Generator().manual_seed(seed)
    out, first = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for backend in checkpoints.BACKENDS:
            path = os.path.join(tmp, f"{backend}.state")
            save_train_state(path, {"actor": astate, "critic": cstate}, gen,
                             astate.step, p7["best"], ctx, backend,
                             time_ctr=0)
            res = {}
            if backend == "orbax_async":
                for _ in range(3):
                    p7["one_update"]()
                torch.cuda.synchronize()
                writer = checkpoints._SAVES.thread
                res["write_in_flight_after_updates"] = bool(
                    writer is not None and writer.is_alive())
            checkpoints.wait_for_async_saves()
            res["disk_bytes"] = disk_bytes(path)
            payload = checkpoints.load_state(path)
            if first is None:
                first = payload
                res["held"] = payload_sums(payload, dev) == want
            else:
                res["held"] = same_payload(payload, first)
            del payload
            remove(path)
            out[backend] = res
            emit(phase="checkpoints", leg="backends", backend=backend,
                 card=card_line, **res)
            if not res["held"]:
                raise AssertionError(f"phase 21 {backend}: the payload read "
                                     "back is not the states it saved")
    return out


def same_payload(a: dict, b: dict) -> bool:
    """Two `.state` payloads with the same keys, values and tensor bits."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_payload(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    return a == b


def p21_rank(rank, world, url, backend, job, queue) -> None:
    """Phase 21 (b), in a process of its own with phase 15's deterministic
    algorithms: phase 7's fit with orbax_async and --save_state_steps 1,
    cut after its first sweep and resumed from the directory."""
    import traceback

    seed = job
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        require_cuda()
        res = {"card": card()}
        with tempfile.TemporaryDirectory() as tmp:
            batches = SyntheticTrainLoader(
                train_config(tmp, seed).model, seed + 3).batches

            def fit(loader, **kw):
                cfg = train_config(tmp, seed).replace(**kw)
                evb, _ = synthetic_batches(2, cfg.model, seed + 4, items=8,
                                           bucket=8, tags=(2, 8))
                astate, cstate, best = PPOTrainer(cfg, dev).fit(
                    lambda epoch: loader, evb)
                torch.cuda.synchronize()
                return astate, cstate

            state = os.path.join(tmp, "cut.bin.state")
            try:
                fit(CutAfter(batches, P21_CUT), ckpt_backend="orbax_async",
                    save_state_steps=1,
                    output_model_path=os.path.join(tmp, "cut.bin"))
                raise AssertionError("the cut run was not cut")
            except Cut:
                pass
            checkpoints.wait_for_async_saves()
            res["cut_state_bytes"] = disk_bytes(state)
            # rank 0's plain values, its tensors left on disk (mmap)
            values = torch.load(checkpoints.rank_files(state)[0], mmap=True,
                                weights_only=True)["values"]
            res["cut_time_ctr"] = int(dict((tuple(k), v)
                                           for k, v in values)[("time_ctr",)])
            # the resumed run writes no checkpoint
            astate, cstate = fit(BatchList(batches), resume_path=state,
                                 output_model_path="")
            res["resumed_sums"] = state_sums(astate, cstate)
            remove(state)
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def resume_leg(p7: dict, seed: int, card_line: str) -> dict:
    """Phase 21 (b): the cut-and-resumed fit against phase 7's fit of the
    same seed and batches, bit for bit."""
    r = spawn_leg("phase 21 resume", 1, "none", seed, p21_rank,
                  timeout=900)[0]
    got, want = r.pop("resumed_sums"), p7["fit_sums"]
    held = got == want
    emit(phase="checkpoints", leg="resume", held=held, tensors=len(want),
         **r)
    if not held or r["cut_time_ctr"] != P21_CUT:
        bad = sorted(k for k in want if got.get(k) != want[k])[:5]
        raise AssertionError(f"phase 21 resume: cut after "
                             f"{r['cut_time_ctr']} rollouts; the resumed "
                             f"fit differs from phase 7's at {bad}")
    return r


def shards_leg(ctx, astate, cstate, best, sums: dict, where: str,
               dev) -> dict:
    """Phase 21 (c), in a rank of phase 15's shared-card legs: the trained
    state written with orbax (this rank's part, no gather) and with pickle
    (every rank gathers, rank 0 writes); rank 0 reads
    both back and holds the sharded models to `sums` (checksums of
    full_state_dict) and its moments and counts to the gathered ones."""
    import torch.distributed as dist

    m = ctx.mesh
    gen = torch.Generator().manual_seed(0)
    res = {"rank": m.rank}
    paths = {b: os.path.join(where, f"dp{m.dp}_tp{m.tp}_{b}.state")
             for b in ("orbax", "pickle")}
    for backend, path in paths.items():
        dist.barrier()
        save_train_state(path, {"actor": astate, "critic": cstate}, gen,
                         astate.step, best, ctx, backend, time_ctr=0)
    dist.barrier()
    res["rank_file_bytes"] = os.path.getsize(
        checkpoints.rank_files(paths["orbax"])[m.rank])
    if m.is_main:
        res["pickle_bytes"] = os.path.getsize(paths["pickle"])
        sharded = checkpoints.load_state(paths["orbax"])
        gathered = torch.load(paths["pickle"], map_location="cpu",
                              mmap=True, weights_only=True)
        bad, n = [], 0
        for side in ("actor", "critic"):
            for k, v in sharded["models"][side].items():
                n += 1
                if checksum(v.to(dev)) != sums[f"{side}.{k}"]:
                    bad.append(f"{side}.{k}")
            for table in ("mu", "nu"):
                want = gathered["optims"][side][table]
                got = sharded["optims"][side][table]
                n += len(want)
                bad += [f"{side}.{table}.{k}" for k, v in want.items()
                        if k not in got or not torch.equal(got[k], v)]
            if (sharded["optims"][side]["count"]
                    != gathered["optims"][side]["count"]):
                bad.append(f"{side}.count")
        res.update(tensors=n, held=not bad, differ=bad[:5])
        del sharded, gathered
    dist.barrier()
    if m.is_main:
        for path in paths.values():
            remove(path)
    return res


def checkpoints_path(args, dev, card_line: str, p7: dict) -> dict:
    """Phase 21 (a) and (b); (c) runs in phase 15's shared-card legs."""
    out = {"backends": backends_leg(p7, args.seed, dev, card_line)}
    torch.cuda.empty_cache()
    out["resume"] = resume_leg(p7, args.seed, card_line)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline_only", action="store_true",
                    help="build and run phase 16 alone on one card")
    ap.add_argument("--processors_only", action="store_true",
                    help="build and run phase 17 alone on one card")
    ap.add_argument("--seq2seq_only", action="store_true",
                    help="build and run phase 18 alone on one card")
    ap.add_argument("--encoders_only", action="store_true",
                    help="build and run phase 19 alone on one card")
    ap.add_argument("--vision_speech_only", action="store_true",
                    help="build and run phase 20 alone on one card")
    ap.add_argument("--adamw_only", action="store_true",
                    help="build and run phase 22 alone on one card")
    ap.add_argument("--mla_only", action="store_true",
                    help="build and run phase 23 alone on one card")
    ap.add_argument("--checkpoints_only", action="store_true",
                    help="build and run phase 7, phase 21 and phase 15 "
                         "(whose shared-card legs hold phase 21 (c)) alone "
                         "on one card")
    ap.add_argument("--parallel_only", action="store_true",
                    help="build and run phase 15's and phase 16's NCCL legs "
                         "alone (dp = the card count; on two or more cards "
                         "dp with zero1, and dp x tp 2 on four; pp, pp x "
                         "tp 2, pp x dp 2, fsdp and the service at dp)")
    args = ap.parse_args(argv)

    dev = require_cuda()                       # raises without a card
    card_line = card()
    print(card_line, flush=True)
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=card_line,
         count=torch.cuda.device_count())
    if args.mla_only:
        mla_kernel(args.seed, dev, card_line, build.build())
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return

    t0 = time.perf_counter()
    built = build.build()
    emit(phase="build", wall_seconds=time.perf_counter() - t0,
         seconds={k: v["seconds"] for k, v in built.items()},
         libraries={k: v["path"] for k, v in built.items()},
         ptxas={k: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in built.items()})
    for name in build.ENTRIES:
        build.library(name)
    if args.adamw_only:
        adamw_kernel(args.seed, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.checkpoints_only:
        p7 = train_path(args, dev, card_line)
        checkpoints_path(args, dev, card_line, p7)
        del p7
        torch.cuda.empty_cache()
        parallel_path(args, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.vision_speech_only:
        vision_speech_path(args, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.encoders_only:
        encoders_path(args, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.seq2seq_only:
        seq2seq_path(args, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.processors_only:
        processors_path(args, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.pipeline_only:
        pipeline_path(args, dev, card_line)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return
    if args.parallel_only:
        parallel_path(args, dev, card_line, shared=False)
        torch.cuda.empty_cache()
        pipeline_path(args, dev, card_line, shared=False)
        print(card_line, flush=True)
        emit(ok=True, device={"platform": "gpu",
                              "kind": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count()})
        return

    # (the phases just ended, when), from the start of the build
    marks = [("", t0)]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    mark("2")
    results = [check_kernel(1000, dt, args.seed, dev, False, card_line)
               for dt in (torch.float32, torch.bfloat16)]
    # D 512, H 4096 in float32: a corner of the shape gate, with the
    # largest hidden rows the kernel's scratch holds
    results += [check_kernel(1000, torch.float32, args.seed, dev, False,
                             card_line, d=512, h=4096),
                check_kernel(ROLLOUT_ROWS, torch.float32, args.seed, dev,
                             True, card_line, d=512, h=4096)]
    torch.cuda.empty_cache()
    serve_shape = {dt: check_kernel(SERVE_ROWS, dt, args.seed, dev, True,
                                    card_line)
                   for dt in (torch.float32, torch.bfloat16)}
    rollout_k1 = check_kernel(ROLLOUT_ROWS, torch.bfloat16, args.seed, dev,
                              True, card_line)
    results += [*serve_shape.values(), rollout_k1]

    mark("3")
    serve_launches, served = main_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("4")
    drop = dropout_kernels(args.seed, dev, card_line)
    mark("6")
    p7 = train_path(args, dev, card_line)
    train_launches = p7["launches"]
    mark("7")
    checkpoints_path(args, dev, card_line, p7)
    del p7
    torch.cuda.empty_cache()
    mark("21ab")
    k3_launches = k3_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("8")
    attn = attention_kernels(args.seed, dev, card_line)
    mark("9")
    extract_launches = extract_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("10")
    k2 = k2_kernel(args.seed, dev, card_line)
    mark("11")
    k2_launches = recipe_path(args, dev, card_line, served)
    del served
    mark("12")
    tab = tabular_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("13")
    pre = pretrain_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("14")
    par = parallel_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("15+21c")
    p16 = pipeline_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("16")
    p17 = processors_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("17")
    p18 = seq2seq_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("18")
    p19 = encoders_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("19")
    p20 = vision_speech_path(args, dev, card_line)
    torch.cuda.empty_cache()
    mark("20")
    p22 = adamw_kernel(args.seed, dev, card_line)
    p23 = mla_kernel(args.seed, dev, card_line, built)
    mark("22")
    emit(phase="phase_seconds", card=card_line,
         seconds={name: later - earlier for (_, earlier), (name, later)
                  in zip(marks, marks[1:])})

    main_k1 = serve_shape[torch.bfloat16]       # the serving path's dtype
    kernels = [{
        "name": "int8_mlp", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/int8_mlp.cu",
        "replaces": "lr2ppo_tpu/ops/pallas_int8_mlp.py:139",
        "launches": (serve_launches + train_launches["int8_mlp"]
                     + p16["serve_k1_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"], "bound_by": main_k1["bound_by"],
        "library_ms": None}]
    # hash dropout's launches: phase 7's, the tabular path's, the
    # pretraining run's, the pipeline stages', bert's, the seq2seq legs',
    # the recurrent towers' and the image and speech towers'
    for name, launches, err in (
            ("hash_dropout",
             train_launches["hash_dropout"] + tab["launches"]
             + pre["launches"] + p16["pp_launches"]
             + p17["bert"]["launches"] + p18["launches"]
             + p19["launches"] + p20["launches"],
             max([drop["hash_dropout"]["max_abs_err"]]
                 + [r["max_abs_err"] for r in tab["sites"]]
                 + [r["max_abs_err"] for r in pre["sites"].values()]
                 + [r["max_abs_err"]
                    for r in p17["bert"]["sites"].values()]
                 + [r["max_abs_err"] for r in p18["sites"].values()]
                 + [r["max_abs_err"] for r in p19["sites"].values()]
                 + [r["max_abs_err"] for r in p20["sites"].values()])),
            ("philox_dropout", k3_launches,
             drop["philox_dropout"]["max_abs_err"])):
        r = drop[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"lr2ppo_torch/kernels/csrc/{name}.cu",
            "replaces": DROPOUT_KERNELS[name][2], "launches": launches,
            "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the global-index form: the dp shard of the update's site, launched
    # in phase 15's shared-card legs
    r = par["sites"]["dp_shard"]
    kernels.append({
        "name": "hash_dropout_global_index", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/hash_dropout.cu",
        "replaces": DROPOUT_KERNELS["hash_dropout"][2],
        "launches": par["place_launches"],
        "max_abs_err": max(v["max_abs_err"] for k, v in par["sites"].items()
                           if not k.startswith("philox")),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the sequence-parallel place: a tp rank's tokens of the residual
    # stream, launched in phase 16's --sp legs
    r = p16["site"]
    kernels.append({
        "name": "hash_dropout_sp_place", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/hash_dropout.cu",
        "replaces": DROPOUT_KERNELS["hash_dropout"][2],
        "launches": p16["sp_place_launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    main_k4 = attn[("text", torch.float32)]     # the extraction path's dtype
    kernels.append({
        "name": "fused_attention", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/fused_attention.cu",
        "replaces": "lr2ppo_tpu/ops/pallas_attention.py:50",
        # phase 10's extraction and phase 20's encode of the BEiT -best
        "launches": extract_launches + p20["k4"],
        "max_abs_err": max(r["max_abs_err"] for r in attn.values()),
        "ms": main_k4["ms"], "plain_ms": main_k4["plain_ms"],
        "bound_ms": main_k4["bound_ms"], "bound_by": main_k4["bound_by"],
        "library_ms": main_k4["library_ms"]})
    main_k2 = k2["rollout"]            # the stage-3 rollout's fc2 site
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "lr2ppo_tpu/ops/pallas_int8_matmul.py:81",
        "launches": k2_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
        "ms": main_k2["ms"], "plain_ms": main_k2["plain_ms"],
        "bound_ms": main_k2["bound_ms"], "bound_by": main_k2["bound_by"],
        # no one PyTorch call quantizes x per row and multiplies in s8;
        # torch._int_mm on operands already quantized is in phase 11
        "library_ms": None})
    # K2's tp entry: its two kernels at a tp-2 rank's shard of the
    # rollout's fc2 site, launched in phase 17's tp leg
    for name, entry in (("int8_dot_s32", "lr2ppo_int8_dot_s32"),
                        ("s32_epilogue", "lr2ppo_int8_s32_epilogue")):
        r = p17["k2_tp"][name]
        kernels.append({
            "name": name, "route": "cuda", "entry": entry,
            "source": "lr2ppo_torch/kernels/csrc/int8_matmul.cu",
            "replaces": "lr2ppo_tpu/ops/pallas_int8_matmul.py:81",
            "launches": p17["legs"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"],
                               p17["legs"]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # AdamW: the out_layer weight's step, launched in phase 7's updates
    # (one launch a tensor) and phase 22
    r = p22["out_layer"]
    kernels.append({
        "name": "adamw", "route": "cuda",
        "source": "lr2ppo_torch/kernels/csrc/adamw.cu",
        "replaces": None, "launches": train_launches["adamw"],
        "max_abs_err": max(v.get("max_abs_err", 0.0) for v in p22.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the latent tower's causal attention: the Triton forward and the CUDA
    # backward
    kernels.append({
        "name": "mla_attention", "route": "triton forward, cuda backward",
        "source": "lr2ppo_torch/ops/mla_attention.py, "
                  "lr2ppo_torch/kernels/csrc/mla_attention_bwd.cu",
        "replaces": None,
        "launches": p23["launches"],
        "ms": p23["fwd_ms"] + p23["bwd_ms"],
        "plain_ms": p23["plain_fwd_bwd_ms"],
        "bound_ms": p23["fwd_bound_ms"] + p23["bwd_bound_ms"],
        "bound_by": "operations",
        "library_ms": p23.get("sdpa_fwd_ms", 0) + p23.get("sdpa_bwd_ms", 0)})
    print(card_line, flush=True)
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
