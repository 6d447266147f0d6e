"""Pretraining targets of the towers (counterpart of
lr2ppo_tpu/towers/targets.py; reference tencentpretrain/targets/): mlm, lm
(with label smoothing), bilm, cls, sp, clr (CLIP-style contrastive) and the
composite target.

As in the JAX package, a masked mean weights every position by its mask and
divides by the mask count plus 1e-6, instead of gathering the masked
positions, and every log-softmax runs in float32. The JAX loss is taken over
the global batch, so under dp the numerators and counts are summed over the
dp ranks before the division (parallel/tp.py:dp_sum). Under tp the
vocabulary heads (`output_layer*`, the MLM `linear_2`) are column-split:
the log-softmax is vocab-parallel (a max and a sum of exponentials
all-reduced over tp), the target's logit and the argmax are picked across
the ranks, and no rank gathers the logits. Each head keeps the JAX
package's module names under `target.<kind>` (`target.mlm.linear_1`,
`target.mlm.layer_norm`, `target.mlm.linear_2`, `target.lm.output_layer`,
...), so the tower bridge (torch_import.py) carries a JAX tree across.

The contrastive `clr` target reads a dual tower's pair of streams. Under dp
it gathers both feature sets over the dp ranks, with their gradients
(parallel/tp.py:gather_dp_rows), so its similarity matrix is the global
batch's, as JAX's is under pjit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.parallel.tp import (dp_sum, gather_dp_rows,
                                      gather_from_tp, reduce_from_tp,
                                      vocab_parallel_argmax,
                                      vocab_parallel_log_softmax_parts,
                                      vocab_parallel_pick)
from lr2ppo_torch.towers.layers import ACTS, RefLayerNorm, pooling


class _VocabTerms:
    """What a vocabulary loss reads of float32 logits: nll(tgt), the
    prediction and the sum of log-probabilities, whole or vocab-parallel
    where `head` is column-split over tp."""

    def __init__(self, logits: torch.Tensor, head: Linear):
        self.z = logits.float()
        self.mesh = head.mesh if head.tp_dim == 0 else None
        if self.mesh is None:
            self.log_probs = F.log_softmax(self.z, dim=-1)
        else:
            self.log_z = vocab_parallel_log_softmax_parts(self.z, self.mesh)

    def nll(self, tgt: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return -torch.gather(self.log_probs, -1,
                                 tgt.long()[..., None])[..., 0]
        return self.log_z[..., 0] - vocab_parallel_pick(self.z, tgt,
                                                        self.mesh)

    def argmax(self) -> torch.Tensor:
        if self.mesh is None:
            return self.log_probs.argmax(-1)
        return vocab_parallel_argmax(self.z, self.mesh)

    def sum_log_probs(self, vocab_size: int) -> torch.Tensor:
        if self.mesh is None:
            return self.log_probs.sum(-1)
        return (reduce_from_tp(self.z.sum(-1), self.mesh)
                - vocab_size * self.log_z[..., 0])


def _masked_nll(terms: _VocabTerms, tgt: torch.Tensor, mask: torch.Tensor):
    """(mean NLL, correct count, mask count + 1e-6) over the positions where
    mask holds in the global batch, all float32."""
    nll = terms.nll(tgt)
    m = mask.float()
    denom = dp_sum(m.sum()) + 1e-6
    loss = dp_sum((nll * m).sum()) / denom
    correct = dp_sum(((terms.argmax() == tgt) & mask).sum().float())
    return loss, correct, denom


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits.float(), dim=-1)


class MlmTarget(nn.Module):
    """Masked LM head: linear_1 -> act -> layer_norm -> linear_2 over the
    vocabulary (mlm_target.py:6-55); the loss over the positions where
    tgt > 0."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.act = ACTS[cfg.hidden_act]
        width = (cfg.emb_size if cfg.factorized_embedding_parameterization
                 else cfg.hidden_size)
        self.linear_1 = Linear(cfg.hidden_size, width, dtype=dtype,
                               device=device)
        self.layer_norm = RefLayerNorm(width, device=device)
        self.linear_2 = Linear(width, cfg.vocab_size, dtype=dtype,
                               device=device)

    def forward(self, memory_bank, tgt, seg):
        x = self.act(self.linear_1(memory_bank))
        if self.linear_1.tp_dim == 0:
            # the layer norm reads the whole row
            x = gather_from_tp(x, self.linear_1.mesh)
        x = self.layer_norm(x)
        return _masked_nll(_VocabTerms(self.linear_2(x), self.linear_2), tgt,
                           tgt > 0)


class LmTarget(nn.Module):
    """Causal LM head with optional label smoothing (lm_target.py:7-70)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.vocab_size = cfg.vocab_size
        self.label_smoothing = cfg.label_smoothing
        self.output_layer = Linear(cfg.hidden_size, cfg.vocab_size,
                                   bias=cfg.has_lmtarget_bias, dtype=dtype,
                                   device=device)

    def forward(self, memory_bank, tgt, seg):
        terms = _VocabTerms(self.output_layer(memory_bank), self.output_layer)
        mask = tgt > 0
        if not self.label_smoothing:
            return _masked_nll(terms, tgt, mask)
        eps = self.label_smoothing
        eps_i = eps / (self.vocab_size - 1)
        nll = terms.nll(tgt)
        smooth = -terms.sum_log_probs(self.vocab_size)
        m = mask.float()
        denom = dp_sum(m.sum()) + 1e-6
        nll_mean = dp_sum((nll * m).sum()) / denom
        smooth_mean = dp_sum((smooth * m).sum()) / denom
        loss = (1.0 - eps - eps_i) * nll_mean + eps_i * smooth_mean
        correct = dp_sum(((terms.argmax() == tgt) & mask).sum().float())
        return loss, correct, denom


class BilmTarget(nn.Module):
    """Bidirectional LM: a forward and a backward vocabulary head over the
    two halves of the hidden state (bilm_target.py); tgt is (fwd, bwd)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        half = cfg.hidden_size // 2
        self.output_layer_forward = Linear(half, cfg.vocab_size, dtype=dtype,
                                           device=device)
        self.output_layer_backward = Linear(half, cfg.vocab_size,
                                            dtype=dtype, device=device)

    def forward(self, memory_bank, tgt, seg):
        tgt_fwd, tgt_bwd = tgt
        half = memory_bank.shape[-1] // 2
        fwd, bwd = self.output_layer_forward, self.output_layer_backward
        lf, cf, df = _masked_nll(_VocabTerms(fwd(memory_bank[..., :half]),
                                             fwd), tgt_fwd, tgt_fwd > 0)
        lb, cb, db = _masked_nll(_VocabTerms(bwd(memory_bank[..., half:]),
                                             bwd), tgt_bwd, tgt_bwd > 0)
        return lf + lb, cf + cb, df + db


class ClsTarget(nn.Module):
    """Sequence classification: pool -> tanh(linear_1) -> linear_2 over the
    labels (cls_target.py:6-39); returns (loss, correct)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.pooling = cfg.pooling
        self.linear_1 = Linear(cfg.hidden_size, cfg.hidden_size, dtype=dtype,
                               device=device)
        self.linear_2 = Linear(cfg.hidden_size, cfg.labels_num, dtype=dtype,
                               device=device)

    def forward(self, memory_bank, tgt, seg):
        x = torch.tanh(self.linear_1(pooling(memory_bank, seg,
                                             self.pooling)))
        log_probs = _log_softmax(self.linear_2(x))
        loss = -torch.gather(log_probs, -1, tgt.long()[:, None]).mean()
        correct = dp_sum((log_probs.argmax(-1) == tgt).sum().float())
        return loss, correct


class SpTarget(nn.Module):
    """Sentence(-order) prediction on the first position (sp_target.py);
    returns (loss, correct)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.linear_1 = Linear(cfg.hidden_size, cfg.hidden_size, dtype=dtype,
                               device=device)
        self.linear_2 = Linear(cfg.hidden_size, 2, dtype=dtype,
                               device=device)

    def forward(self, memory_bank, tgt, seg):
        x = torch.tanh(self.linear_1(memory_bank[:, 0]))
        log_probs = _log_softmax(self.linear_2(x))
        loss = -torch.gather(log_probs, -1, tgt.long()[:, None]).mean()
        correct = dp_sum((log_probs.argmax(-1) == tgt).sum().float())
        return loss, correct


class ClrTarget(nn.Module):
    """CLIP-style symmetric contrastive target (clr_target.py:8-84): each
    stream pooled with its own `pooling`, projected by
    `encoder_{0,1}_projection` (hidden, feature_size) where `projection`,
    L2-normalized, and scored against the other stream's features at
    exp(`logit_scale`). Returns (the symmetric cross-entropy, the symmetric
    retrieval accuracy's correct count, n), n the rows of the matrix: the
    global batch's under dp. A stream dict that omits a field inherits the
    base config's."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        streams = (cfg.stream_0, cfg.stream_1)
        self.pooling = [s.get("pooling", cfg.pooling) for s in streams]
        self.projection = cfg.projection
        if cfg.projection:
            for i, s in enumerate(streams):
                self.register_parameter(
                    f"encoder_{i}_projection", nn.Parameter(torch.empty(
                        s.get("hidden_size", cfg.hidden_size),
                        cfg.feature_size, device=device)))
        self.logit_scale = nn.Parameter(torch.empty((), device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.projection:
            self.encoder_0_projection.normal_(0.0, 1.0, generator=generator)
            self.encoder_1_projection.normal_(0.0, 1.0, generator=generator)
        self.logit_scale.fill_(math.log(1 / 0.07))

    def forward(self, memory_bank, tgt, seg):
        feats = []
        for i in range(2):
            f = pooling(memory_bank[i], seg[i], self.pooling[i]).float()
            if self.projection:
                f = f @ getattr(self, f"encoder_{i}_projection")
            f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
            feats.append(gather_dp_rows(f))
        f0, f1 = feats
        scale = torch.exp(self.logit_scale)
        n = f0.shape[0]
        labels = torch.arange(n, device=f0.device)
        lp0 = F.log_softmax(scale * f0 @ f1.t(), dim=-1)
        lp1 = F.log_softmax(scale * f1 @ f0.t(), dim=-1)
        loss = -(lp0[labels, labels].mean() + lp1[labels, labels].mean()) / 2
        correct = ((lp0.argmax(-1) == labels).sum()
                   + (lp1.argmax(-1) == labels).sum()).float() / 2
        return loss, correct, torch.tensor(float(n), device=f0.device)


TARGET_KINDS = {"mlm": MlmTarget, "lm": LmTarget, "bilm": BilmTarget,
                "cls": ClsTarget, "sp": SpTarget, "clr": ClrTarget}


class CompositeTarget(nn.Module):
    """The configured targets, each a submodule named by its kind
    (target.py:4-23). One target returns its tuple; several return
    {kind: tuple}, each fed tgt[kind]."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.kinds = list(cfg.target)
        for kind in self.kinds:
            self.add_module(kind, TARGET_KINDS[kind](cfg, dtype, device))

    def forward(self, memory_bank, tgt, seg):
        if len(self.kinds) == 1:
            return getattr(self, self.kinds[0])(memory_bank, tgt, seg)
        return {kind: getattr(self, kind)(memory_bank, tgt[kind], seg)
                for kind in self.kinds}
