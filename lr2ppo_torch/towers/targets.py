"""Pretraining targets of the towers (counterpart of
lr2ppo_tpu/towers/targets.py; reference tencentpretrain/targets/): mlm, lm
(with label smoothing), bilm, cls, sp and the composite target.

As in the JAX package, a masked mean weights every position by its mask and
divides by the mask count plus 1e-6, instead of gathering the masked
positions, and every log-softmax runs in float32. Each head keeps the JAX
package's module names under `target.<kind>` (`target.mlm.linear_1`,
`target.mlm.layer_norm`, `target.mlm.linear_2`, `target.lm.output_layer`,
...), so the tower bridge (torch_import.py) carries a JAX tree across.

The contrastive `clr` target of dual encoders raises (ROADMAP A: the rest
of the towers).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.towers.layers import ACTS, NOT_PORTED, RefLayerNorm, pooling


def _masked_nll(log_probs: torch.Tensor, tgt: torch.Tensor,
                mask: torch.Tensor):
    """(mean NLL, correct count, mask count + 1e-6) over the positions where
    mask holds, all float32."""
    nll = -torch.gather(log_probs, -1, tgt.long()[..., None])[..., 0]
    m = mask.float()
    denom = m.sum() + 1e-6
    loss = (nll * m).sum() / denom
    correct = ((log_probs.argmax(-1) == tgt) & mask).sum().float()
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
        x = self.layer_norm(self.act(self.linear_1(memory_bank)))
        return _masked_nll(_log_softmax(self.linear_2(x)), tgt, tgt > 0)


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
        log_probs = _log_softmax(self.output_layer(memory_bank))
        mask = tgt > 0
        if not self.label_smoothing:
            return _masked_nll(log_probs, tgt, mask)
        eps = self.label_smoothing
        eps_i = eps / (self.vocab_size - 1)
        nll = -torch.gather(log_probs, -1, tgt.long()[..., None])[..., 0]
        smooth = -log_probs.sum(-1)
        m = mask.float()
        denom = m.sum() + 1e-6
        nll_mean = (nll * m).sum() / denom
        smooth_mean = (smooth * m).sum() / denom
        loss = (1.0 - eps - eps_i) * nll_mean + eps_i * smooth_mean
        correct = ((log_probs.argmax(-1) == tgt) & mask).sum().float()
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
        lp_f = _log_softmax(self.output_layer_forward(memory_bank[..., :half]))
        lp_b = _log_softmax(self.output_layer_backward(memory_bank[..., half:]))
        lf, cf, df = _masked_nll(lp_f, tgt_fwd, tgt_fwd > 0)
        lb, cb, db = _masked_nll(lp_b, tgt_bwd, tgt_bwd > 0)
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
        correct = (log_probs.argmax(-1) == tgt).sum().float()
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
        correct = (log_probs.argmax(-1) == tgt).sum().float()
        return loss, correct


TARGET_KINDS = {"mlm": MlmTarget, "lm": LmTarget, "bilm": BilmTarget,
                "cls": ClsTarget, "sp": SpTarget}


class CompositeTarget(nn.Module):
    """The configured targets, each a submodule named by its kind
    (target.py:4-23). One target returns its tuple; several return
    {kind: tuple}, each fed tgt[kind]."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.kinds = list(cfg.target)
        for kind in self.kinds:
            if kind not in TARGET_KINDS:
                raise NotImplementedError(f"the {kind!r} target is "
                                          f"{NOT_PORTED}")
            self.add_module(kind, TARGET_KINDS[kind](cfg, dtype, device))

    def forward(self, memory_bank, tgt, seg):
        if len(self.kinds) == 1:
            return getattr(self, self.kinds[0])(memory_bank, tgt, seg)
        return {kind: getattr(self, kind)(memory_bank, tgt[kind], seg)
                for kind in self.kinds}
