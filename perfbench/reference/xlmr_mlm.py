"""The plain PyTorch reference of masked-LM pretraining of a BERT-style
tower (XLM-R base): word, position and segment embeddings and their layer
norm, post-LN transformer layers (12 heads of 64, a GELU FFN), the MLM head
(linear, GELU, layer norm, the vocabulary) and its loss over the masked
positions, with hash dropout and AdamW, over a dict of tensors under the
tower's state-dict keys (TencentPretrain's: `embedding.*`,
`encoder.transformer.<i>.*`, `target.mlm.*`). It imports nothing of the
program.

`follow` runs the first optimizer steps from the benchmark's weights and the
steps' batches and returns each step's loss, the first gradient's norm of
every leaf and every leaf's change over the steps.

Layer norm is TencentPretrain's: gamma (x - mean) / (std + eps) + beta with
the Bessel-corrected std, eps 1e-6. The loss reads the vocabulary only at
the masked positions (tgt > 0), so the head is computed only there.
Dropout is the configuration's hash dropout (reference/lr2ppo.py); its
seeds come from a CPU generator seeded seed + 1, one a site in forward
order: the embedding, then per layer the attention probabilities, the
attention branch and the FFN branch. A site's 1/keep is rounded to its
input's dtype: float32 at the embedding (its sum is float32), the compute
dtype elsewhere. Precision "fp8", the control, rounds both operands and
the result of every product, and each softmax's, GELU's and layer norm's
output inside the encoder and the head, to float8 e4m3 (a scale per tensor).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.lr2ppo import Dropout, mm, rnd


def ref_layer_norm(x, p, name, eps=1e-6):
    x = x.float()
    d = x.shape[-1]
    c = x - x.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True) * (d / max(d - 1, 1))
    std = torch.sqrt(torch.clamp_min(var, 1e-20))
    return p[name + ".gamma"] * c / (std + eps) + p[name + ".beta"]


def linear(x, p, name, prec):
    return mm(x, p[name + ".weight"].t(), prec) + p[name + ".bias"]


def loss(p: dict, h: dict, src, tgt, seg, drop, prec: str):
    """The MLM loss of one micro-batch."""
    b, s = src.shape
    heads = h["heads_num"]
    d = h["hidden_size"]
    dh = d // heads
    x = (p["embedding.word.embedding.weight"][src.long()]
         + p["embedding.pos.embedding.weight"][:s][None]
         + p["embedding.seg.embedding.weight"][seg.long()])
    x = drop(ref_layer_norm(x, p, "embedding.layer_norm"), torch.float32)
    mask = torch.where((seg > 0)[:, None, None, :], 0.0, -10000.0)
    for i in range(h["layers_num"]):
        pre = f"encoder.transformer.{i}."

        def heads_of(t):
            return t.reshape(b, s, heads, dh).transpose(1, 2)

        a = pre + "self_attn."
        q = heads_of(linear(x, p, a + "linear_layers.0", prec))
        k = heads_of(linear(x, p, a + "linear_layers.1", prec))
        v = heads_of(linear(x, p, a + "linear_layers.2", prec))
        scores = mm(q, k.transpose(-1, -2), prec) / math.sqrt(dh) + mask
        probs = drop(rnd(torch.softmax(scores, -1), prec))
        o = mm(probs, v, prec).transpose(1, 2).reshape(b, s, d)
        o = linear(o, p, a + "final_linear", prec)
        x = rnd(ref_layer_norm(drop(o) + x, p, pre + "layer_norm_1"), prec)
        f = rnd(F.gelu(linear(x, p, pre + "feed_forward.linear_1", prec)),
                prec)
        f = linear(f, p, pre + "feed_forward.linear_2", prec)
        x = rnd(ref_layer_norm(drop(f) + x, p, pre + "layer_norm_2"), prec)
    m = tgt > 0
    y = x[m]
    y = rnd(F.gelu(linear(y, p, "target.mlm.linear_1", prec)), prec)
    y = rnd(ref_layer_norm(y, p, "target.mlm.layer_norm"), prec)
    logits = linear(y, p, "target.mlm.linear_2", prec)
    nll = -torch.gather(F.log_softmax(logits.float(), -1), 1,
                        tgt[m].long()[:, None])[:, 0]
    return nll.sum() / (m.float().sum() + 1e-6)


class SiteDropout(Dropout):
    """Dropout whose 1/keep is rounded to the site's dtype: the compute
    dtype, or the one a call names."""

    def __init__(self, seed, rate, compute_dtype):
        super().__init__(seed, rate, compute_dtype)
        self.compute_dtype = compute_dtype

    def __call__(self, x, dtype: Optional[torch.dtype] = None):
        keep = 1.0 / (float(self.thr) / 4294967296.0)
        self.scale = float(torch.tensor(keep, dtype=dtype
                                        or self.compute_dtype))
        return super().__call__(x)


def follow(weights: dict, batches: List[dict], h: dict,
           prec: str = "float32") -> dict:
    """The first optimizer steps: each batch (src, tgt, seg on the device)
    is one step of h["accumulation_steps"] micro-batches, whose gradients
    are averaged. AdamW: m and v in float32, no bias correction, decay
    (not of biases) after the Adam step, the lr warmed up linearly over
    warmup x total_steps steps then decayed linearly to 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    drop = SiteDropout(h["seed"] + 1, h["dropout"],
                       getattr(torch, h["compute_dtype"]))
    n = float(h["total_steps"])
    w = max(int(h["total_steps"] * h["warmup"]), 1)
    accum = h["accumulation_steps"]
    obs = {"loss": [], "g1": None}
    for t, batch in enumerate(batches):
        rows = batch["src"].shape[0] // accum
        total = 0.0
        for a in range(accum):
            part = {k: x[a * rows:(a + 1) * rows] for k, x in batch.items()}
            lo = loss(p, h, part["src"], part["tgt"], part["seg"], drop,
                      prec)
            lo.backward()
            total += float(lo.detach())
        obs["loss"].append(total / accum)
        lr = h["learning_rate"] * (t / w if t < w else max(
            0.0, (n - t) / max(1.0, n - w)))
        norms = {}
        with torch.no_grad():
            for k, x in p.items():
                g = x.grad / accum
                norms[k] = float(g.double().norm())
                m[k].mul_(h["beta1"]).add_(g * (1 - h["beta1"]))
                v2[k].mul_(h["beta2"]).add_(g * g * (1 - h["beta2"]))
                upd = m[k] / (torch.sqrt(v2[k]) + h["adam_eps"])
                if not k.endswith(".bias"):
                    upd = upd + h["weight_decay"] * x
                x.add_(upd * -lr)
                x.grad = None
        if obs["g1"] is None:
            obs["g1"] = norms
    obs["change"] = {k: float((p[k].detach() - weights[k].float())
                              .double().norm()) for k in p}
    return obs
