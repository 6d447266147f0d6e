"""The plain PyTorch reference of causal-LM pretraining of the DeepSeek-V3
block as Moonlight-16B-A3B configures it, cut to the experts one card holds:
the word table, pre-norm layers of multi-head latent attention and a dense
(the first `first_k_dense_replace`) or mixture-of-experts SwiGLU
feed-forward, the final RMSNorm, the untied head and the loss, with the
sequence-wise balance loss added and the correction bias moved after each
AdamW step. It imports nothing of the program; its weights are a dict of
tensors under the tower's state-dict keys.

Per token x, all products without bias:
  MLA: q = W_q x (per head 128 + 64); [c, k_pe] = W_kva x (512 + one 64 for
    all heads); c = RMSNorm(c); [k_nope, v] = W_kvb c (per head 128 + 128);
    RoPE (theta 50,000) on q_pe and k_pe, the 64 dims de-interleaved (even
    ones first) before rotate_half, as DeepSeek-V3's published code does;
    o = W_o causal_softmax([q_nope, q_pe] [k_nope, k_pe]ᵀ / sqrt(192)) v.
  dense: W_down(silu(W_gate x) * W_up x).
  MoE: s = sigmoid(W_r x) in float32; the top k of s + b (b the correction
    bias); g = s / (sum of the chosen s) x routed_scaling_factor; y = sum
    over the chosen experts that the card holds of g E(x), plus the shared
    expert S(x).
  balance: alpha sum_i f_i P_i per sequence, f_i = n_experts / (k S) x the
    sequence's choices of expert i, P_i the mean of s_i / sum_j s_j over its
    tokens; averaged over the micro-batch's sequences and added to the LM
    loss (the mean NLL over the targets > 0 of the micro-batch).
  after each AdamW step: b_i += gamma sign(mean load - load_i), the load of
    each expert counted over the step's tokens.

`follow` runs the first optimizer steps one sequence at a time, each
sequence's loss (its NLL sum over the micro-batch's target count, plus its
balance loss over the micro-batch's sequences) backpropagated on its own, so
the gradients add up to the micro-batch's; each layer runs under
torch.utils.checkpoint and the attention in blocks of query rows, so no
sequence holds more than a block's scores. AdamW as the program's: m and v
in float32, no bias correction, decay after the Adam step (not of the
norms), the lr warmed up linearly over warmup x total_steps steps then
decayed linearly to 0. It returns each step's loss, the first gradient's
norm of every leaf, every leaf's change over the steps, the correction
biases at the end and the first step's routes of its first micro-batch.

Precision "fp8", the control, rounds both operands and the result of every
product, and each softmax's, SwiGLU's and norm's output inside the layers
and the head, to float8 e4m3 (a scale per tensor); the router stays float32
as the configuration states.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.lr2ppo import mm, rnd

# query rows a block of the attention
BLOCK = 1024


def rms(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (..., S, d) rotated at positions 0..S-1, de-interleaved first."""
    s, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    f = torch.outer(torch.arange(s, device=x.device, dtype=torch.float32),
                    inv)
    emb = torch.cat([f, f], -1)
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


def attention(q, k, v, scale, prec):
    """Causal attention of q, k (H, S, dqk) and v (H, S, dv), BLOCK query
    rows at a time."""
    s = q.shape[1]
    out = []
    for a in range(0, s, BLOCK):
        e = min(a + BLOCK, s)
        sc = mm(q[:, a:e], k[:, :e].transpose(-1, -2), prec) * scale
        keep = (torch.arange(a, e, device=q.device)[:, None]
                >= torch.arange(e, device=q.device)[None, :])
        sc = sc.masked_fill(~keep, float("-inf"))
        out.append(mm(rnd(torch.softmax(sc, -1), prec), v[:, :e], prec))
    return torch.cat(out, 1)


def lin(x, w, prec):
    return mm(x, w.t(), prec)


def mla(p, pre, x, c, prec):
    s, h = x.shape[0], c["heads_num"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    q = lin(x, p[pre + "q_proj.weight"], prec).view(s, h, nope + rd)
    lat, kpe = lin(x, p[pre + "kv_a_proj_with_mqa.weight"], prec).split(
        [c["kv_lora_rank"], rd], -1)
    lat = rnd(rms(lat, p[pre + "kv_a_layernorm.weight"], c["rms_norm_eps"]),
              prec)
    kv = lin(lat, p[pre + "kv_b_proj.weight"], prec).view(s, h, nope + vd)
    knope, v = kv.split([nope, vd], -1)
    qh = torch.cat([q[..., :nope].transpose(0, 1),
                    rope(q[..., nope:].transpose(0, 1), c["rope_theta"])], -1)
    kpe = rope(kpe, c["rope_theta"])
    kh = torch.cat([knope.transpose(0, 1), kpe[None].expand(h, s, rd)], -1)
    o = attention(qh, kh, v.transpose(0, 1), 1.0 / math.sqrt(nope + rd),
                  prec)
    return lin(o.transpose(0, 1).reshape(s, h * vd),
               p[pre + "o_proj.weight"], prec)


def swiglu(p, pre, x, prec):
    g = lin(x, p[pre + "gate_proj.weight"], prec)
    u = lin(x, p[pre + "up_proj.weight"], prec)
    return lin(rnd(F.silu(g) * u, prec), p[pre + "down_proj.weight"], prec)


def moe(p, pre, x, c, bias, prec):
    """(y, balance loss, chosen ids (S, k)) of one sequence x (S, d)."""
    n, k = c["router_experts"], c["num_experts_per_tok"]
    scores = torch.sigmoid(x @ p[pre + "gate.weight"].t())
    idx = torch.topk(scores + bias, k, dim=-1).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    y = swiglu(p, pre + "shared_experts.", x, prec)
    for e in c["held_experts"]:
        hit = idx == e
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel():
            g = (w * hit).sum(-1)[tok]
            y = y.index_add(0, tok, g[:, None] * swiglu(
                p, f"{pre}experts.{e}.", x[tok], prec))
    s = x.shape[0]
    probs = scores / scores.sum(-1, keepdim=True)
    f = torch.bincount(idx.reshape(-1), minlength=n).float() * (n / (k * s))
    aux = c["aux_loss_alpha"] * (f * probs.mean(0)).sum()
    return y, aux, idx


def layer_fn(p, i, c, bias, prec):
    pre = f"encoder.transformer.{i}."
    eps = c["rms_norm_eps"]

    def run(x):
        h = x + mla(p, pre + "self_attn.", rnd(rms(
            x, p[pre + "input_layernorm.weight"], eps), prec), c, prec)
        z = rnd(rms(h, p[pre + "post_attention_layernorm.weight"], eps),
                prec)
        if bias is None:
            return h + swiglu(p, pre + "mlp.", z, prec), None, None
        y, aux, idx = moe(p, pre + "mlp.", z, c, bias, prec)
        return h + y, aux, idx

    return run


def sequence_loss(p, c, biases, src, tgt, denom, n_seq, prec):
    """(the sequence's share of the micro-batch's loss, [chosen ids of each
    MoE layer])."""
    x = p["embedding.word.embedding.weight"][src.long()]
    aux_sum, routes = 0.0, []
    for i in range(c["layers_num"]):
        x, aux, idx = checkpoint(layer_fn(p, i, c, biases.get(i), prec), x,
                                 use_reentrant=False)
        if aux is not None:
            aux_sum = aux_sum + aux
            routes.append(idx)
    x = rnd(rms(x, p["encoder.layer_norm.weight"], c["rms_norm_eps"]), prec)
    logits = lin(x, p["target.lm.output_layer.weight"], prec)
    nll = -torch.gather(F.log_softmax(logits.float(), -1), 1,
                        tgt.long()[:, None])[:, 0]
    m = (tgt > 0).float()
    return (nll * m).sum() / denom + aux_sum / n_seq, routes


def bias_key(i: int) -> str:
    return f"encoder.transformer.{i}.mlp.gate.e_score_correction_bias"


def decays(key: str) -> bool:
    return not key.endswith(("layernorm.weight", "layer_norm.weight"))


def follow(weights: dict, batches: List[dict], h: dict,
           prec: str = "float32") -> dict:
    """The first optimizer steps: each batch (src, tgt on the device) is one
    step of h["accumulation_steps"] micro-batches, whose gradients are
    averaged; h["tower"] holds the configuration, with the router's width
    (`router_experts`) and the ids of the experts held (`held_experts`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = h["tower"]
    moe_layers = [i for i in range(c["layers_num"])
                  if i >= c["first_k_dense_replace"]]
    biases = {i: weights[bias_key(i)].detach().clone().float()
              for i in moe_layers}
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items() if "e_score_correction_bias" not in k}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    n = float(h["total_steps"])
    w = max(int(h["total_steps"] * h["warmup"]), 1)
    accum = h["accumulation_steps"]
    n_exp = c["router_experts"]
    obs = {"loss": [], "g1": None, "routes": None}
    for t, batch in enumerate(batches):
        rows = batch["src"].shape[0] // accum
        total = 0.0
        loads = {i: torch.zeros(n_exp, device=batch["src"].device)
                 for i in moe_layers}
        for a in range(accum):
            src = batch["src"][a * rows:(a + 1) * rows]
            tgt = batch["tgt"][a * rows:(a + 1) * rows]
            denom = (tgt > 0).float().sum() + 1e-6
            routes = {i: [] for i in moe_layers}
            for r in range(rows):
                lo, got = sequence_loss(p, c, biases, src[r], tgt[r], denom,
                                        rows, prec)
                lo.backward()
                total += float(lo.detach())
                for i, idx in zip(moe_layers, got):
                    loads[i] += torch.bincount(idx.reshape(-1),
                                               minlength=n_exp)
                    if t == 0 and a == 0:
                        routes[i].append(idx.to(torch.uint8).cpu())
            if t == 0 and a == 0:
                obs["routes"] = {i: torch.cat(r) for i, r in routes.items()}
        obs["loss"].append(total / accum)
        lr = h["learning_rate"] * (t / w if t < w else max(
            0.0, (n - t) / max(1.0, n - w)))
        norms = {}
        with torch.no_grad():
            for k, x in p.items():
                g = (x.grad if x.grad is not None
                     else torch.zeros_like(x)) / accum
                norms[k] = float(g.double().norm())
                m[k].mul_(h["beta1"]).add_(g * (1 - h["beta1"]))
                v2[k].mul_(h["beta2"]).add_(g * g * (1 - h["beta2"]))
                upd = m[k] / (torch.sqrt(v2[k]) + h["adam_eps"])
                if decays(k):
                    upd = upd + h["weight_decay"] * x
                x.add_(upd * -lr)
                x.grad = None
            for i in moe_layers:
                biases[i] += torch.sign(loads[i].mean() - loads[i]) \
                    * c["bias_update_speed"]
        if obs["g1"] is None:
            obs["g1"] = norms
    obs["change"] = {k: float((p[k].detach() - weights[k].float())
                              .double().norm()) for k in p}
    obs["biases"] = {bias_key(i): b.cpu() for i, b in biases.items()}
    return obs
