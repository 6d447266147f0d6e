"""A plain float32 reference of the DeepSeek-V3 block as Moonlight-16B-A3B
configures it, written from the published equations (arXiv:2412.19437
§2.1; Moonlight's config.json) over a dict of tensors under the port's
state-dict keys. It imports nothing of lr2ppo_torch and no kernel: the
tests hold the port's latent tower against it on the CPU.

  causal_attention  softmax(q kᵀ · scale + causal mask) v, q/k and v of
                    their own widths;
  mla               q = W_q x; [c, k_pe] = W_kva x; c = RMSNorm(c);
                    [k_nope, v] = W_kvb c; RoPE on q_pe and k_pe (the 64
                    dims de-interleaved first, as DeepSeek-V3's published
                    code does); o = W_o attention;
  route             sigmoid scores, the top k of score + bias, the chosen
                    scores normalised and scaled;
  moe               sum over the chosen experts in `held` of g E(x), plus
                    the shared expert; the sequence-wise balance loss;
  tower_loss        word table, the layers (dense for the first
                    first_k_dense_replace), the final RMSNorm, the untied
                    head, the masked mean NLL plus the balance losses;
  adamw_step        the port's AdamW (no bias correction, decay after the
                    Adam step, not of the norms) and the correction bias
                    moved by gamma sign(mean load - load).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (..., S, d) at positions 0..S-1."""
    s, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    f = torch.outer(torch.arange(s, dtype=torch.float32), inv)
    cos, sin = torch.cat([f, f], -1).cos(), torch.cat([f, f], -1).sin()
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1) * sin


def causal_attention(q, k, v, scale):
    """q, k (..., S, dqk), v (..., S, dv)."""
    s = q.shape[-2]
    sc = q @ k.transpose(-1, -2) * scale
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        float("-inf"))
    return torch.softmax(sc, -1) @ v


def mla(p: dict, pre: str, x, c: dict):
    """x (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    h, nope, rd, vd = (c["heads_num"], c["qk_nope_head_dim"],
                       c["qk_rope_head_dim"], c["v_head_dim"])
    q = (x @ p[pre + "q_proj.weight"].t()).view(b, s, h, nope + rd)
    lat, kpe = (x @ p[pre + "kv_a_proj_with_mqa.weight"].t()).split(
        [c["kv_lora_rank"], rd], -1)
    lat = rms(lat, p[pre + "kv_a_layernorm.weight"], c["rms_norm_eps"])
    kv = (lat @ p[pre + "kv_b_proj.weight"].t()).view(b, s, h, nope + vd)
    q = q.transpose(1, 2)
    kv = kv.transpose(1, 2)
    qh = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    kpe = rope(kpe, c["rope_theta"])[:, None].expand(b, h, s, rd)
    kh = torch.cat([kv[..., :nope], kpe], -1)
    o = causal_attention(qh, kh, kv[..., nope:], 1.0 / math.sqrt(nope + rd))
    o = o.transpose(1, 2).reshape(b, s, h * vd)
    return o @ p[pre + "o_proj.weight"].t()


def swiglu(p: dict, pre: str, x):
    return (F.silu(x @ p[pre + "gate_proj.weight"].t())
            * (x @ p[pre + "up_proj.weight"].t())) @ p[
                pre + "down_proj.weight"].t()


def route(scores, bias, k: int, scaling: float):
    idx = torch.topk(scores + bias, k, dim=-1).indices
    w = scores.gather(1, idx)
    return idx, w / w.sum(-1, keepdim=True) * scaling


def moe(p: dict, pre: str, x, c: dict, bias, held: List[int]):
    """(y (B, S, d), balance loss, chosen ids (B·S, k)) of x (B, S, d)."""
    b, s, d = x.shape
    n, k = bias.numel(), c["num_experts_per_tok"]
    xf = x.reshape(b * s, d)
    scores = torch.sigmoid(xf @ p[pre + "gate.weight"].t())
    idx, w = route(scores, bias, k, c["routed_scaling_factor"])
    y = swiglu(p, pre + "shared_experts.", xf)
    for e in held:
        g = (w * (idx == e)).sum(-1, keepdim=True)
        if bool((idx == e).any()):
            y = y + g * swiglu(p, f"{pre}experts.{e}.", xf)
    probs = (scores / scores.sum(-1, keepdim=True)).view(b, s, n)
    f = torch.stack([torch.bincount(idx.view(b, -1)[i], minlength=n)
                     for i in range(b)]).float() * (n / (k * s))
    aux = c["aux_loss_alpha"] * (f * probs.mean(1)).sum(1).mean()
    return y.view(b, s, d), aux, idx


def tower_loss(p: dict, c: dict, src, tgt, biases: Dict[int, torch.Tensor],
               held: List[int]):
    """(loss, LM loss, balance loss, {MoE layer: chosen ids})."""
    x = p["embedding.word.embedding.weight"][src]
    eps = c["rms_norm_eps"]
    balance, routes = 0.0, {}
    for i in range(c["layers_num"]):
        pre = f"encoder.transformer.{i}."
        x = x + mla(p, pre + "self_attn.", rms(
            x, p[pre + "input_layernorm.weight"], eps), c)
        z = rms(x, p[pre + "post_attention_layernorm.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(p, pre + "mlp.", z)
        else:
            y, aux, routes[i] = moe(p, pre + "mlp.", z, c, biases[i], held)
            x, balance = x + y, balance + aux
    x = rms(x, p["encoder.layer_norm.weight"], eps)
    logp = F.log_softmax(x @ p["target.lm.output_layer.weight"].t(), -1)
    m = (tgt > 0).float()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    lm = (nll * m).sum() / (m.sum() + 1e-6)
    return lm + balance, lm, balance, routes


def adamw_step(p: dict, grads: dict, lr: float, b1=0.9, b2=0.999, eps=1e-6,
               weight_decay=0.01) -> dict:
    """One step from zero moments: the new parameters."""
    out = {}
    for k, x in p.items():
        g = grads[k]
        mk, vk = g * (1 - b1), g * g * (1 - b2)
        upd = mk / (torch.sqrt(vk) + eps)
        if not k.endswith(("layernorm.weight", "layer_norm.weight")):
            upd = upd + weight_decay * x
        out[k] = x - lr * upd
    return out


def bias_step(bias, routes, gamma: float):
    """The correction bias after a step whose choices were `routes`."""
    load = torch.bincount(routes.reshape(-1), minlength=bias.numel()).float()
    return bias + gamma * torch.sign(load.mean() - load)
