"""The plain PyTorch reference of LR2PPO's stage-3 step: the multimodal
scorer (actor) and sequence scorer (critic, reward), the rollout, the PPO
update with hash dropout, and AdamW, written from the published recipe
(LR2PPO finetune/ppo.py:154-350 and 815-915, xit.py) over dicts of tensors
under the reference's state-dict keys. It imports nothing of the program.

`follow` runs the first sweeps of a fit from the benchmark's weights and
batches and returns what the judge compares: each rollout's scores, values
and rewards, each update's losses, the first gradient of each model and the
change of every parameter after the sweeps.

Precision. "float32" computes every product in float32 (TF32 off). The
configured int8 models (the frozen reward and the rollout's actor twin) keep
the configuration's size-gated int8: a weight of 2M elements or more is
int8 per output channel; at a call site worth 50 GFLOP or more and at least
1,024 outputs wide the input is quantized per row and the product is exact;
elsewhere the weight is dequantized; a fused FFN (both weights int8, worth
50 GFLOP, weights of at most 6 MiB) quantizes the hidden too. "fp8", the
control, rounds both operands and the result of every float product, and
each layer norm's, softmax's and GELU's output, to float8 e4m3 (a scale per
tensor), where the program holds them in its compute dtype, and quantizes
the int8 sites to int4. Dropout keeps the
configuration's masks: element i of a site is kept iff murmur3's fmix32 of
i ^ seed * 0x9E3779B9 lies below (1 - rate) 2^32, kept values scaled by
1 / keep rounded to the compute dtype; the seeds are drawn in forward order
from a CPU generator seeded seed + 2, int32 values as torch.randint draws.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

INT8_MIN_WEIGHT = 2 * 1024 * 1024
INT8_MIN_FLOPS = 50e9
INT8_MIN_WIDTH = 1024
FUSED_MAX_WEIGHT_BYTES = 6 * 1024 * 1024
FP8_MAX = 448.0
MASK32 = 0xFFFFFFFF
# elements a dropout mask is made of at a time (its int64 temporaries)
CHUNK = 1 << 24


# -- precision -----------------------------------------------------------
def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per tensor, back in float32."""
    s = t.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    # straight-through: the rounding passes the gradient unchanged
    return t + (q - t).detach()


def rnd(t: torch.Tensor, prec: str) -> torch.Tensor:
    """t as the precision holds it between operations: float8 in the
    control, float32 otherwise."""
    return fp8(t) if prec == "fp8" else t


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        a, b = fp8(a), fp8(b)
    return rnd(torch.matmul(a, b), prec)


def quant_rows(x: torch.Tensor, levels: int):
    """Symmetric per-row quantization over the last dim: (integers as
    float64, float32 scale)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax,
                                                          float(levels))
    q = torch.round(x / scale).clamp_(-levels, levels)
    return q.double(), scale


class Int8Linear:
    """A frozen linear at the configuration's int8 precision (levels 127;
    the control's int4: 7)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, levels: int):
        self.shape = tuple(w.shape)
        self.b = b.float()
        self.int8 = w.numel() >= INT8_MIN_WEIGHT
        self.levels = levels
        if self.int8:
            q, s = quant_rows(w.float(), levels)
            self.q = q.to(torch.int8)
            self.s = s[:, 0]
        else:
            self.w = w.float()

    def dynamic(self, rows: int) -> bool:
        n, k = self.shape
        return (self.int8 and 2 * rows * k * n >= INT8_MIN_FLOPS
                and n >= INT8_MIN_WIDTH)

    def exact(self, x: torch.Tensor) -> torch.Tensor:
        """The per-row quantized input times the int8 weight, summed
        exactly (float64 holds every sum)."""
        xq, xs = quant_rows(x.float(), self.levels)
        return (xq @ self.q.double().t()).float() * xs * self.s + self.b

    def __call__(self, x: torch.Tensor, rows: int, prec: str
                 ) -> torch.Tensor:
        if self.dynamic(rows):
            return self.exact(x)
        w = self.q.float() * self.s[:, None] if self.int8 else self.w
        return mm(x.float(), w.t(), prec) + self.b


# -- dropout -------------------------------------------------------------
def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    return (al * ml + (((ah * ml + al * mh) & 0xFFFF) << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


class Dropout:
    """The configuration's hash dropout: seeds from a CPU generator, in
    forward order; `scale_dtype` is the dtype 1/keep is rounded to."""

    def __init__(self, seed: int, rate: float, scale_dtype: torch.dtype):
        self.gen = torch.Generator().manual_seed(seed)
        self.rate = rate
        self.thr = min(int(round((1.0 - rate) * 4294967296.0)), MASK32)
        keep = float(self.thr) / 4294967296.0
        self.scale = float(torch.tensor(1.0 / keep, dtype=scale_dtype))

    # the global batch row of x's first row: a block of rows of a site
    # takes the mask of its place in the whole batch's array
    row0 = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        seed = int(torch.randint(-2**31, 2**31 - 1, (), generator=self.gen,
                                 dtype=torch.int64))
        mix = ((seed & MASK32) * 0x9E3779B9) & MASK32
        keep = torch.empty(x.numel(), dtype=torch.bool, device=x.device)
        first = self.row0 * (x.numel() // max(x.shape[0], 1))
        for s in range(0, x.numel(), CHUNK):
            i = torch.arange(first + s, first + min(s + CHUNK, x.numel()),
                             dtype=torch.int64, device=x.device)
            keep[s:s + CHUNK] = fmix32((i & MASK32) ^ mix) < self.thr
        keep = keep.reshape(x.shape)
        return torch.where(keep, x * self.scale, torch.zeros_like(x))


# -- the models ----------------------------------------------------------
def layer_norm(x, p, name, eps=1e-5):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mu * mu, 0.0)
    return ((x - mu) * torch.rsqrt(var + eps) * p[name + ".weight"].float()
            + p[name + ".bias"].float())


class Scorer:
    """The actor (`seq=False`) or a sequence scorer (critic, reward) over
    a dict of float32 tensors, training (`drop` set) or not; `frozen`
    holds the Int8Linear layers of an int8 model."""

    def __init__(self, p: dict, cfg: dict, prec: str, seq: bool,
                 frozen: Optional[dict] = None):
        self.p, self.cfg, self.prec, self.seq = p, cfg, prec, seq
        self.frozen = frozen
        # the int8 routes are chosen on one chip's rows (a dp shard's)
        self.chips = cfg.get("chips", 1)

    def r(self, t):
        return rnd(t, self.prec)

    def rows(self, x) -> int:
        return x.numel() // x.shape[-1] // self.chips

    def linear(self, x, name):
        if self.frozen is not None:
            return self.r(self.frozen[name](x, self.rows(x), self.prec))
        return (mm(x, self.p[name + ".weight"].t(), self.prec)
                + self.p[name + ".bias"])

    def ffn(self, x, fc1, fc2, drop=None):
        rows = self.rows(x)
        if self.frozen is not None and drop is None:
            a, b = self.frozen[fc1], self.frozen[fc2]
            fused = (a.int8 and b.int8 and a.dynamic(rows)
                     and 2 * rows * a.shape[0] * a.shape[1]
                     >= INT8_MIN_FLOPS
                     and 2 * a.shape[0] * a.shape[1]
                     <= FUSED_MAX_WEIGHT_BYTES and rows >= 256)
            if fused:
                return self.r(b.exact(self.r(F.gelu(a.exact(x)))))
        h = self.r(F.gelu(self.linear(x, fc1)))
        if drop is not None:
            h = drop(h)
        return self.linear(h, fc2)

    def xit(self, pre, x, y, drop):
        d, heads = self.cfg["feat_size"], self.cfg["num_heads"]
        dh = d // heads
        a = pre + ".0.0.0.fn."
        q = self.linear(self.r(layer_norm(x, self.p, a + "0.ln_x")),
                        a + "1.queries")
        yn = self.r(layer_norm(y, self.p, a + "0.ln_y"))
        k = self.linear(yn, a + "1.keys")
        v = self.linear(yn, a + "1.values")

        def split(t):
            return t.reshape(*t.shape[:-1], heads, dh).transpose(-3, -2)

        q, k, v = split(q), split(k), split(v)
        # the reference's attention: softmax of unscaled energies, the
        # probabilities divided by sqrt(feat_size); its causal mask is a
        # no-op
        att = self.r(torch.softmax(mm(q, k.transpose(-1, -2), self.prec),
                                   dim=-1)) / math.sqrt(d)
        o = mm(att, v, self.prec).transpose(-3, -2)
        o = self.linear(o.reshape(*o.shape[:-2], d), a + "1.projection")
        x = x + (drop(o) if drop else o)
        f = pre + ".0.0.1.fn."
        h = self.ffn(self.r(layer_norm(x, self.p, f + "0")), f + "1.0",
                     f + "1.3",
                     drop)
        x = x + (drop(h) if drop else h)
        return self.r(layer_norm(x, self.p, pre + ".1.0"))

    def trunk(self, text, img, drop):
        b, t = text.shape[:2]
        tf = self.ffn(text, "text_proj.fc1", "text_proj.fc2")
        imf = self.ffn(img, "img_proj.fc1", "img_proj.fc2")[:, None]
        x = self.xit("xit", tf, imf, drop)
        x = torch.cat([x, imf.expand(b, t, *imf.shape[2:])], dim=2)
        return self.ffn(x.reshape(b, t, -1), "out_layer.fc1",
                        "out_layer.fc2")

    def __call__(self, text, img, index=None, drop=None):
        x = self.trunk(text, img, drop)
        if not self.seq:
            return self.linear(x, "head")[..., 0]
        idx = index.long()[..., None].expand(*index.shape, x.shape[-1])
        x = torch.gather(x, 1, idx)
        x = x + self.p["pos_emb.weight"][:x.shape[1]].float()[None]
        x = self.xit("xitt", x, x, drop)
        return self.linear(x, "head")[:, -1, 0]


def frozen_layers(p: dict, levels: int) -> dict:
    """Int8Linear of every linear of a scorer's float32 dict."""
    return {k[:-len(".weight")]: Int8Linear(v, p[k[:-len(".weight")]
                                                + ".bias"], levels)
            for k, v in p.items()
            if k.endswith(".weight") and v.ndim == 2
            and k != "pos_emb.weight"}


# -- the losses (finetune/ppo.py:38-55, 494-498, 544-553) ----------------
def safe_log(t):
    return torch.log(torch.clamp(t, min=1e-20))


def kl(old, new):
    po, pn = torch.softmax(old, -1), torch.softmax(new, -1)
    return (po * (safe_log(po) - safe_log(pn))).sum(-1)


def entropy(s):
    p = torch.softmax(s, -1)
    return -(p * safe_log(p)).sum(-1)


# -- AdamW (HF AdamW, correct_bias=False; decay after the Adam step) -----
class AdamW:
    def __init__(self, params: dict, base_lr: float, h: dict):
        self.p = params
        self.h = h
        self.base = base_lr
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def lr(self) -> float:
        h = self.h
        n = float(h["train_steps"])
        w = max(int(h["train_steps"] * h["warmup"]), 1)
        s = self.t // h["update_timesteps"]
        return self.base * (s / w if s < w else max(0.0, (n - s)
                                                    / max(1.0, n - w)))

    @torch.no_grad()
    def step(self) -> Dict[str, float]:
        """One update; the gradient norm of every leaf."""
        lr, h = self.lr(), self.h
        self.t += 1
        norms = {}
        for k, p in self.p.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            norms[k] = float(g.double().norm())
            self.m[k].mul_(h["beta1"]).add_(g * (1 - h["beta1"]))
            self.v[k].mul_(h["beta2"]).add_(g * g * (1 - h["beta2"]))
            upd = self.m[k] / (torch.sqrt(self.v[k]) + h["adam_eps"])
            if not k.endswith(".bias"):
                upd = upd + h["weight_decay"] * p
            p.add_(upd * -lr)
            p.grad = None
        return norms


# -- one update, in blocks of rows ----------------------------------------
def _policy_terms(s, old_s, rewards, old_v, nxt, h):
    """Per row: the hinge sum and its count of violating pairs, |adv|, the
    entropy, and the KL-shifted reward."""
    rew_s = rewards - h["kl_div_loss_weight"] * kl(old_s, s)
    adv = rew_s - old_v
    tail = nxt[:, -2:]
    order = torch.where((adv < h["advantage_eps"])[:, None], tail.flip(1),
                        tail)
    g = torch.gather(s, 1, order.long())
    diff = h["rank_margin"] - (g[:, :, None] - g[:, None, :])
    hinge = torch.relu(torch.triu(diff, diagonal=1)).sum((1, 2))
    cnt = torch.sign(torch.relu(torch.triu(diff, diagonal=1))).sum((1, 2))
    return hinge, cnt.detach(), adv.abs(), entropy(s), rew_s


def update(mem, actor, critic, h, prec, drop):
    """The gradients of one update's policy and value losses on the
    actor's and the critic's leaves, computed over blocks of
    h["chunk_rows"] rows so that a global batch fits; (policy loss, value
    loss). RankLoss's mean over the batch's violating pairs and the mean
    |advantage| are global: a pass without gradients takes them first, and
    each block's loss is the part of the batch's loss it contributes,
    whose gradients add up to the whole batch's. Every pass over the
    blocks draws one site's dropout seed once, at each block's place."""
    text, img, state, nxt, old_s, rewards, old_v = mem
    b = text.shape[0]
    step = h.get("chunk_rows", b)
    blocks = [(r, min(r + step, b)) for r in range(0, b, step)]
    scorer = Scorer(actor, h, prec, False)

    def actor_block(r0, r1, start):
        drop.gen.set_state(start)
        drop.row0 = r0
        s = scorer(text[r0:r1], img[r0:r1], drop=drop)
        return _policy_terms(s, old_s[r0:r1], rewards[r0:r1], old_v[r0:r1],
                             nxt[r0:r1], h)

    start = drop.gen.get_state()
    with torch.no_grad():
        parts = [actor_block(r0, r1, start) for r0, r1 in blocks]
    hinge = sum(p[0].sum() for p in parts)
    cnt = torch.clamp(sum(p[1].sum() for p in parts), min=1.0)
    mean_adv = sum(p[2].sum() for p in parts) / b
    ent = sum(p[3].sum() for p in parts) / b
    rew_s = torch.cat([p[4] for p in parts])
    rank = hinge / cnt
    ew = h["entropy_weight"]
    for r0, r1 in blocks:
        hb, _c, ab, eb, _r = actor_block(r0, r1, start)
        (hb.sum() / cnt * mean_adv + rank * ab.sum() / b
         - ew * eb.sum() / b).backward()
    start = drop.gen.get_state()
    critic_scorer = Scorer(critic, h, prec, True)
    vloss = 0.0
    for r0, r1 in blocks:
        drop.gen.set_state(start)
        drop.row0 = r0
        v = critic_scorer(text[r0:r1], img[r0:r1], state[r0:r1], drop=drop)
        clipped = old_v[r0:r1] + torch.clamp(v - old_v[r0:r1],
                                             -h["value_clip"],
                                             h["value_clip"])
        part = torch.maximum((clipped - rew_s[r0:r1]) ** 2,
                             (v - rew_s[r0:r1]) ** 2).sum() / b
        part.backward()
        vloss += float(part.detach())
    drop.row0 = 0
    return float(rank * mean_adv - ew * ent), vloss


# -- following the program's first sweeps --------------------------------
def follow(actor_w: dict, reward_w: dict, batches: List[dict], h: dict,
           prec: str = "float32", actions: Optional[list] = None) -> dict:
    """The first sweeps of the stage-3 fit, from float32 weights (the
    actor's and the stage-2 reward model's, which also starts the critic)
    and the rollouts' batches (text, img, float32, on the device). `h`
    holds the hyperparameters; `actions` the program's next_state of each
    rollout, which this follows where given (the judge reads the gap
    between them and the reference's own order). Returns the observations
    the judge compares."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    levels = 7 if prec == "fp8" else 127
    scale_dtype = getattr(torch, h["compute_dtype"])
    actor = {k: v.detach().clone().float().requires_grad_(True)
             for k, v in actor_w.items()}
    critic = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in reward_w.items()}
    reward = Scorer({k: v.float() for k, v in reward_w.items()}, h, prec,
                    True, frozen_layers(reward_w, levels))
    opt_a = AdamW(actor, h["learning_rate"], h)
    opt_c = AdamW(critic, h["critic_learning_rate"], h)
    drop = Dropout(h["seed"] + 2, h["drop_p"], scale_dtype)
    upd = h["update_timesteps"]
    obs = {"scores": [], "value": [], "reward": [], "next_state": [],
           "policy_loss": [], "value_loss": [], "g1": {}, "order_gap": []}
    memories = []
    twin = None
    for r, batch in enumerate(batches):
        text, img = batch["text"], batch["img"]
        b, t = text.shape[:2]
        state = torch.arange(t, device=text.device).expand(b, t)
        with torch.no_grad():
            if twin is None:            # requantized once a sweep
                twin = Scorer({k: v.detach() for k, v in actor.items()}, h,
                              prec, False, frozen_layers(
                                  {k: v.detach() for k, v in actor.items()},
                                  levels))
            scores = twin(text, img)
            value = Scorer(critic, h, prec, True)(text, img, state)
            own = torch.argsort(-scores, dim=-1, stable=True)
            if actions is not None:
                nxt = actions[r].to(text.device).long()
                chosen = nxt[:, 2:]
                best = torch.gather(scores, 1, own[:, :1])[:, 0]
                first = torch.gather(scores, 1, chosen[:, :1])[:, 0]
                obs["order_gap"].append(best - first)
            else:
                permuted = torch.gather(state, 1, own)
                nxt = torch.cat([torch.arange(2, device=text.device)[None]
                                 .expand(b, 2), permuted], 1)
            rew = reward(text, img, nxt)
        for k, v in (("scores", scores), ("value", value), ("reward", rew),
                     ("next_state", nxt)):
            obs[k].append(v.detach())
        memories.append((text, img, state, nxt, scores, rew, value))
        if (r + 1) % upd:
            continue
        twin = None
        for mem in memories:
            ploss, vloss = update(mem, actor, critic, h, prec, drop)
            obs["g1"].setdefault("actor", opt_a.step())
            obs["g1"].setdefault("critic", opt_c.step())
            obs["policy_loss"].append(ploss)
            obs["value_loss"].append(vloss)
        memories = []
    obs["change"] = {
        "actor": {k: float((actor[k].detach() - actor_w[k].float())
                           .double().norm()) for k in actor},
        "critic": {k: float((critic[k].detach() - reward_w[k].float())
                            .double().norm()) for k in critic}}
    return obs
