"""Causal attention of multi-head latent attention (towers/mla.py), forward
and backward, in hand-written kernels for Hopper: the forward in Triton,
the backward in CUDA C++ (kernels/csrc/mla_attention_bwd.cu).

The kernels replace no TPU kernel: the JAX package has no latent attention
and no causal sequence beyond 512 tokens, and the towers' plain attention
(towers/layers.py) builds float32 (B, h, S, S) scores, 4.3 GB a sequence a
layer at 8,192 tokens and 16 heads. Here q and k are Dqk = 192 wide (the
128-wide no-position part and the 64-wide rotary part of MLA), v and the
output Dv = 128, all bfloat16; the softmax statistics are float32.

What bounds it: causal attention at S = 8,192 does S²/2 x (Dqk + Dv) x 2
operations a head forward, 2.4 x that backward, and reads each of q, k, v
once a tile, so it is bound by the tensor cores (about 2,700 operations a
byte at S = 8,192, against the card's ~295). The forward keeps every score
and probability in registers (FlashAttention-2's online softmax): a block of
query rows walks the key blocks up to the diagonal, holding its float32 sum
of P·V, the row maximum and the row sum, and writes the output and each
row's log-sum-exp once; no S x S tensor exists. The 192-wide products are
two products over the 128- and 64-wide parts (Triton takes power-of-two
tiles), so no lane is padded. The backward recomputes the probabilities
from the saved log-sum-exp once: a block holds 128 keys' dK and dV in
registers, walks the query tiles from the diagonal with wgmma on TMA-fed
tiles, and adds each tile's dQ into a float32 accumulator; a pre-pass
writes delta = rowsum(dO * O) and a last pass dQ in bfloat16 (the source
says how).

Two parts:
  * `mla_attention`, the entry: a CPU tensor takes the plain version, a
    CUDA tensor the kernels (through an autograd Function whose backward
    launches the backward kernels) or raises;
  * `reference_mla_attention`, the plain PyTorch version: float32 scores,
    the causal mask, softmax, the probabilities rounded to v's dtype, the
    P·V product in float32, the result in q's dtype.

`mla_attention.launches` counts kernel launches, `kernel_calls` the entry's
calls that took the kernels ({"fwd", "bwd"}) and `plain_calls` those that
took the plain version. Triton is imported when the forward is first built
and the CUDA library loaded at the first backward, never when this module
is imported.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from lr2ppo_torch.kernels import build
from lr2ppo_torch.utils import span

# (query, key) tile heights of the forward: the fastest of those timed at
# (8, 16, 8,192) on an H100 (PERF.md §6)
FWD_BLOCK = (128, 128)
LOG2E = 1.4426950408889634
# bound by _kernels() at the first build
triton = tl = None


def reference_mla_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain version: q, k (B, H, S, Dqk), v (B, H, S, Dv); causal
    softmax(q kᵀ · scale) v with float32 scores, the probabilities rounded
    to v's dtype, the product accumulated in float32, cast to q's dtype."""
    s = q.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"mla_attention: q, k (B, H, S, Dqk) and v (B, H, S,"
                         f" Dv) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != 192 or v.shape[-1] != 128:
        raise ValueError(f"mla_attention: the kernel takes Dqk 192 and Dv "
                         f"128, got {q.shape[-1]} and {v.shape[-1]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"mla_attention: the kernel takes bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("mla_attention: the last dim must be contiguous")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("mla_attention: inputs on different devices")


@lru_cache(maxsize=None)
def _kernels():
    """The Triton forward kernel, built at first use."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def fwd(Q, K, V, O, L, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs,
            sob, soh, sos, H, S, qk_scale,
            BM: tl.constexpr, BN: tl.constexpr, DA: tl.constexpr,
            DB: tl.constexpr, DV: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1)
        b = bh // H
        h = bh % H
        rows = pid_m * BM + tl.arange(0, BM)
        da = tl.arange(0, DA)
        db = tl.arange(0, DB)
        dv = tl.arange(0, DV)
        row_ok = rows[:, None] < S
        q_ptr = Q + b * sqb + h * sqh + rows[:, None] * sqs
        qa = tl.load(q_ptr + da[None, :], mask=row_ok, other=0.0)
        qb = tl.load(q_ptr + DA + db[None, :], mask=row_ok, other=0.0)
        k_ptr = K + b * skb + h * skh
        v_ptr = V + b * svb + h * svh
        m_i = tl.full([BM], float("-inf"), tl.float32)
        l_i = tl.zeros([BM], tl.float32)
        acc = tl.zeros([BM, DV], tl.float32)
        hi = tl.minimum((pid_m + 1) * BM, S)
        for start in range(0, hi, BN):
            cols = start + tl.arange(0, BN)
            col_ok = cols[:, None] < S
            ka = tl.load(k_ptr + cols[:, None] * sks + da[None, :],
                         mask=col_ok, other=0.0)
            kb = tl.load(k_ptr + cols[:, None] * sks + DA + db[None, :],
                         mask=col_ok, other=0.0)
            s = tl.dot(qa, tl.trans(ka)) + tl.dot(qb, tl.trans(kb))
            s = s * qk_scale
            keep = (rows[:, None] >= cols[None, :]) & (cols[None, :] < S)
            s = tl.where(keep, s, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(s, 1))
            p = tl.exp2(s - m_new[:, None])
            alpha = tl.exp2(m_i - m_new)
            l_i = l_i * alpha + tl.sum(p, 1)
            vt = tl.load(v_ptr + cols[:, None] * svs + dv[None, :],
                         mask=col_ok, other=0.0)
            acc = acc * alpha[:, None] + tl.dot(p.to(vt.dtype), vt)
            m_i = m_new
        acc = acc / l_i[:, None]
        o_ptr = O + b * sob + h * soh + rows[:, None] * sos + dv[None, :]
        tl.store(o_ptr, acc.to(O.dtype.element_ty), mask=row_ok)
        # the log-sum-exp of the scaled scores, in log2 units
        tl.store(L + bh * S + rows, m_i + tl.log2(l_i), mask=rows < S)

    return (fwd,)


def _strides(t: torch.Tensor) -> tuple:
    return t.stride(0), t.stride(1), t.stride(2)


def _heads_last(b: int, h: int, s: int, d: int, like: torch.Tensor
                ) -> torch.Tensor:
    """An empty (B, H, S, d) tensor laid out (B, S, H, d), so the caller's
    transpose back to (B, S, H·d) is a view."""
    return torch.empty(b, s, h, d, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch_fwd(q, k, v, scale: float):
    """(out (B, H, S, Dv), log-sum-exp (B, H, S) float32, log2 units)."""
    fwd = _kernels()[0]
    b, h, s, _ = q.shape
    o = _heads_last(b, h, s, v.shape[-1], q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    bm, bn = FWD_BLOCK
    fwd[(triton.cdiv(s, bm), b * h)](
        q, k, v, o, lse, *_strides(q), *_strides(k), *_strides(v),
        *_strides(o), h, s, scale * LOG2E, BM=bm, BN=bn, DA=128, DB=64,
        DV=128, num_warps=8, num_stages=2)
    mla_attention.launches += 1
    return o, lse


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where TMA cannot read it: every stride a
    multiple of 8 elements (16 bytes) and the base 16-byte aligned."""
    if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) \
            or t.stride(-1) != 1:
        return t.contiguous()
    return t


def _tma_strides(t: torch.Tensor) -> tuple:
    """(batch, head, row) strides of a (B, H, S, d) tensor; a dim of size 1
    takes the next outer extent's, so TMA sees a valid stride."""
    st = list(t.stride()[:3])
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = max(s * n for s, n in zip(t.stride(), t.shape))
    return tuple(st)


def _launch_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv), each laid out as _heads_last: the three launches of
    kernels/csrc/mla_attention_bwd.cu on the current stream."""
    fn = build.function("lr2ppo_mla_attention_bwd")
    q, k, v, o, do = (_tma_ready(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    b, h, s, _ = q.shape
    dq = _heads_last(b, h, s, q.shape[-1], q)
    dk = _heads_last(b, h, s, k.shape[-1], k)
    dv = _heads_last(b, h, s, v.shape[-1], v)
    scratch = torch.empty(
        build.function("lr2ppo_mla_attention_bwd_scratch")(b, h, s),
        dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(x for t in (q, k, v, o, do, dq, dk, dv) for x in _tma_strides(t)))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, h, s,
             strides, scale * LOG2E, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library_of("lr2ppo_mla_attention_bwd"), err,
                "mla_attention backward")
    mla_attention.launches += 3
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        with span("attn.kernel_fwd"):
            o, lse = _launch_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        mla_attention.kernel_calls["fwd"] += 1
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with span("attn.kernel_bwd"):
            dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, ctx.scale)
        mla_attention.kernel_calls["bwd"] += 1
        return dq, dk, dv, None


def mla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float = None) -> torch.Tensor:
    """Causal attention: q, k (B, H, S, Dqk), v (B, H, S, Dv), any strides
    with the last dim contiguous; the output (B, H, S, Dv). `scale`
    defaults to 1/sqrt(Dqk). A CPU tensor takes the plain version; a CUDA
    tensor the kernels, forward and backward, or raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        mla_attention.plain_calls += 1
        return reference_mla_attention(q, k, v, scale)
    _check(q, k, v)
    return _CausalAttention.apply(q, k, v, float(scale))


mla_attention.launches = 0
mla_attention.kernel_calls = {"fwd": 0, "bwd": 0}
mla_attention.plain_calls = 0
