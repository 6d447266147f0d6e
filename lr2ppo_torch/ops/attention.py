"""Fused attention for the tower encoders: softmax(Q K^T * scale + key_bias) V
in one kernel (counterpart of lr2ppo_tpu/ops/pallas_attention.py).

Two parts:
  * `fused_attention`, the wrapper: a CUDA tensor launches the hand-written
    kernel (kernels/csrc/fused_attention.cu) and a CPU tensor takes the
    plain version. The kernel has two paths: the short one for S <= 256
    (both tower shapes), whole score rows in registers, and the long one
    for longer sequences, score rows in shared memory;
  * `reference_attention`, the plain PyTorch version of the same arithmetic.

q, k and v are (B, H, S, dh), float32 or bfloat16; key_bias is (B, S)
float32, the additive 0 / -10000 mask over keys. The scores and the softmax
are float32, the normalized probabilities are rounded to v's dtype before
the PV product, which accumulates in float32, and the output is in q's
dtype: the TPU kernel's body (`_attn_kernel`) operation for operation.

Inference only, as in JAX (no custom_vjp there, and the encoder's gate
requires a deterministic pass): the wrapper raises where autograd would
need a backward.
"""

from __future__ import annotations

import torch

from lr2ppo_torch.kernels import build

MAX_HEAD_DIM = 128
# the C entry's codes for the kernel's paths (0: the shape is refused)
PATHS = {1: "short", 2: "long"}


def reference_attention(q, k, v, key_bias, scale: float) -> torch.Tensor:
    """The plain version (pallas_attention.py:reference_attention): float32
    scores, times `scale`, plus the key bias, softmax, probabilities cast to
    v's dtype, the PV product accumulated in float32, the result cast to q's
    dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * scale + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def _check(q, k, v, key_bias) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q, k, v must share one (B, H, S, "
                         f"dh) shape, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"fused_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, s, dh = q.shape
    if key_bias.dtype != torch.float32 or tuple(key_bias.shape) != (b, s):
        raise ValueError(f"fused_attention: key_bias must be float32 "
                         f"{(b, s)}, got {key_bias.dtype} "
                         f"{tuple(key_bias.shape)}")
    if any(t.device != q.device for t in (k, v, key_bias)):
        raise ValueError("fused_attention: inputs on different devices")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {dh} above the "
                         f"kernel's {MAX_HEAD_DIM}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, key_bias)):
        raise RuntimeError("fused_attention is inference-only, as the TPU "
                           "kernel is: call it under torch.no_grad() or "
                           "torch.inference_mode()")


def _last_dim_unit(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def fused_attention(q, k, v, key_bias, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + key_bias[:, None, None, :]) v, (B, H, S, dh)
    in q's dtype.

    q, k and v may be strided views (the encoder passes (B, S, H, dh)
    tensors transposed); the kernel reads them through their strides. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, and
    anything else raises, as does a sequence too long for the kernel's
    score block. `fused_attention.launches` counts kernel launches and
    `fused_attention.path_launches` counts them by path ("short", "long")."""
    _check(q, k, v, key_bias)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, key_bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    b, h, s, dh = q.shape
    q, k, v = (_last_dim_unit(t) for t in (q, k, v))
    key_bias = key_bias.contiguous()
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    lib = build.library("fused_attention")
    code = build.DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        path = PATHS.get(lib.lr2ppo_fused_attention_path(s, dh, code))
        if path is None:
            raise ValueError(
                f"fused_attention: sequence {s} at head dim {dh} does not "
                "fit the kernel's float32 score block in shared memory")
        err = lib.lr2ppo_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
            out.data_ptr(), b, h, s, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), code, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "fused_attention launch")
    fused_attention.launches += 1
    fused_attention.path_launches[path] += 1
    return out


def reset_launches() -> None:
    """Set the launch counts, in total and by path, to 0."""
    fused_attention.launches = 0
    fused_attention.path_launches = dict.fromkeys(PATHS.values(), 0)


reset_launches()
