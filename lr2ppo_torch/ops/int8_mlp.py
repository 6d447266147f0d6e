"""Fused int8 FFN: quant -> s8 fc1 -> GELU -> quant -> s8 fc2 in one kernel
(counterpart of lr2ppo_tpu/ops/pallas_int8_mlp.py).

Three parts:
  * `int8_mlp`, the wrapper: a CUDA tensor launches the hand-written kernel
    (kernels/csrc/int8_mlp.cu) and a CPU tensor takes the plain version;
  * `int8_mlp_reference`, the plain PyTorch version of the same arithmetic;
  * `supported`, the JAX package's shape gate, with the same constants.

Weights are in torch's (out, in) layout: w1 (H, D), w2 (D, H), int8, with
float32 per-output-channel scales s1 (H,), s2 (D,) and float32 biases.
"""

from __future__ import annotations

import math

import torch

from lr2ppo_torch.kernels import build
from lr2ppo_torch.ops.int8 import int_dot, quantize_rows

_BM = 256                       # the TPU kernel's row block: the row gate
_MAX_WEIGHT_VMEM = 6 * 1024 * 1024

# XLA's f32 erf polynomial (pallas_int8_mlp.py:_ERF_ALPHA/_ERF_BETA), which
# the kernel carries too: libdevice's erff differs by ulps and flips
# quantization ties.
_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08,
              -2.10102402082508e-06, -5.69250639462346e-05,
              -7.34990630326855e-04, -2.95459980854025e-03,
              -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04,
             -1.68282697438203e-03, -7.37332916720468e-03,
             -1.42647390514189e-02)


def supported(x_shape, w1_shape, w2_shape) -> bool:
    """Shapes the fused FFN takes: lr2ppo_tpu/ops/pallas_int8_mlp.py:supported
    with the weights in (out, in) layout, w1 (H, D) and w2 (D, H)."""
    hdn, d = w1_shape
    rows = math.prod(x_shape[:-1])
    return (x_shape[-1] == d
            and tuple(w2_shape) == (d, hdn)
            and d % 128 == 0 and hdn % 128 == 0
            and 2 * d * hdn <= _MAX_WEIGHT_VMEM
            and rows >= _BM)


def _poly(coefs, x):
    acc = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        acc = acc * x + c
    return acc


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """0.5 * x * (1 + erf(x / sqrt(2))) in float32 with XLA's erf."""
    xe = (x * (1.0 / math.sqrt(2.0))).clamp(-4.0, 4.0)
    x2 = xe * xe
    erf = xe * _poly(_ERF_ALPHA, x2) / _poly(_ERF_BETA, x2)
    return 0.5 * x * (1.0 + erf)


def int8_mlp_reference(x, w1, s1, b1, w2, s2, b2,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: the same operations in the same order as the
    kernel and as the TPU kernel's body."""
    *lead, d = x.shape
    xq, xs = quantize_rows(x.reshape(-1, d).float())
    h = int_dot(xq, w1) * xs * s1.float() + b1.float()
    # the unfused path materializes gelu(fc1) in out_dtype before fc2's
    # quantization reads it
    h = gelu_poly(h).to(out_dtype).float()
    hq, hs = quantize_rows(h)
    y = int_dot(hq, w2) * hs * s2.float() + b2.float()
    return y.to(out_dtype).reshape(*lead, d)


def _check(x, w1, s1, b1, w2, s2, b2, out_dtype):
    if out_dtype not in build.DTYPE_CODES:
        raise ValueError(f"int8_mlp: out_dtype {out_dtype} is not float32 "
                         "or bfloat16")
    if x.dtype != out_dtype:
        raise ValueError(f"int8_mlp: x is {x.dtype}, the fused FFN takes x "
                         f"in out_dtype {out_dtype}")
    hdn, d = w1.shape
    if not supported(x.shape, w1.shape, w2.shape):
        raise ValueError(f"int8_mlp: unsupported shapes x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    for name, t, dtype, shape in (
            ("w1", w1, torch.int8, (hdn, d)), ("w2", w2, torch.int8, (d, hdn)),
            ("s1", s1, torch.float32, (hdn,)), ("b1", b1, torch.float32, (hdn,)),
            ("s2", s2, torch.float32, (d,)), ("b2", b2, torch.float32, (d,))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8_mlp: {name} must be {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_mlp: {name} must be contiguous")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("int8_mlp: weights must be 16-byte aligned")


def int8_mlp(x, w1, s1, b1, w2, s2, b2,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = gelu(x @ w1.T * s1 + b1) @ w2.T * s2 + b2 with per-row dynamic
    int8 quantization before each product; (..., D) in `out_dtype`.

    x must already be in `out_dtype`, as the model layers pass it. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, and
    anything else raises. `int8_mlp.launches` counts kernel launches."""
    _check(x, w1, s1, b1, w2, s2, b2, out_dtype)
    if x.device.type == "cpu":
        return int8_mlp_reference(x, w1, s1, b1, w2, s2, b2, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_mlp: no kernel for device {x.device}")
    *lead, d = x.shape
    hdn = w1.shape[0]
    x2 = x.reshape(-1, d).contiguous()
    if x2.data_ptr() % 16:               # the kernel reads x in 16 bytes
        x2 = x2.clone()
    y = torch.empty_like(x2)
    lib = build.library("int8_mlp")
    code = build.DTYPE_CODES[out_dtype]
    with torch.cuda.device(x.device):
        # each resident block keeps its tile's int8 x rows and its hidden
        # rows (in out_dtype, then in int8) in a slice of this scratch
        nbytes = lib.lr2ppo_int8_mlp_scratch_bytes(x2.shape[0], d, hdn, code)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        err = lib.lr2ppo_int8_mlp(
            x2.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            x2.shape[0], d, hdn, code, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "int8_mlp launch")
    int8_mlp.launches += 1
    return y.reshape(*lead, d)


int8_mlp.launches = 0
