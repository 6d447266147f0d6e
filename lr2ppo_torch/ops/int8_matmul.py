"""Narrow-output int8 GEMM with per-row dynamic quantization of x
(counterpart of lr2ppo_tpu/ops/pallas_int8_matmul.py, K2).

Three parts:
  * `int8_matmul`, the wrapper: a CUDA tensor launches the hand-written
    kernel (kernels/csrc/int8_matmul.cu) and a CPU tensor takes the plain
    version;
  * `int8_matmul_reference`, the plain PyTorch version of the same
    arithmetic, which is also ops/int8.py:int8_linear's s8 route;
  * `supported`, the JAX package's shape gate, with the same constants.

The weight is in torch's (out, in) layout: (N, K) int8 with a float32 scale
per output channel, (N,). ops/int8.py:int8_linear routes narrow
compute-bound call sites here when NARROW_SITES is on.
"""

from __future__ import annotations

import math

import torch

from lr2ppo_torch.kernels import build
from lr2ppo_torch.ops.int8 import int_dot, quantize_rows

_BM = 512                       # the TPU kernel's row block: the row gate
_MAX_WEIGHT_VMEM = 6 * 1024 * 1024


def supported(x_shape, w_shape) -> bool:
    """Shapes the kernel takes: lr2ppo_tpu/ops/pallas_int8_matmul.py:supported
    with the weight in (out, in) layout, (N, K)."""
    n, k = w_shape
    rows = math.prod(x_shape[:-1])
    return (x_shape[-1] == k
            and k % 128 == 0 and n % 128 == 0
            and k * n <= _MAX_WEIGHT_VMEM
            and rows >= _BM)


def int8_matmul_reference(x, w, w_scale, out_dtype=torch.bfloat16):
    """The plain version: x quantized per row, the exact integer product,
    then (acc * sx) * sw rounded once to `out_dtype`."""
    *lead, k = x.shape
    xq, xs = quantize_rows(x.reshape(-1, k).float())
    y = int_dot(xq, w) * xs * w_scale.float()
    return y.to(out_dtype).reshape(*lead, w.shape[0])


def _check(x, w, w_scale, out_dtype):
    for name, dt in (("x", x.dtype), ("out_dtype", out_dtype)):
        if dt not in build.DTYPE_CODES:
            raise ValueError(f"int8_matmul: {name} is {dt}, not float32 or "
                             "bfloat16")
    if not supported(x.shape, w.shape):
        raise ValueError(f"int8_matmul: unsupported shapes x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    n = w.shape[0]
    for name, t, dtype, shape in (("w", w, torch.int8, tuple(w.shape)),
                                  ("w_scale", w_scale, torch.float32, (n,))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8_matmul: {name} must be {dtype} {shape} "
                             f"on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError("int8_matmul: the weight must be 16-byte aligned")


def int8_matmul(x, w, w_scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = q(x) @ w.T * sx * w_scale with per-row dynamic int8 quantization
    of x; (..., K) float32 or bfloat16 in, (..., N) in `out_dtype` out.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    and anything else raises. `int8_matmul.launches` counts kernel
    launches."""
    _check(x, w, w_scale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w, w_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    *lead, k = x.shape
    n = w.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()         # a view at an odd offset: the kernel loads
                                # 16 bytes at a time
    y = torch.empty(x2.shape[0], n, dtype=out_dtype, device=x.device)
    lib = build.library("int8_matmul")
    with torch.cuda.device(x.device):
        # each resident block quantizes its tile's rows of x into a slice
        # of this scratch, which the kernel's TMA loads read back
        nbytes = lib.lr2ppo_int8_matmul_scratch_bytes(x2.shape[0], k)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        err = lib.lr2ppo_int8_matmul(
            x2.data_ptr(), w.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
            x2.shape[0], k, n, build.DTYPE_CODES[x.dtype],
            build.DTYPE_CODES[out_dtype], scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "int8_matmul launch")
    int8_matmul.launches += 1
    return y.reshape(*lead, n)


int8_matmul.launches = 0
