"""Narrow-output int8 GEMM with per-row dynamic quantization of x
(counterpart of lr2ppo_tpu/ops/pallas_int8_matmul.py, K2).

Its parts:
  * `int8_matmul`, the wrapper: a CUDA tensor launches the hand-written
    kernel (kernels/csrc/int8_matmul.cu) and a CPU tensor takes the plain
    version;
  * `int8_matmul_reference`, the plain PyTorch version of the same
    arithmetic, which is also ops/int8.py:int8_linear's s8 route;
  * `supported`, the JAX package's shape gate, with the same constants;
  * the tp entry, for a row-split (K over tp) site: `int8_dot_s32` (the
    exact int32 product of int8 rows and the rank's weight columns) and
    `s32_epilogue` (K2's rescale), each a kernel of the same source beside
    its plain version, and `int8_matmul_tp`, which sums the int32 parts
    over tp between the two. Integer sums do not depend on their order,
    so the result is K2's on the global arrays, bit for bit, as JAX
    computes it (a pallas_call has no partitioning rule, so XLA runs
    pallas_int8_matmul on the gathered operands).

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


def int8_dot_s32_reference(xq, w):
    """The plain version of the tp entry's product: (rows, K) s8 . (N, K)^T
    s8 as exact int32 sums (float64 holds each one exactly)."""
    return (xq.double() @ w.double().t()).to(torch.int32)


def s32_epilogue_reference(acc, xs, w_scale, out_dtype=torch.bfloat16):
    """The plain version of the tp entry's epilogue: (acc * xs) * w_scale
    rounded once to `out_dtype`, int8_matmul_reference's order."""
    return (acc.float() * xs * w_scale.float()).to(out_dtype)


def _check_aligned(name, t):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def int8_dot_s32(xq, w) -> torch.Tensor:
    """(rows, K) int8 . (N, K)^T int8 -> (rows, N) int32, exact. A CPU
    tensor takes the plain version, a CUDA tensor launches the kernel
    (`int8_dot_s32.launches` counts them), anything else raises. Takes the
    shapes `supported` admits for (xq, w)."""
    if xq.dtype != torch.int8 or w.dtype != torch.int8 or xq.ndim != 2:
        raise ValueError(f"int8_dot_s32: needs 2-D int8 operands, got "
                         f"{xq.dtype} {tuple(xq.shape)}, {w.dtype}")
    if not supported(xq.shape, w.shape) or w.device != xq.device:
        raise ValueError(f"int8_dot_s32: unsupported shapes xq "
                         f"{tuple(xq.shape)}, w {tuple(w.shape)} or devices")
    if xq.device.type == "cpu":
        return int8_dot_s32_reference(xq, w)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_dot_s32: no kernel for device {xq.device}")
    _check_aligned("int8_dot_s32: xq", xq)
    _check_aligned("int8_dot_s32: w", w)
    (rows, k), n = xq.shape, w.shape[0]
    acc = torch.empty(rows, n, dtype=torch.int32, device=xq.device)
    lib = build.library("int8_matmul")
    with torch.cuda.device(xq.device):
        err = lib.lr2ppo_int8_dot_s32(
            xq.data_ptr(), w.data_ptr(), acc.data_ptr(), rows, k, n,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "int8_dot_s32 launch")
    int8_dot_s32.launches += 1
    return acc


int8_dot_s32.launches = 0


def s32_epilogue(acc, xs, w_scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(acc * xs) * w_scale rounded once to `out_dtype`: acc (rows, N)
    int32, xs (rows, 1) and w_scale (N,) float32. A CPU tensor takes the
    plain version, a CUDA tensor launches the kernel
    (`s32_epilogue.launches`), anything else raises."""
    rows, n = acc.shape
    if (acc.dtype != torch.int32 or out_dtype not in build.DTYPE_CODES
            or xs.dtype != torch.float32 or xs.numel() != rows
            or w_scale.dtype != torch.float32 or w_scale.shape != (n,)
            or n % 4):
        raise ValueError(f"s32_epilogue: needs int32 (rows, N) with N % 4 "
                         f"== 0, float32 (rows, 1) and (N,) scales and a "
                         f"float32 or bfloat16 out, got {acc.dtype} "
                         f"{tuple(acc.shape)}, {xs.dtype} "
                         f"{tuple(xs.shape)}, {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}, {out_dtype}")
    if acc.device.type == "cpu":
        return s32_epilogue_reference(acc, xs, w_scale, out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"s32_epilogue: no kernel for device {acc.device}")
    for name, t in (("acc", acc), ("xs", xs), ("w_scale", w_scale)):
        _check_aligned(f"s32_epilogue: {name}", t)
    y = torch.empty(rows, n, dtype=out_dtype, device=acc.device)
    lib = build.library("int8_matmul")
    with torch.cuda.device(acc.device):
        err = lib.lr2ppo_int8_s32_epilogue(
            acc.data_ptr(), xs.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
            rows, n, build.DTYPE_CODES[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "s32_epilogue launch")
    s32_epilogue.launches += 1
    return y


s32_epilogue.launches = 0


def int8_matmul_tp(x, w, w_scale, out_dtype, mesh) -> torch.Tensor:
    """K2 on the global arrays from a row split: x (..., K/tp) holds this
    tp rank's columns of each row and w (N, K/tp) its columns of the
    weight. The rows are quantized with their amax over tp, the int32
    parts summed over tp (an exact all-reduce, forward only: the frozen
    reward and the rollout twin take no gradient through it), then
    rescaled once. Every tp rank gets the whole (..., N) product."""
    from lr2ppo_torch.parallel.tp import tp_sum_int

    *lead, k = x.shape
    xq, xs = quantize_rows(x.reshape(-1, k).float(), mesh)
    acc = tp_sum_int(int8_dot_s32(xq, w), mesh)
    y = s32_epilogue(acc, xs, w_scale.float(), out_dtype)
    return y.reshape(*lead, w.shape[0])
