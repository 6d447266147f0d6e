"""Int8 weight quantization for frozen inference models (counterpart of
lr2ppo_tpu/ops/int8.py).

Weights are quantized once at load, per output channel; activations per row
at run time; both symmetric, round half to even, clip to +-127. Weights keep
torch's (out, in) layout, so the per-output-channel amax runs over dim 1
where the JAX package takes it over axis 0 of its (in, out) kernels.

The size gates, their constants and their order are the JAX package's, so
both packages take the same route at the same shapes. Tests monkeypatch
them to 0 to force quantization on tiny models.
"""

from __future__ import annotations

import torch

INT8_MIN_KERNEL_ELEMENTS = 2 * 1024 * 1024
INT8_DYNQUANT_MIN_FLOPS = 50e9
INT8_DYNQUANT_MIN_WIDTH = 1024

# Route deterministic int8 FFNs through the fused kernel (ops/int8_mlp.py).
# In JAX this is off in multi-device programs, where a pallas_call has no
# partitioning rule; in the port each rank is one device, so it is on, and
# models/layers.py:fused_int8_ffn_ok keeps it off under tp. Tests set it.
FUSED_FFN = True

# Route narrow compute-bound call sites (fc2-style, N < 1024) through the
# narrow int8 GEMM (ops/int8_matmul.py, K2). Off by default, as in JAX
# (lr2ppo_tpu/ops/int8.py:56-66): the TPU kernel won 1.45x in isolation at
# the flagship fc2 but lost in the whole rollout (974.4 against 1000.7
# samples/s), because its call boundary makes the gelu(fc1) input (~600 MB
# at 100,352 rows) go through HBM where XLA fuses it into the bf16 product.
# Both packages take the same route at the same shapes. Tests set it.
NARROW_SITES = False


def should_quantize(shape) -> bool:
    """True when a 2-D weight of this shape is worth storing as int8."""
    return len(shape) == 2 and shape[0] * shape[1] >= INT8_MIN_KERNEL_ELEMENTS


def quantize_rows(xf: torch.Tensor, amax_mesh=None):
    """Per-row dynamic quantization of a float32 tensor over its last dim:
    (int8 values, float32 scale with a trailing 1). The scale is a true
    division by 127: amax * (1/127) differs in the last bit and moves
    round-ties a whole step. The divisor is a tensor because PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal. With
    `amax_mesh`, xf holds a tp part of each row and the amax is the max
    over tp."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if amax_mesh is not None:
        from lr2ppo_torch.parallel.tp import tp_max

        amax = tp_max(amax, amax_mesh)
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def int_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s8 (rows, K) . s8 (N, K)^T as exact integer sums, as float32 rounded
    from the integer like an int32 -> float32 cast. float64 holds every sum
    exactly: 127 * 127 * K < 2**53."""
    return (q.double() @ w.double().t()).float()


def quantize_weight(w: torch.Tensor):
    """(out, in) float weight -> (int8 weight, float32 per-out-channel scale);
    the int8 weight is row-major, as the fused kernel reads it."""
    q, scale = quantize_rows(w.float())
    return q.contiguous(), scale[:, 0]


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                weight_scale: torch.Tensor, out_dtype=None, shape=None,
                mesh=None) -> torch.Tensor:
    """y = x @ weight.T with the JAX package's routes, in its order
    (lr2ppo_tpu/ops/int8.py:int8_matmul): with NARROW_SITES on, a narrow
    compute-bound site whose shapes the narrow int8 GEMM takes goes to it;
    otherwise an int8 weight that is not compute-bound at this call site, or
    narrow, is dequantized to `out_dtype` for a plain product; otherwise x
    is quantized per row and the s8 x s8 product accumulates in int32. A
    float weight is quantized first.

    A tp-split layer passes its global (out, in) `shape`, which the gates
    read, as JAX's gates read the global arrays. A row split (K over tp)
    passes its `mesh`: x holds this rank's part of each row, the row's amax
    is the max over tp, and the result is the whole product, summed over
    tp. Where JAX takes the narrow GEMM, the row split sums exact int32
    parts (int8_matmul_tp), so its bits are K2's on the global arrays; a
    shard the kernel's gate refuses (K/tp not a multiple of 128) takes the
    dequant route, as JAX does for a global shape its gate refuses. The s8 route sums its int32 parts over tp too,
    as XLA partitions JAX's s32 dot; the dequant route sums its
    `out_dtype` partial products (reduce_from_tp). A column split (N over
    tp) never takes the narrow GEMM: no narrow int8 site is column-split
    (parallel/mesh.py:RULES)."""
    out_dtype = out_dtype or x.dtype
    if weight.dtype != torch.int8:
        weight, weight_scale = quantize_weight(weight)
    n, k = shape if shape is not None else weight.shape
    rows = x.numel() // x.shape[-1]
    compute_bound = 2 * rows * k * n >= INT8_DYNQUANT_MIN_FLOPS
    narrow = n < INT8_DYNQUANT_MIN_WIDTH
    split = tuple(weight.shape) != (n, k)
    row_split = mesh is not None and mesh.tp > 1
    if compute_bound and narrow and NARROW_SITES:
        from lr2ppo_torch.ops import int8_matmul as k2

        if not split and k2.supported(x.shape, weight.shape):
            return k2.int8_matmul(x, weight, weight_scale.float(), out_dtype)
        if (row_split and k2.supported((*x.shape[:-1], k), (n, k))
                and k2.supported(x.shape, weight.shape)):
            return k2.int8_matmul_tp(x, weight, weight_scale, out_dtype,
                                     mesh)
    if not compute_bound or narrow:
        w = (weight.float() * weight_scale.float()[:, None]).to(out_dtype)
        y = torch.matmul(x.to(out_dtype), w.t())
        if row_split:
            from lr2ppo_torch.parallel.tp import reduce_from_tp

            y = reduce_from_tp(y, mesh)
        return y
    lead = x.shape[:-1]
    xq, xscale = quantize_rows(x.reshape(rows, weight.shape[1]).float(), mesh)
    # the one library s8 product of the port: JAX leaves this dot to XLA,
    # outside any Pallas kernel
    acc = torch._int_mm(xq, weight.t())
    if row_split:
        from lr2ppo_torch.parallel.tp import tp_sum_int

        acc = tp_sum_int(acc, mesh)     # exact, as XLA's partitioned s32 dot
    y = acc.float() * xscale * weight_scale.float()
    return y.to(out_dtype).reshape(*lead, weight.shape[0])


def quantize_state_dict(state: dict, other_dtype=torch.bfloat16) -> dict:
    """Counterpart of quantize_tree: every 2-D float Linear `*.weight` that
    passes `should_quantize` becomes int8 with a float32 `*.weight_scale`
    sibling; every other float tensor is cast to `other_dtype`, the
    position table `pos_emb.weight` too (quantize_tree quantizes `kernel`
    leaves only). Idempotent: an int8 weight's scale passes through
    untouched."""

    def quantizable(v):
        return (v is not None and v.ndim == 2 and v.is_floating_point()
                and should_quantize(v.shape))

    out = {}
    for key, v in state.items():
        if (key.endswith(".weight") and not key.endswith("pos_emb.weight")
                and quantizable(v)):
            out[key], out[key + "_scale"] = quantize_weight(v)
        elif key.endswith(".weight_scale") and quantizable(
                state.get(key[: -len("_scale")])):
            continue            # recomputed from the float weight above
        elif (key.endswith(".weight_scale")
              and state[key[: -len("_scale")]].dtype == torch.int8):
            out[key] = v        # beside an int8 weight: keep the f32 scale
        elif v.is_floating_point():
            out[key] = v.to(other_dtype)
        else:
            out[key] = v
    return out
