"""The yardstick's arithmetic: the H100's published peaks, the roofline
bound, CUDA-event timing and the union of device spans.

Frozen copies of `chip_smoke.py` (cited per function), kept here so that a
change to the program's smoke script cannot move the benchmark's numbers.
"""

from __future__ import annotations

import statistics

# NVIDIA's H100 SXM data sheet, dense rates (chip_smoke.py:317-323)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
BF16_TENSOR_OPS_PER_S = 989e12
# the data sheet's only rate outside the tensor cores (float32)
VECTOR_OPS_PER_S = 67e12
# the L2 of one H100: an input larger than this streams from HBM
L2_BYTES = 50 * 2**20

# the dense peak a model's step is held against, by compute dtype
STEP_PEAKS = {"bfloat16": BF16_TENSOR_OPS_PER_S,
              "float32": VECTOR_OPS_PER_S}


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take, in ms: the larger of the bytes
    over the memory rate and the operations over their peak rate
    (chip_smoke.py:326-332)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / rate * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cuda_ms(fn, iters: int = 10, warmup: int = 2, reps: int = 1) -> float:
    """Median milliseconds of `fn` over `iters` timed runs of `reps` calls
    each, between CUDA events (chip_smoke.py:367-384)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def union_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans
    (chip_smoke.py:559-566, `_union_us`)."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def overlap_us(spans, cover) -> float:
    """Microseconds of the union of `spans` that the union of `cover` also
    covers."""
    return union_us(spans) + union_us(cover) - union_us(list(spans)
                                                         + list(cover))
