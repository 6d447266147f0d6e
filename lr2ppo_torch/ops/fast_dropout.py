"""Packed-bits dropout (counterpart of lr2ppo_tpu/ops/fast_dropout.py).

One random 32-bit word serves four elements: byte j of word i decides
element 4i + j of the flat row-major x, which is kept iff the byte is below
threshold = round((1 - rate) * 256), and a kept element is divided by
threshold / 256. The keep probability is quantized to 1/256 steps (rate 0.1
keeps 230/256, an effective rate of 0.1016).

The words come from a torch.Generator on x's device seeded with the site's
seed, so they are not JAX's threefry bits: the two packages drop other
elements at the same rate (ROADMAP.md, C). The autograd Function saves only
the seed; the backward draws the same words again and applies the same mask
and scale to the cotangent, as the JAX package's jax.checkpoint around the
mask does. Plain eager PyTorch, no kernel: the option is off by default, and
the JAX package measures it as slower than hash dropout.
"""

from __future__ import annotations

import torch

from lr2ppo_torch.ops.hash_dropout import seeded_dropout

_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """keep iff byte < threshold."""
    return int(round((1.0 - rate) * 256.0))


def packed_keep(n: int, seed: int, rate: float, device) -> torch.Tensor:
    """The keep mask of n flat positions: ceil(n / 4) words, four bytes a
    word, low byte first."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & _MASK32)
    words = torch.randint(-2**31, 2**31, (-(-n // 4),), generator=gen,
                          device=device, dtype=torch.int32)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=device)
    bytes_ = (words[:, None] >> shifts) & 0xFF
    return (bytes_ < keep_threshold(rate)).reshape(-1)[:n]


def _apply(x: torch.Tensor, seed: int, rate: float, where) -> torch.Tensor:
    keep = packed_keep(x.numel(), seed, rate, x.device).reshape(x.shape)
    eff_keep = keep_threshold(rate) / 256.0
    return torch.where(keep, x / eff_keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def packed_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """nn.Dropout semantics with a byte-granular keep probability; `seed` a
    Python int, `rate` in [0, 1)."""
    if rate <= 0.0:
        return x
    return seeded_dropout(_apply, x, seed, rate, None)
