"""Counter-based Philox dropout: the port of the TPU dropout kernel
(lr2ppo_tpu/ops/pallas_dropout.py:tpu_dropout), with the same contract:

  * x is taken as (-1, last dim), row-major; rate 0 returns x;
  * keep iff bits <= uint32((1 - rate) * 0xFFFFFFFF);
  * kept values times 1/(1 - rate) rounded to x's dtype, the product in
    x's dtype;
  * the backward regenerates the mask from the seed and applies the same
    kernel to the cotangent; nothing but the seed is saved.

Hopper has no hardware PRNG. The bits come from Philox4x32-10 keyed by
(uint32(seed), 0): element i takes word i % 4 of the block for counter
(i // 4 low 32 bits, i // 4 high 32 bits, 0, 0). The TPU's bits cannot be
reproduced, so against the JAX package the check is statistical; the
plain version below computes the same Philox in int64, so on the card
kernel and plain version are bit-equal.

`philox_dropout` launches kernels/csrc/philox_dropout.cu on a CUDA tensor
and takes `philox_dropout_reference` on a CPU tensor.
"""

from __future__ import annotations

import torch

from lr2ppo_torch.ops.hash_dropout import (launch_elementwise, masked_scale,
                                           seeded_dropout)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_ROUNDS = 10
# elements per chunk of the plain version: bounds its int64 temporaries
_CHUNK = 1 << 24


def threshold(rate: float) -> int:
    """The TPU kernel's jnp.uint32((1.0 - rate) * 0xFFFFFFFF): truncation."""
    return int((1.0 - rate) * 0xFFFFFFFF)


def scale_for(rate: float, dtype: torch.dtype) -> float:
    """1/(1 - rate) rounded to x's dtype (a weakly typed Python float in
    the TPU kernel's `x * scale`)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 `a` in [0, 2^32) and a
    32-bit constant m, without leaving int64: a is split in 16-bit halves."""
    al, ah = a & 0xFFFF, a >> 16
    p_lo = al * m                                    # < 2^48
    p_hi = ah * m                                    # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)             # < 2^49
    lo = mid & _MASK32
    hi = ((p_hi >> 16) + (mid >> 32)) & _MASK32
    return hi, lo


def philox_bits(counters: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of counters (n,) int64 -> (n, 4) uint32 words in int64."""
    c0 = counters & _MASK32
    c1 = (counters >> 32) & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & _MASK32, 0
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=1)


def keep_mask(start: int, n: int, seed: int, rate: float,
              device=None) -> torch.Tensor:
    """Keep mask of flat positions start .. start + n - 1 (`start` a
    multiple of 4; a shard's offset is added to it)."""
    first, last = start // 4, (start + n + 3) // 4
    ctr = torch.arange(first, last, dtype=torch.int64, device=device)
    bits = philox_bits(ctr, seed).reshape(-1)[start - 4 * first:][:n]
    return bits <= threshold(rate)


def _check_offset(offset: int) -> None:
    if offset < 0 or offset % 4:
        raise ValueError(f"philox_dropout: offset {offset} is not a "
                         "non-negative multiple of 4")


def philox_dropout_reference(x: torch.Tensor, seed: int, rate: float,
                             offset: int = 0) -> torch.Tensor:
    """The plain version; element i takes the bits of position offset + i."""
    if rate <= 0.0:
        return x
    _check_offset(offset)
    return masked_scale(x, scale_for(rate, x.dtype),
                        lambda s, n: keep_mask(offset + s, n, seed, rate,
                                               x.device),
                        _CHUNK)


def _apply(x: torch.Tensor, seed: int, rate: float,
           offset: int = 0) -> torch.Tensor:
    if x.device.type == "cpu":
        return philox_dropout_reference(x, seed, rate, offset)
    _check_offset(offset)
    y = launch_elementwise("lr2ppo_philox_dropout", x, int(seed) & _MASK32,
                           threshold(rate), scale_for(rate, x.dtype), offset)
    philox_dropout.launches += 1
    return y


def philox_dropout(x: torch.Tensor, seed: int, rate: float,
                   offset: int = 0) -> torch.Tensor:
    """Dropout with Philox bits; `seed` a Python int, `rate` in [0, 1),
    `offset` the position of x's first element in the stream (a shard's
    place in the global array, ops/hash_dropout.py:place_offset; a multiple
    of 4). `philox_dropout.launches` counts kernel launches, forward and
    backward."""
    if rate <= 0.0:
        return x
    return seeded_dropout(_apply, x, seed, rate, offset)


philox_dropout.launches = 0
