"""Zero-residual hash dropout (counterpart of lr2ppo_tpu/ops/hash_dropout.py)
and `module_dropout`, the one dropout site of the fusion models and the
towers.

Element i (its flat row-major position in x) is kept iff
    fmix32(uint32(i) ^ uint32(seed) * 0x9E3779B9) < threshold(rate),
murmur3's 32-bit finalizer. Kept values are multiplied by 1/keep_eff
rounded to x's dtype. Dropout is linear in x, so the backward applies the
same mask and scale to the cotangent: the autograd Function saves only the
integer seed, never a mask.

Three parts:
  * `hash_dropout`, the autograd Function's entry: a CUDA tensor launches
    the hand-written kernel (kernels/csrc/hash_dropout.cu), forward and
    backward, and a CPU tensor takes the plain version;
  * `hash_dropout_reference`, the plain PyTorch version: uint32 arithmetic
    emulated in int64 masked to 32 bits, bit-equal to the JAX `_apply` and
    to the kernel;
  * `module_dropout`: hash > fast (packed bits, ops/fast_dropout.py) >
    pallas-size-gated (Philox kernel, ops/dropout.py) > canonical, the JAX
    package's precedence.

Per-site seeds are Python ints drawn on the host from the caller's CPU
`torch.Generator` (`draw_seed`), so choosing a seed never waits on the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from lr2ppo_torch.kernels import build

_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
# elements per chunk of the plain version: bounds its int64 temporaries
_CHUNK = 1 << 24


@lru_cache(maxsize=None)
def threshold(rate: float) -> int:
    """keep iff hash < threshold; exact at 32-bit granularity."""
    t = int(round((1.0 - rate) * 4294967296.0))
    return min(t, 4294967295)


def seed_mix(seed: int) -> int:
    """uint32(seed) * golden mod 2^32; an int32 seed wraps to uint32 as
    `seed.astype(uint32)` does."""
    return ((int(seed) & _MASK32) * _GOLDEN) & _MASK32


@lru_cache(maxsize=None)
def scale_for(rate: float, dtype: torch.dtype) -> float:
    """1 / keep_eff rounded to `dtype`, as the JAX version's np.asarray(...,
    dtype=x.dtype); for bfloat16 at rate 0.1 that is 1.109375. Cached: a
    training step asks for it at every dropout site."""
    keep_eff = float(threshold(rate)) / 4294967296.0
    return float(torch.tensor(1.0 / keep_eff, dtype=dtype))


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """a * m mod 2^32 for int64 `a` in [0, 2^32): 16-bit halves keep every
    partial product below 2^49."""
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    return (al * ml + (((ah * ml + al * mh) & 0xFFFF) << 16)) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def keep_mask(start: int, n: int, seed: int, rate: float,
              device=None) -> torch.Tensor:
    """Keep mask of flat positions start .. start + n - 1."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    h = fmix32((idx & _MASK32) ^ seed_mix(seed))
    return h < threshold(rate)


def masked_scale(x: torch.Tensor, scale: float, keep_mask,
                 chunk: int) -> torch.Tensor:
    """where(keep, x * scale, 0) with `scale` and the product in x's dtype,
    over the flat row-major x in chunks of `chunk` elements (a multiple of
    4), so the masks' int64 temporaries stay small; keep_mask(start, n)
    gives the mask of flat positions start .. start + n - 1."""
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    s_t = torch.tensor(scale, dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for s in range(0, flat.numel(), chunk):
        part = flat[s:s + chunk]
        out[s:s + chunk] = torch.where(keep_mask(s, part.numel()),
                                       part * s_t, zero)
    return out.reshape(x.shape)


def hash_dropout_reference(x: torch.Tensor, seed: int,
                           rate: float) -> torch.Tensor:
    """The plain version."""
    return masked_scale(x, scale_for(rate, x.dtype),
                        lambda s, n: keep_mask(s, n, seed, rate, x.device),
                        _CHUNK)


def check_elementwise(x: torch.Tensor, what: str) -> torch.Tensor:
    """The kernels' input contract: float32 or bfloat16 on a CUDA device,
    contiguous and 16-byte aligned (a contiguous view at an odd offset is
    copied). Returns the tensor to launch on."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: {x.dtype} is not float32 or bfloat16")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def launch_elementwise(entry: str, x: torch.Tensor, key: int, thr: int,
                       scale: float) -> torch.Tensor:
    """y = the kernel of csrc/<entry>.cu over x, on x's device's current
    stream. The launch is made on x's device: the device context is entered
    only where another device is current."""
    x = check_elementwise(x, entry)
    y = torch.empty_like(x)
    fn = getattr(build.library(entry), f"lr2ppo_{entry}")
    index = x.device.index
    args = (x.data_ptr(), y.data_ptr(), x.numel(), key, thr, scale,
            build.DTYPE_CODES[x.dtype],
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        build.check(build.library(entry), err, f"{entry} launch")
    return y


class SeededDropout(torch.autograd.Function):
    """y = apply(x, seed, rate) for a dropout that is linear in x: the
    backward is `apply` on the cotangent, made contiguous (the mask is a
    function of the flat row-major position). Only the seed is saved."""

    @staticmethod
    def forward(ctx, apply, x, seed: int, rate: float):
        # not ctx.apply: that is the backward node's own method
        ctx.fn, ctx.seed, ctx.rate = apply, seed, rate
        return apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.fn(g.contiguous(), ctx.seed, ctx.rate), None, None


def _apply(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """One masked scaling of x: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return hash_dropout_reference(x, seed, rate)
    y = launch_elementwise("hash_dropout", x, seed_mix(seed),
                           threshold(rate), scale_for(rate, x.dtype))
    hash_dropout.launches += 1
    return y


def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """nn.Dropout semantics with the murmur mask; `seed` a Python int
    (int32 or uint32 range), `rate` in [0, 1). `hash_dropout.launches`
    counts kernel launches, forward and backward."""
    return SeededDropout.apply(_apply, x, seed, rate)


hash_dropout.launches = 0


def draw_seed(generator: torch.Generator) -> int:
    """One int32 seed, drawn on the host from a CPU generator."""
    return int(torch.randint(-2**31, 2**31 - 1, (), generator=generator,
                             dtype=torch.int64))


def canonical_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """nn.Dropout's own semantics from a Bernoulli mask that autograd keeps
    (the JAX package's threefry nn.Dropout); the mask comes from a
    generator on x's device seeded with `seed`."""
    gen = torch.Generator(device=x.device).manual_seed(int(seed) & _MASK32)
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate,
                                                            generator=gen)
    return x * keep.to(x.dtype) / (1.0 - rate)


def module_dropout(x: torch.Tensor, rate: float, deterministic: bool,
                   generator: Optional[torch.Generator], use_hash: bool,
                   use_fast: bool = False, use_pallas: bool = False,
                   pallas_min_elements: int = 128 * 1024 * 1024
                   ) -> torch.Tensor:
    """THE dropout site of the fusion models and the towers. Precedence:
    hash > fast > pallas (the Philox kernel, size-gated) > canonical. Every
    active site draws one seed from `generator`."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("a training-mode dropout site needs the caller's "
                         "torch.Generator")
    if use_hash:
        return hash_dropout(x, draw_seed(generator), rate)
    if use_fast:
        from lr2ppo_torch.ops import fast_dropout

        return fast_dropout.packed_dropout(x, draw_seed(generator), rate)
    if use_pallas and x.numel() >= pallas_min_elements:
        from lr2ppo_torch.ops.dropout import philox_dropout

        return philox_dropout(x, draw_seed(generator), rate)
    return canonical_dropout(x, draw_seed(generator), rate)
