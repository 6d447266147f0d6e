"""Zero-residual hash dropout (counterpart of lr2ppo_tpu/ops/hash_dropout.py)
and `module_dropout`, the one dropout site of the fusion models and the
towers.

Element i (its flat row-major position in the global array) is kept iff
    fmix32(uint32(i) ^ uint32(seed) * 0x9E3779B9) < threshold(rate),
murmur3's 32-bit finalizer. Kept values are multiplied by 1/keep_eff
rounded to x's dtype.

Under a mesh a rank holds part of the global array, as the JAX iota over
the global array is partitioned: a `place` (row0, col0, width, w) takes x
as rows of w values at row row0 and column col0 of a global array `width`
wide, and element f = r * w + c hashes i = (row0 + r) * width + col0 + c
(mod 2^32). `shard_place` derives it from the active mesh: row0 from the dp
rank (the batch axis leads), col0 and width from the tp rank where the
site's trailing dims are tp-split. place None is the whole tensor, i = f. Dropout is linear in x, so the backward applies the
same mask and scale to the cotangent: the autograd Function saves only the
integer seed, never a mask.

Four parts:
  * `hash_dropout`, the autograd Function's entry: a CUDA tensor launches
    the hand-written kernel (kernels/csrc/hash_dropout.cu), forward and
    backward, and a CPU tensor takes the plain version;
  * `hash_dropout_reference`, the plain PyTorch version: uint32 arithmetic
    emulated in int64 masked to 32 bits, bit-equal to the JAX `_apply` and
    to the kernel;
  * `plan_keep_mask`, the kernel's plan walked in plain PyTorch on either
    of its paths (the bulk-copy ring's chunks and stages or the register
    path's strides, each pack's first global index, the split hash, the
    tail), so the CPU tests hold the kernel's index arithmetic against the
    plain version;
  * `module_dropout`: hash > fast (packed bits, ops/fast_dropout.py) >
    pallas-size-gated (Philox kernel, ops/dropout.py) > canonical, the JAX
    package's precedence.

Per-site seeds are Python ints drawn on the host from the caller's CPU
`torch.Generator` (`draw_seed`), so choosing a seed never waits on the card.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import torch

from lr2ppo_torch.kernels import build
from lr2ppo_torch.parallel.mesh import active

_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
# elements per chunk of the plain version: bounds its int64 temporaries
_CHUNK = 1 << 24
# the kernel's geometry (kernels/csrc/hash_dropout.cu, which reports it
# through lr2ppo_hash_dropout_geometry): the ring's chunk bytes, stages and
# blocks an SM; the threads of a block; the register path's blocks an SM
CHUNK_BYTES, STAGES, BLOCKS_PER_SM = 16384, 4, 2
THREADS, REG_BLOCKS_PER_SM = 256, 8
# an input of more bytes than the L2 takes the ring (an H100's 50 MiB)
L2_BYTES = 50 * 2**20


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


def global_index(start: int, n: int, place=None,
                 device=None) -> torch.Tensor:
    """The global positions (int64, mod 2^32) of local flat positions
    start .. start + n - 1 of a shard at `place` (see the module
    docstring); the positions themselves where place is None."""
    f = torch.arange(start, start + n, dtype=torch.int64, device=device)
    if place is None:
        return f & _MASK32
    row0, col0, width, w = place
    r = torch.div(f, w, rounding_mode="floor")
    return ((row0 + r) * width + col0 + (f - r * w)) & _MASK32


def keep_mask(start: int, n: int, seed: int, rate: float,
              device=None, place=None) -> torch.Tensor:
    """Keep mask of flat positions start .. start + n - 1 (of a shard at
    `place`)."""
    h = fmix32(global_index(start, n, place, device) ^ seed_mix(seed))
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


def hash_dropout_reference(x: torch.Tensor, seed: int, rate: float,
                           place=None) -> torch.Tensor:
    """The plain version."""
    check_place(x, place)
    return masked_scale(x, scale_for(rate, x.dtype),
                        lambda s, n: keep_mask(s, n, seed, rate, x.device,
                                               place),
                        _CHUNK)


def _rest(h: torch.Tensor) -> torch.Tensor:
    """fmix32 after its first step, on uint32 values held in int64."""
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def plan_keep_mask(n: int, elem_bytes: int, seed: int, rate: float,
                   place=None, sms: int = 132, ring: Optional[bool] = None,
                   l2_bytes: int = L2_BYTES, chunk_bytes: int = CHUNK_BYTES,
                   stages: int = STAGES, blocks_per_sm: int = BLOCKS_PER_SM,
                   threads: int = THREADS,
                   reg_blocks_per_sm: int = REG_BLOCKS_PER_SM
                   ) -> torch.Tensor:
    """The keep mask of n values of `elem_bytes` bytes as the kernel
    computes it, walking its plan (kernels/csrc/hash_dropout.cu) on the
    path it takes: the ring where the input has more than `l2_bytes` (or
    `ring` says so), else the register path.

    The ring: the whole 16-byte packs go in chunks of `chunk_bytes` through
    `stages` stages in each of min(chunks, blocks_per_sm * sms) blocks,
    block b taking chunks b, b + grid, ...; the leader loads the first
    `stages` chunks, then after each chunk's store refills the previous
    chunk's stage with the chunk stages - 1 ahead. The register path:
    thread t of min(ceil(packs / threads), reg_blocks_per_sm * sms) blocks
    takes packs t, t + stride, ....

    A pack hashes from its first global index: base + first value (the
    fast path), or one division and (r, c) stepped across row ends (the
    split path); the hash is the kernel's: fmix32(i ^ m) as _rest(i ^ (i >>
    16) ^ s1), s1 = m ^ (m >> 16), and on the fast path a pack at a
    multiple of its length shares t = i0 ^ (i0 >> 16) ^ s1, value j hashing
    _rest(t ^ j). The final fewer than one pack of values go one by one.
    Raises if a value is covered twice or not at all, or a stage is read
    before its load."""
    per_pack = 16 // elem_bytes
    packs = n // per_pack
    ring_values = packs * per_pack
    if ring is None:
        ring = n * elem_bytes > l2_bytes
    row0, col0, width, w = place if place is not None else (0, 0, n, n)
    split = place is not None and (col0 != 0 or width != w)
    base = (row0 * width) & _MASK32
    m = seed_mix(seed)
    s1 = m ^ (m >> 16)
    hashes = torch.full((n,), -1, dtype=torch.int64)

    def pack_hash(f: torch.Tensor, per: int) -> torch.Tensor:
        """The hashes (packs, per) of the packs of `per` values at local
        values f, as the kernel steps them."""
        if split:
            r = torch.div(f, w, rounding_mode="floor")
            c = f - r * w
            cols = []
            for _ in range(per):
                i = ((row0 + r) * width + col0 + c) & _MASK32
                cols.append(_rest(i ^ (i >> 16) ^ s1))
                c = c + 1
                wrap = c == w
                c = torch.where(wrap, 0, c)
                r = r + wrap.long()
            return torch.stack(cols, 1)
        j = torch.arange(per)
        i0 = (base + f) & _MASK32
        t = i0 ^ (i0 >> 16) ^ s1
        i = (i0[:, None] + j) & _MASK32
        return torch.where((i0 % per == 0)[:, None], _rest(t[:, None] ^ j),
                           _rest(i ^ (i >> 16) ^ s1))

    def put(first: int, count: int) -> None:
        """Hash `count` values from `first` in whole packs."""
        if bool((hashes[first:first + count] != -1).any()):
            raise AssertionError(f"values {first}..{first + count} twice")
        hashes[first:first + count] = pack_hash(
            first + torch.arange(0, count, per_pack), per_pack).reshape(-1)

    if ring:
        per_chunk = chunk_bytes // elem_bytes
        chunks = -(-ring_values // per_chunk)
        grid = max(1, min(chunks, blocks_per_sm * sms))
        for b in range(min(chunks, grid)):
            mine = (chunks - 1 - b) // grid + 1
            stage = [None] * stages          # the chunk each stage holds
            for it in range(min(stages, mine)):
                stage[it % stages] = it
            for it in range(mine):
                if stage[it % stages] != it:
                    raise AssertionError(f"block {b} reads chunk {it} from "
                                         f"stage {it % stages} before its "
                                         "load")
                first = (b + it * grid) * per_chunk
                put(first, min(per_chunk, ring_values - first))
                if it >= 1 and it - 1 + stages < mine:
                    stage[(it - 1) % stages] = it - 1 + stages
    else:
        grid = max(1, min(-(-packs // threads), reg_blocks_per_sm * sms))
        stride = grid * threads
        for first in range(0, packs, stride):   # one step of every thread
            put(first * per_pack, (min(first + stride, packs) - first)
                * per_pack)
    for f in range(ring_values, n):
        if hashes[f] != -1:
            raise AssertionError(f"value {f} twice")
        hashes[f] = pack_hash(torch.tensor([f]), 1)[0, 0]
    if bool((hashes == -1).any()):
        raise AssertionError("values left out of the plan")
    return hashes < threshold(rate)


def check_place(x: torch.Tensor, place) -> None:
    if place is not None and (place[3] <= 0 or x.numel() % place[3]):
        raise ValueError(f"hash_dropout: rows of {place[3]} do not tile "
                         f"{tuple(x.shape)}")


def check_elementwise(x: torch.Tensor, what: str) -> torch.Tensor:
    """The kernels' input contract: float32 or bfloat16 on a CUDA device,
    contiguous and 16-byte aligned (a strided tensor is made contiguous, a
    contiguous view at an odd offset is copied). Returns the tensor to
    launch on."""
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: {x.dtype} is not float32 or bfloat16")
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def launch_elementwise(entry: str, x: torch.Tensor, key: int, thr: int,
                       scale: float, *extra) -> torch.Tensor:
    """y = the kernel of the C entry `entry` (lr2ppo_<kernel>) over x, on
    x's device's current stream; `extra` are the entry's arguments after
    the stream (the shard's place). The launch is made on x's device: the
    device context is entered only where another device is current."""
    x = check_elementwise(x, entry)
    y = torch.empty_like(x)
    fn = build.function(entry)
    index = x.get_device()
    args = (x.data_ptr(), y.data_ptr(), x.numel(), key, thr, scale,
            build.DTYPE_CODES[x.dtype],
            torch._C._cuda_getCurrentRawStream(index), *extra)
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        build.check(build.library_of(entry), err, f"{entry} launch")
    return y


class SeededDropout(torch.autograd.Function):
    """y = apply(x, seed, rate, where) for a dropout that is linear in x:
    the backward is `apply` on the cotangent (the mask is a function of
    the flat row-major position, and `apply` reads a strided tensor in
    that order). `where` is the shard's place or offset (None: the whole
    array). Only the seed, the rate and `where` are kept, never a tensor."""

    @staticmethod
    def forward(ctx, apply, x, seed: int, rate: float, where):
        # not ctx.apply: that is the backward node's own method
        ctx.fn, ctx.seed, ctx.rate, ctx.where = apply, seed, rate, where
        return apply(x, seed, rate, where)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.fn(g, ctx.seed, ctx.rate, ctx.where), None, None, None


# SeededDropout.apply without torch.autograd.Function.apply's Python layer,
# which binds default arguments for a setup_context (there is none) and
# runs a pytree pass over the arguments for functorch's dead wrappers
# (neither is used here): 1.5-6 us of the H100 machine's host a call
# (PERF.md §6).
seeded_dropout = super(torch.autograd.Function, SeededDropout).apply


def _apply(x: torch.Tensor, seed: int, rate: float,
           place=None) -> torch.Tensor:
    """One masked scaling of x: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not x.is_cuda and x.device.type == "cpu":
        return hash_dropout_reference(x, seed, rate, place)
    thr, scale = threshold(rate), scale_for(rate, x.dtype)
    if place is None:
        y = launch_elementwise("lr2ppo_hash_dropout", x, seed_mix(seed), thr,
                               scale)
    else:
        check_place(x, place)
        row0, col0, width, w = place
        y = launch_elementwise("lr2ppo_hash_dropout_place", x, seed_mix(seed),
                               thr, scale, row0 & _MASK32, col0 & _MASK32,
                               width & _MASK32, w)
        hash_dropout.place_launches += 1
    hash_dropout.launches += 1
    return y


def hash_dropout(x: torch.Tensor, seed: int, rate: float,
                 place=None) -> torch.Tensor:
    """nn.Dropout semantics with the murmur mask; `seed` a Python int
    (int32 or uint32 range), `rate` in [0, 1), `place` the shard's place in
    the global array (None: x is the whole array). `hash_dropout.launches`
    counts kernel launches, forward and backward, and
    `hash_dropout.place_launches` those of them with a place."""
    return seeded_dropout(_apply, x, seed, rate, place)


hash_dropout.launches = 0
hash_dropout.place_launches = 0


def draw_seed(generator: torch.Generator) -> int:
    """One int32 seed, drawn on the host from a CPU generator."""
    return int(torch.randint(-2**31, 2**31 - 1, (), generator=generator,
                             dtype=torch.int64))


# shard_place's `tp_from` for a --sp sequence shard
SEQ = "seq"


def shard_place(x: torch.Tensor, tp_from=None):
    """This rank's place (row0, col0, width, w) for a dropout site's x
    under the active mesh, or None where x is the whole array. The batch
    axis leads and is split over dp; `tp_from` is the first dim of a
    tp-split trailing block (the column-split hidden: -1; head-split
    attention probabilities: 1), or SEQ for a --sp residual branch's
    (B, S/tp, H) sequence shard, so a token s of the shard at s0 hashes
    b * S * H + (s0 + s) * H + h, its index in the global array (the zero
    tokens padding an uneven shard hash past its row and are dropped), or
    None where x is whole on every tp rank."""
    mesh = active()
    if mesh.world == 1 or x.dim() == 0:
        return None
    if tp_from == SEQ and mesh.tp > 1:
        per = math.prod(x.shape[2:])
        w = x.shape[1] * per
        width, col0 = mesh.seq_len * per, mesh.tp_rank * w
    elif tp_from is not None and tp_from != SEQ and mesh.tp > 1:
        w = math.prod(x.shape[tp_from:])
        width, col0 = w * mesh.tp, mesh.tp_rank * w
    else:
        w = x.shape[-1]
        width, col0 = w, 0
    row0 = mesh.dp_rank * (x.numel() // max(w, 1))
    if row0 == 0 and col0 == 0 and width == w:
        return None
    return row0, col0, width, w


def place_offset(x: torch.Tensor, place) -> int:
    """A shard's element offset for the streams that take one (Philox's
    counter, the packed and canonical generators' seeds): row0 * width +
    col0 * rows, which tiles the global array without overlap and is the
    global flat position where only the batch is split."""
    row0, col0, width, w = place
    return row0 * width + col0 * (x.numel() // w)


def _shard_seed(seed: int, x: torch.Tensor, place) -> int:
    """The seed of a shard's own mask for the generator-drawn backends;
    the whole array keeps `seed`."""
    if place is None:
        return seed
    return (int(seed) * 1000003 + place_offset(x, place)) & _MASK32


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
                   pallas_min_elements: int = 128 * 1024 * 1024,
                   tp_from: Optional[int] = None) -> torch.Tensor:
    """THE dropout site of the fusion models and the towers. Precedence:
    hash > fast > pallas (the Philox kernel, size-gated) > canonical. Every
    active site draws one seed from `generator`, in the same order on every
    rank.

    Under a mesh (shard_place, `tp_from` as there) hash dropout draws JAX's
    mask of the global array at this rank's elements; Philox starts its
    counter at the shard's offset; the packed and canonical backends seed
    their generators per shard. The last three never repeat a rank's mask
    on another rank's elements, and are not world 1's masks."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("a training-mode dropout site needs the caller's "
                         "torch.Generator")
    seed = draw_seed(generator)
    place = shard_place(x, tp_from)
    if use_hash:
        if place is None:
            return hash_dropout(x, seed, rate)
        return hash_dropout(x, seed, rate, place)
    if use_fast:
        from lr2ppo_torch.ops import fast_dropout

        return fast_dropout.packed_dropout(x, _shard_seed(seed, x, place),
                                           rate)
    if use_pallas and x.numel() >= pallas_min_elements:
        from lr2ppo_torch.ops.dropout import philox_dropout

        if place is None:
            return philox_dropout(x, seed, rate)
        return philox_dropout(x, seed, rate, place_offset(x, place))
    return canonical_dropout(x, _shard_seed(seed, x, place), rate)
