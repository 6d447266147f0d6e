"""The two dropout kernels (hash and Philox) against their plain versions,
on a CUDA card.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_dropout_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.kernels import build
from lr2ppo_torch.ops import hash_dropout as thd
from lr2ppo_torch.ops.dropout import philox_dropout, philox_dropout_reference
from lr2ppo_torch.ops.hash_dropout import hash_dropout, hash_dropout_reference

pytestmark = pytest.mark.cuda

KERNELS = {"hash": (hash_dropout, hash_dropout_reference),
           "philox": (philox_dropout, philox_dropout_reference)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (517, 3072 + 5)])
@pytest.mark.parametrize("seed", [0, -123457, 2**31 - 1])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_is_bit_equal_forward_and_backward(dev, kind, seed, shape,
                                                  dtype):
    """Ragged sizes (not multiples of a 16-byte pack), negative seeds:
    the kernel and the plain version agree on every bit, and the backward
    applies the forward's mask to the cotangent."""
    fn, ref = KERNELS[kind]
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    before = fn.launches
    xr = x.clone().requires_grad_(True)
    y = fn(xr, seed, 0.1)
    y.backward(g)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(y, ref(x, seed, 0.1))
    assert torch.equal(xr.grad, ref(g, seed, 0.1))


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_keep_share_and_offset_views(dev, kind):
    """Keep share within 5 sigma of 1 - rate at 2^24 elements; a contiguous
    view at an odd offset (not 16-byte aligned) gives the plain version's
    answer for the same values."""
    fn, ref = KERNELS[kind]
    n, rate = 1 << 24, 0.3
    y = fn(torch.ones(n, device=dev), 5, rate)
    share = float((y != 0).float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sigma
    base = torch.randn(1001, device=dev)
    view = base[3:]
    assert view.data_ptr() % 16
    assert torch.equal(fn(view, 9, 0.5), ref(view.clone(), 9, 0.5))


def test_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError):
        hash_dropout(torch.ones(8, device=dev, dtype=torch.float16), 1, 0.1)
    with pytest.raises(ValueError):
        philox_dropout(torch.ones(8, device=dev, dtype=torch.float64), 1, 0.1)


# the tabular family's sites: a stage-3 update at batch 256 x 2 documents
# (512 rows, the FFN-inner and the residual widths) and a stage-1 step of
# 32 queries x 20 documents (640 rows)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 3072), (512, 768), (640, 3072)])
def test_hash_dropout_at_the_tabular_sites(dev, shape, dtype):
    """Hash dropout at the XiT sites of a tabular step, with the seeds a
    step draws (any int32): bit for bit with its plain version, forward and
    backward, one launch each."""
    rng = np.random.RandomState(shape[0] + shape[1])
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    for seed in (int(rng.randint(-2**31, 2**31 - 1)), 7):
        before = hash_dropout.launches
        xr = x.clone().requires_grad_(True)
        y = hash_dropout(xr, seed, 0.1)
        y.backward(g)
        torch.cuda.synchronize()
        assert hash_dropout.launches == before + 2
        assert torch.equal(y, hash_dropout_reference(x, seed, 0.1))
        assert torch.equal(xr.grad, hash_dropout_reference(g, seed, 0.1))


def test_hash_geometry_is_the_plans(dev):
    """The kernel reports the geometry ops/hash_dropout.py's plan walks,
    and the card's L2 is the size the plan's paths part at."""
    geometry = build.function("lr2ppo_hash_dropout_geometry")
    assert [geometry(i) for i in range(5)] == [
        thd.CHUNK_BYTES, thd.STAGES, thd.BLOCKS_PER_SM, thd.THREADS,
        thd.REG_BLOCKS_PER_SM]
    assert torch.cuda.get_device_properties(dev).L2_cache_size == \
        thd.L2_BYTES


@pytest.fixture(params=["ring", "registers"])
def path(request, dev):
    """Every size on one path: the ring from 0 bytes up, or none."""
    ring_from = build.function("lr2ppo_hash_dropout_ring_from")
    ring_from(0 if request.param == "ring" else 2**62)
    yield request.param
    ring_from(-1)


def _ring_cases(elem_bytes: int, sms: int) -> dict:
    """(values, place) at the edges of the kernel's ring on a card of
    `sms` SMs: a place is (row0, col0, width, w)."""
    pack, chunk = 16 // elem_bytes, thd.CHUNK_BYTES // elem_bytes
    ring = thd.BLOCKS_PER_SM * sms * thd.STAGES * chunk
    return {"under_a_pack": (pack - 1, None), "one_value": (1, None),
            "one_chunk": (chunk, None),
            "chunk_less_a_pack": (chunk - pack, None),
            "chunk_and_a_pack": (chunk + pack, None),
            "stages_less_one": (thd.STAGES * chunk - 1, None),
            "stages_and_one": (thd.STAGES * chunk + 1, None),
            "wraps_the_ring": (3 * ring + 5, None),
            # rows of 3,077 (no chunk's multiple) at column 1,234 of 7,001
            "split_place": (997 * 3077, (3, 1234, 7001, 3077)),
            # a dp shard: the fast path from row 4,096 of 3,072 wide
            "dp_shard": (1000 * 3072, (4096, 0, 3072, 3072))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_ring_cases(4, 132)))
def test_hash_ring_edges_are_bit_equal(dev, path, case, dtype):
    """Hash dropout on either path at the ring's edges (a tail alone, one
    chunk and a pack either side, the stages' span and one value either
    side, a size that wraps the ring three times, a split place whose rows
    straddle chunks and stages, a dp shard at row0 > 0): forward and
    backward bit for bit with the plain version, one launch each."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, place = _ring_cases(torch.empty((), dtype=dtype).element_size(),
                           sms)[case]
    rng = np.random.RandomState(n % 1000)
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev, dtype)
    seed = int(rng.randint(-2**31, 2**31 - 1))
    before = hash_dropout.launches
    xr = x.clone().requires_grad_(True)
    y = hash_dropout(xr, seed, 0.1, place)
    y.backward(g)
    torch.cuda.synchronize()
    assert hash_dropout.launches == before + 2
    assert torch.equal(y, hash_dropout_reference(x, seed, 0.1, place))
    assert torch.equal(xr.grad, hash_dropout_reference(g, seed, 0.1, place))
