"""Hash dropout's global-index form and Philox's shard offset, the two
kernel changes of the multi-GPU port, against their plain versions on a
CUDA card.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops.dropout import philox_dropout, philox_dropout_reference
from lr2ppo_torch.ops.hash_dropout import (hash_dropout,
                                           hash_dropout_reference,
                                           place_offset)

pytestmark = pytest.mark.cuda

# (local shape, place (row0, col0, width, w)): a dp shard, a tp column
# shard, both, head-split attention probabilities, an odd width, and a
# place whose global index wraps past 2^32
PLACES = {
    "dp_shard": ((300, 3072), (300, 0, 3072, 3072)),
    "tp_columns": ((600, 1536), (0, 1536, 3072, 1536)),
    "dp_and_tp": ((300, 1536), (300, 1536, 3072, 1536)),
    "heads": ((4, 6, 77, 77), (4, 6 * 77 * 77, 12 * 77 * 77, 6 * 77 * 77)),
    "odd_width": ((33, 3077), (7, 5, 6159, 3077)),
    "wraps": ((64, 3072), (2_000_000, 1536, 4608, 3072)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", sorted(PLACES))
def test_hash_place_is_bit_equal_forward_and_backward(dev, shard, dtype):
    """The kernel at a shard's place and the plain version agree on every
    bit, forward and backward; each launch counts once in `launches` and
    once in `place_launches`."""
    shape, place = PLACES[shard]
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    before = (hash_dropout.launches, hash_dropout.place_launches)
    xr = x.clone().requires_grad_(True)
    y = hash_dropout(xr, -991, 0.1, place)
    y.backward(g)
    torch.cuda.synchronize()
    assert (hash_dropout.launches, hash_dropout.place_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(y, hash_dropout_reference(x, -991, 0.1, place))
    assert torch.equal(xr.grad, hash_dropout_reference(g, -991, 0.1, place))


def test_hash_shards_reassemble_the_whole_mask(dev):
    """Four ranks of a dp 2 x tp 2 mesh each drop their part of a
    (4, 3, 8) array at their place: together, the whole array's mask."""
    x = torch.randn(4, 3, 8, device=dev)
    want = hash_dropout(x, 5, 0.5)
    for d in range(2):
        for t in range(2):
            part = x[2 * d:2 * d + 2, :, 4 * t:4 * t + 4].contiguous()
            got = hash_dropout(part, 5, 0.5, (6 * d, 4 * t, 8, 4))
            assert torch.equal(got, want[2 * d:2 * d + 2, :, 4 * t:4 * t + 4])


def test_whole_tensor_place_is_the_local_kernel(dev):
    x = torch.randn(257, 3072, device=dev, dtype=torch.bfloat16)
    assert torch.equal(hash_dropout(x, 3, 0.1, (0, 0, 3072, 3072)),
                       hash_dropout(x, 3, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_philox_offset_is_bit_equal_and_tiles_the_stream(dev, dtype):
    """K3 at a dp shard's offset: bit-equal to its plain version forward
    and backward; the two shards concatenate to the whole array's mask."""
    x = torch.randn(512, 3072, device=dev).to(dtype)
    g = torch.randn(256, 3072, device=dev).to(dtype)
    whole = philox_dropout(x, 77, 0.1)
    parts = []
    for r in range(2):
        off = r * 256 * 3072
        xr = x[256 * r:256 * (r + 1)].clone().requires_grad_(True)
        y = philox_dropout(xr, 77, 0.1, off)
        y.backward(g)
        assert torch.equal(y, philox_dropout_reference(
            x[256 * r:256 * (r + 1)], 77, 0.1, off))
        assert torch.equal(xr.grad, philox_dropout_reference(g, 77, 0.1,
                                                             off))
        parts.append(y.detach())
    assert torch.equal(torch.cat(parts), whole)


def test_philox_rank_offsets_draw_independent_masks(dev):
    """The tp column shards of the FFN-inner site take disjoint counters
    (place_offset): each keeps 1 - rate within 5 sigma, and two ranks'
    masks agree on about (1 - rate)^2 + rate^2 of the elements, as
    independent draws do, not on all of them."""
    rows, w, rate = 4096, 1536, 0.1
    x = torch.ones(rows, w, device=dev)
    masks = []
    for t in range(2):
        off = place_offset(x, (0, t * w, 2 * w, w))
        masks.append(philox_dropout(x, 9, rate, off) != 0)
    n = rows * w
    sigma = (rate * (1 - rate) / n) ** 0.5
    for m in masks:
        assert abs(float(m.float().mean()) - (1 - rate)) < 5 * sigma
    agree = float((masks[0] == masks[1]).float().mean())
    want = (1 - rate) ** 2 + rate ** 2
    assert abs(agree - want) < 5 * (want * (1 - want) / n) ** 0.5
