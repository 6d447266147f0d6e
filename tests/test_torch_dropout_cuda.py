"""The two dropout kernels (hash and Philox) against their plain versions,
on a CUDA card.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_dropout_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

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
