"""Hash dropout at the sequence-parallel place (`--sp`): a tp rank's S/tp
tokens of a (B, S, H) residual stream, viewed as B rows of S * H, on a CUDA
card against the plain version, forward and backward, and the shards of
every rank reassembling the whole tensor's mask.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_pipeline_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops.hash_dropout import (hash_dropout,
                                           hash_dropout_reference,
                                           shard_place)
from lr2ppo_torch.parallel import mesh as pm

pytestmark = pytest.mark.cuda

# (B, S, H) of the tower's residual sites: XLM-R base at batch 32 x 128,
# and an odd width
SHAPES = {"xlmr_base": (32, 128, 768), "odd": (6, 10, 77)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _sp_place(x, rank, dp, tp):
    pm.set_active(pm.Mesh(dp=dp, tp=tp, rank=rank))
    try:
        return shard_place(x, 1)
    finally:
        pm.set_active(None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sp_place_is_bit_equal_forward_and_backward(dev, shape, dtype):
    b, s, h = SHAPES[shape]
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(b, s, h).astype(np.float32)).to(dev,
                                                                   dtype)
    g = torch.randn(b, s, h, device=dev).to(dtype)
    whole = hash_dropout(x, 77, 0.1)
    for rank in range(2):
        part = x[:, rank * s // 2:(rank + 1) * s // 2].contiguous()
        place = _sp_place(part, rank, 1, 2)
        assert place == (0, rank * (s // 2) * h, s * h, s // 2 * h)
        before = (hash_dropout.launches, hash_dropout.place_launches)
        xr = part.clone().requires_grad_(True)
        y = hash_dropout(xr, 77, 0.1, place)
        gp = g[:, rank * s // 2:(rank + 1) * s // 2].contiguous()
        y.backward(gp)
        torch.cuda.synchronize()
        assert (hash_dropout.launches, hash_dropout.place_launches) == (
            before[0] + 2, before[1] + 2)
        assert torch.equal(y, hash_dropout_reference(part, 77, 0.1, place))
        assert torch.equal(xr.grad, hash_dropout_reference(gp, 77, 0.1,
                                                           place))
        assert torch.equal(y, whole[:, rank * s // 2:(rank + 1) * s // 2])


def test_sp_places_of_a_dp_by_tp_mesh_tile_the_whole_mask(dev):
    x = torch.randn(4, 8, 24, device=dev)
    want = hash_dropout(x, -5, 0.5)
    for rank in range(4):
        d, t = rank // 2, rank % 2
        part = x[2 * d:2 * d + 2, 4 * t:4 * t + 4].contiguous()
        got = hash_dropout(part, -5, 0.5, _sp_place(part, rank, 2, 2))
        assert torch.equal(got, want[2 * d:2 * d + 2, 4 * t:4 * t + 4])
