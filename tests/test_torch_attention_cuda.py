"""The tower attention kernel (K4) against its plain version, on a CUDA card.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_attention_cuda.py`.
Elsewhere every test skips.
"""

import math

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops.attention import (fused_attention, reference_attention,
                                        reset_launches)

pytestmark = pytest.mark.cuda

# |kernel - plain| <= atol + rtol * |plain|: the two sum in other orders and
# nowhere else differ. float32: the JAX package's kernel-vs-reference bound.
# bfloat16: a probability may round to its neighbouring bfloat16, and the
# output to its neighbouring step.
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2.0 ** -7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, dtype, seed, dev):
    b, h, s, dh = shape
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, dh).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    real = rng.randint(1, s + 1, size=b)
    real[0] = s
    bias = np.where(np.arange(s)[None] < real[:, None], 0.0, -10000.0)
    return q, k, v, torch.from_numpy(bias.astype(np.float32)).to(dev)


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all())


def _path(s):
    return "short" if s <= 256 else "long"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 77, 64), (2, 4, 130, 128),
                                   (2, 12, 514, 64), (1, 2, 9, 40),
                                   (2, 1, 1, 8), (2, 3, 50, 9),
                                   (2, 2, 200, 8), (2, 2, 256, 128),
                                   (1, 2, 300, 128)])
def test_kernel_matches_plain_version(dev, shape, dtype):
    """Ragged sequences (not multiples of a tile), padded keys, XLM-R's 514
    positions, head dims 128, 64 and the odd 40, 9 and 8 (padded in the
    kernel to the mma depth; 9 also leaves the 16-byte copies), on both
    sides of the short path's 256 keys."""
    q, k, v, bias = _inputs(shape, dtype, 7, dev)
    scale = 1.0 / math.sqrt(shape[-1])
    reset_launches()
    with torch.inference_mode():
        got = fused_attention(q, k, v, bias, scale)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, bias, scale)
    assert fused_attention.launches == 1
    assert fused_attention.path_launches[_path(shape[2])] == 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 255, 256, 257])
def test_path_boundary(dev, s, dtype):
    """Both sides of the short path's limit: S <= 256 takes the short
    path, 257 the long one, and each agrees with the plain version."""
    q, k, v, bias = _inputs((2, 3, s, 64), dtype, 11 + s, dev)
    reset_launches()
    with torch.inference_mode():
        got = fused_attention(q, k, v, bias, 0.125)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, bias, 0.125)
    other = "long" if _path(s) == "short" else "short"
    assert fused_attention.path_launches == {_path(s): 1, other: 0}
    assert fused_attention.launches == 1
    assert _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [37, 197, 300])
def test_kernel_reads_strided_views(dev, s, dtype):
    """The encoder hands (B, S, H, dh) tensors transposed to (B, H, S, dh):
    the kernel reads them through their strides, on either path."""
    b, h, dh = 2, 3, 64
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, dh).astype(np.float32))
               .to(dev, dtype).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    bias = torch.zeros(b, s, device=dev)
    bias[1, 20:] = -10000.0
    reset_launches()
    with torch.no_grad():
        got = fused_attention(q, k, v, bias, 0.125)
        want = fused_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), bias, 0.125)
    torch.cuda.synchronize()
    assert fused_attention.path_launches[_path(s)] == 2
    assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, bias = _inputs((1, 2, 16, 64), torch.float32, 3, dev)
    before = fused_attention.launches
    long_before = fused_attention.path_launches["long"]
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_attention(q.clone().requires_grad_(True), k, v, bias, 0.125)
    big = torch.zeros(1, 2, 16, 136, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(big, big, big, bias, 0.1)
    # a float32 score block of 16 rows of 3,008 keys is above 227 KB
    long = torch.zeros(1, 1, 3000, 128, device=dev)
    with torch.no_grad(), pytest.raises(ValueError, match="does not fit"):
        fused_attention(long, long, long, torch.zeros(1, 3000, device=dev),
                        0.1)
    assert fused_attention.launches == before
    assert fused_attention.path_launches["long"] == long_before
    # nothing left behind: the next launch runs
    with torch.no_grad():
        out = fused_attention(q, k, v, bias, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
