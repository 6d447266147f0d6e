"""The fused int8 FFN kernel against its plain version, on a CUDA card.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_int8_mlp_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops.int8 import quantize_weight
from lr2ppo_torch.ops.int8_mlp import int8_mlp, int8_mlp_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ffn(rows, d, hdn, seed, dev):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(rows, d).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(hdn, d) * 0.05).astype(np.float32))
    b1 = torch.from_numpy((rng.randn(hdn) * 0.01).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(d, hdn) * 0.05).astype(np.float32))
    b2 = torch.from_numpy((rng.randn(d) * 0.01).astype(np.float32))
    q1, s1 = quantize_weight(w1)
    q2, s2 = quantize_weight(w2)
    return [t.to(dev) for t in (x, q1, s1, b1, q2, s2, b2)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,hdn", [(530, 256, 512), (1000, 768, 3072),
                                        (257, 768, 3072), (4095, 768, 3072)])
def test_kernel_matches_plain_version(dev, rows, d, hdn, out_dtype):
    """Ragged row counts (not multiples of the 128-row tile). The kernel
    does the plain version's operations in the same order with
    integer-exact products, so it agrees bit for bit."""
    x, q1, s1, b1, q2, s2, b2 = _ffn(rows, d, hdn, 11, dev)
    x = x.to(out_dtype)
    before = int8_mlp.launches
    got = int8_mlp(x, q1, s1, b1, q2, s2, b2, out_dtype)
    torch.cuda.synchronize()
    assert int8_mlp.launches == before + 1
    ref = int8_mlp_reference(x, q1, s1, b1, q2, s2, b2, out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(got, ref)
    # leading dims reshape through
    got3 = int8_mlp(x.reshape(rows, 1, d), q1, s1, b1, q2, s2, b2,
                    out_dtype)
    assert torch.equal(got3.reshape(rows, d), got)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_an_unaligned_x(dev, out_dtype):
    """x at an offset that is not a multiple of 16 bytes: the wrapper
    copies it before the kernel's 16-byte loads."""
    x, q1, s1, b1, q2, s2, b2 = _ffn(301, 256, 512, 13, dev)
    x = x.to(out_dtype)
    flat = torch.empty(x.numel() + 1, dtype=out_dtype, device=dev)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(x.shape)
    assert shifted.data_ptr() % 16
    got = int8_mlp(shifted, q1, s1, b1, q2, s2, b2, out_dtype)
    ref = int8_mlp_reference(x, q1, s1, b1, q2, s2, b2, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_kernel_refuses_what_it_does_not_take(dev):
    x, q1, s1, b1, q2, s2, b2 = _ffn(530, 256, 512, 3, dev)
    with pytest.raises(ValueError):                 # x not in out_dtype
        int8_mlp(x, q1, s1, b1, q2, s2, b2, torch.bfloat16)
    with pytest.raises(ValueError):                 # non-contiguous weight
        int8_mlp(x, q2.t(), s1, b1, q1.t(), s2, b2, torch.float32)
    with pytest.raises(ValueError):                 # too few rows
        int8_mlp(x[:64], q1, s1, b1, q2, s2, b2, torch.float32)


@pytest.mark.parametrize("rows,d,hdn", [(256, 512, 4096), (1000, 512, 4096),
                                        (70_000, 512, 4096),
                                        (1000, 1024, 3072), (1000, 128, 128),
                                        (1000, 384, 640), (1000, 3072, 1024),
                                        (40_000, 768, 3072)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_every_supported_shape_launches(dev, rows, d, hdn, out_dtype):
    """The gate's corners: D 512 / H 4096 and D 1024 / H 3072 (6 MiB of
    int8 weights, the most `supported` admits), D 3072 / H 1024 (6 MiB,
    the widest x rows) and the least, D 128 / H 128, in float32 and
    bfloat16; D 384 / H 640 and D 128 / H 128 end both products in a
    chunk of 128 of its 256 columns. Shared memory does not depend on the
    shape, only the scratch does, so each launches and is bit-equal to the
    plain version; 70,000 and 40,000 rows are more 128-row tiles than the
    card has SMs, so the persistent blocks take several."""
    x, q1, s1, b1, q2, s2, b2 = _ffn(rows, d, hdn, 5, dev)
    x = x.to(out_dtype)
    before = int8_mlp.launches
    got = int8_mlp(x, q1, s1, b1, q2, s2, b2, out_dtype)
    torch.cuda.synchronize()
    assert int8_mlp.launches == before + 1
    ref = int8_mlp_reference(x, q1, s1, b1, q2, s2, b2, out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(got, ref)
