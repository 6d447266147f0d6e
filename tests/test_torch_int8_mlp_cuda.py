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
@pytest.mark.parametrize("rows,d,hdn", [(530, 256, 512), (1000, 768, 3072)])
def test_kernel_matches_plain_version(dev, rows, d, hdn, out_dtype):
    """Ragged row counts (not multiples of the 16-row block). The kernel
    does the plain version's operations in the same order with integer-exact
    products, so it should agree bit for bit; the bound allowed is one
    second-quantization step of a w2 row, as on the CPU."""
    x, q1, s1, b1, q2, s2, b2 = _ffn(rows, d, hdn, 11, dev)
    x = x.to(out_dtype)
    before = int8_mlp.launches
    got = int8_mlp(x, q1, s1, b1, q2, s2, b2, out_dtype)
    torch.cuda.synchronize()
    assert int8_mlp.launches == before + 1
    ref = int8_mlp_reference(x, q1, s1, b1, q2, s2, b2, out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    diff = (got.float() - ref.float()).abs()
    # the CPU test's bounds (tests/test_torch_int8_mlp.py): one step of the
    # second quantization through a w2 row
    w1f, w2f = q1.float() * s1[:, None], q2.float() * s2[:, None]
    hidden = torch.nn.functional.gelu(x.float() @ w1f.t() + b1)
    step = float(hidden.abs().max()) / 127.0 * float(w2f.abs().max())
    assert float((diff <= 2e-5).float().mean()) > 0.99
    assert float(diff.max()) < 4.0 * step
    assert float(diff.mean()) < 1e-4
    # leading dims reshape through
    got3 = int8_mlp(x.reshape(2, rows // 2, d), q1, s1, b1, q2, s2, b2,
                    out_dtype)
    assert torch.equal(got3.reshape(rows, d), got)


def test_kernel_refuses_what_it_does_not_take(dev):
    x, q1, s1, b1, q2, s2, b2 = _ffn(530, 256, 512, 3, dev)
    with pytest.raises(ValueError):                 # x not in out_dtype
        int8_mlp(x, q1, s1, b1, q2, s2, b2, torch.bfloat16)
    with pytest.raises(ValueError):                 # non-contiguous weight
        int8_mlp(x, q2.t(), s1, b1, q1.t(), s2, b2, torch.float32)
    with pytest.raises(ValueError):                 # too few rows
        int8_mlp(x[:64], q1, s1, b1, q2, s2, b2, torch.float32)


@pytest.mark.parametrize("rows", [256, 1000, 70_000])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_every_supported_shape_launches(dev, rows, out_dtype):
    """D 512, H 4096 passes `supported`. A float32 (16, 4096) hidden block
    needs ~270 KB, above the 227 KB of shared memory a block may have, so
    the kernel keeps it in a global scratch; bfloat16 (~145 KB) stays in
    shared memory. Both launch and are bit-equal to the plain version;
    70,000 rows are more row blocks than the card holds at once, so the
    global variant's grid-stride loop takes several turns."""
    x, q1, s1, b1, q2, s2, b2 = _ffn(rows, 512, 4096, 5, dev)
    x = x.to(out_dtype)
    before = int8_mlp.launches
    got = int8_mlp(x, q1, s1, b1, q2, s2, b2, out_dtype)
    torch.cuda.synchronize()
    assert int8_mlp.launches == before + 1
    ref = int8_mlp_reference(x, q1, s1, b1, q2, s2, b2, out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(got, ref)
