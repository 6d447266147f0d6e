"""The narrow int8 GEMM kernel (K2) against its plain version, on a CUDA card.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_int8_matmul_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops import int8 as int8_ops
from lr2ppo_torch.ops import int8_matmul as tk2
from lr2ppo_torch.ops.int8 import quantize_weight
from lr2ppo_torch.ops.int8_matmul import (int8_matmul, int8_matmul_reference,
                                          supported)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(rows, k, n, seed, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, k), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)
                         * 0.05)
    q, s = quantize_weight(w)
    return x.to(dev), q.to(dev), s.to(dev)


# 16-byte words of an x row the kernel holds in a warp's registers
# (int8_matmul.cu:HELD, 12 a lane): rows of up to 6,144 bytes are read
# once, wider ones in two streamed passes
HELD_ROW_BYTES = 32 * 12 * 16
SMS = 132                    # an H100 SXM: the persistent grid's blocks


def _check(x, q, s, out_dtype):
    """One launch, counted, bit-equal to the plain version."""
    before = int8_matmul.launches
    got = int8_matmul(x, q, s, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    ref = int8_matmul_reference(x, q, s, out_dtype)
    assert got.dtype == out_dtype and got.shape == (*x.shape[:-1], q.shape[0])
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [
    (1040, 256, 128),        # ragged: not a multiple of the 128-row tile
    (513, 3072, 768),        # the flagship fc2 site's widths
    (512, 49152, 128),       # the corners of `supported`
    (512, 128, 49152),
    (512, 2048, 3072),
    (512, 6144, 1024),
    (512, 128, 384),         # K = 128; N ends on half a 256-column chunk
    (128 * SMS - 1, 3072, 768),   # one tile a block, the last one ragged
    (128 * SMS + 1, 3072, 768),   # one block takes a second, 1-row tile
])
def test_kernel_is_bit_equal_to_plain_version(dev, rows, k, n, in_dtype,
                                              out_dtype):
    """The kernel does the plain version's operations in the same order with
    exact integer products, so every element is equal; every shape
    `supported` admits launches."""
    x, q, s = _operands(rows, k, n, rows + k + n, dev)
    x = x.to(in_dtype)
    assert supported(x.shape, q.shape)
    _check(x, q, s, out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("above", [0, 128])
def test_rows_held_in_registers_and_streamed(dev, dtype, above):
    """K at the widest row a warp holds in registers, and 128 above it,
    where the row is read twice (amax, then values)."""
    k = HELD_ROW_BYTES // torch.tensor([], dtype=dtype).element_size() + above
    x, q, s = _operands(700, k, 256, k + above, dev)
    _check(x.to(dtype), q, s, torch.bfloat16)


@pytest.mark.parametrize("rows", [511, 512, 513])
def test_row_gate(dev, rows):
    """The TPU kernel's 512-row block is the gate: 511 rows raise before
    any launch, 512 and 513 launch."""
    x, q, s = _operands(rows, 256, 128, rows, dev)
    if rows < 512:
        before = int8_matmul.launches
        with pytest.raises(ValueError):
            int8_matmul(x, q, s, torch.float32)
        assert int8_matmul.launches == before
    else:
        _check(x, q, s, torch.float32)


def test_float32_in_bfloat16_out_on_a_second_stream(dev):
    """A launch on another stream than the current one's default gives the
    same bits, and counts once."""
    x, q, s = _operands(2000, 1024, 384, 6, dev)
    want = _check(x, q, s, torch.bfloat16)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        before = int8_matmul.launches
        got = int8_matmul(x, q, s, torch.bfloat16)
        assert int8_matmul.launches == before + 1
    side.synchronize()
    assert torch.equal(got, want)


def test_leading_dims_and_an_offset_view(dev):
    x, q, s = _operands(1040, 256, 128, 3, dev)
    flat = int8_matmul(x, q, s, torch.float32)
    assert torch.equal(int8_matmul(x.reshape(8, 130, 256), q, s,
                                   torch.float32).reshape(1040, 128), flat)
    # a view 4 bytes into its storage: copied to an aligned buffer first
    buf = torch.empty(1040 * 256 + 1, device=dev)
    view = buf[1:].view(1040, 256)
    view.copy_(x)
    assert view.data_ptr() % 16
    assert torch.equal(int8_matmul(view, q, s, torch.float32), flat)


def test_kernel_refuses_what_it_does_not_take(dev):
    x, q, s = _operands(1040, 256, 128, 4, dev)
    before = int8_matmul.launches
    with pytest.raises(ValueError):                 # float16 x
        int8_matmul(x.half(), q, s, torch.float32)
    with pytest.raises(ValueError):                 # a float weight
        int8_matmul(x, q.float(), s, torch.float32)
    with pytest.raises(ValueError):                 # a bfloat16 scale
        int8_matmul(x, q, s.bfloat16(), torch.float32)
    with pytest.raises(ValueError):                 # non-contiguous weight
        wide = torch.zeros(128, 512, dtype=torch.int8, device=dev)
        int8_matmul(x, wide[:, ::2], s, torch.float32)
    with pytest.raises(ValueError):                 # unaligned weight
        buf = torch.zeros(128 * 256 + 1, dtype=torch.int8, device=dev)
        int8_matmul(x, buf[1:].view(128, 256), s, torch.float32)
    with pytest.raises(ValueError):                 # too few rows
        int8_matmul(x[:64], q, s, torch.float32)
    with pytest.raises(ValueError):                 # the weight on the CPU
        int8_matmul(x, q.cpu(), s, torch.float32)
    assert int8_matmul.launches == before


def test_int8_linear_launches_k2_at_narrow_sites(dev, monkeypatch):
    """With NARROW_SITES on, a narrow compute-bound site launches the kernel
    once and equals the s8 route; off, it launches nothing."""
    monkeypatch.setattr(int8_ops, "INT8_DYNQUANT_MIN_FLOPS", 0)
    x, q, s = _operands(1040, 256, 128, 5, dev)
    before = int8_matmul.launches
    dequant = int8_ops.int8_linear(x, q, s, torch.float32)
    assert int8_matmul.launches == before
    monkeypatch.setattr(int8_ops, "NARROW_SITES", True)
    got = int8_ops.int8_linear(x, q, s, torch.float32)
    assert int8_matmul.launches == before + 1
    assert torch.equal(got, int8_matmul_reference(x, q, s, torch.float32))
    assert float((got - dequant).abs().max()) < 0.05 * float(
        dequant.abs().max())


# -- the tp entry: the int32 product and the epilogue ----------------------
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [
    (100352, 1536, 768),     # the rollout's fc2 at tp 2: a rank's half of K
    (1040, 128, 384),        # ragged rows; N ends on half a chunk
    (512, 3072, 128),
])
def test_tp_entry_is_bit_equal_to_its_plain_versions(dev, rows, k, n,
                                                     out_dtype):
    """int8_dot_s32 against int8_dot_s32_reference (exact int32 sums) and
    s32_epilogue against s32_epilogue_reference, each one launch; the two
    together give K2's bits on the same rows."""
    x, q, s = _operands(rows, k, n, rows + k, dev)
    x = x.to(torch.bfloat16)
    xq, xs = int8_ops.quantize_rows(x.float())
    b0, e0 = tk2.int8_dot_s32.launches, tk2.s32_epilogue.launches
    acc = tk2.int8_dot_s32(xq, q)
    y = tk2.s32_epilogue(acc, xs, s, out_dtype)
    torch.cuda.synchronize()
    assert (tk2.int8_dot_s32.launches, tk2.s32_epilogue.launches) == (
        b0 + 1, e0 + 1)
    assert torch.equal(acc, tk2.int8_dot_s32_reference(xq, q))
    assert torch.equal(y, tk2.s32_epilogue_reference(acc, xs, s, out_dtype))
    assert torch.equal(y, int8_matmul_reference(x, q, s, out_dtype))


def test_tp_entry_refuses_what_it_does_not_take(dev):
    """A shard the gate refuses (K 64: K2's K % 128) raises before any
    launch, as do an unaligned xq and an epilogue width N % 4 != 0."""
    x, q, s = _operands(1040, 256, 128, 6, dev)
    xq, xs = int8_ops.quantize_rows(x)
    b0, e0 = tk2.int8_dot_s32.launches, tk2.s32_epilogue.launches
    with pytest.raises(ValueError, match="unsupported"):
        tk2.int8_dot_s32(xq[:, :64].contiguous(), q[:, :64].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(1040 * 256 + 1, dtype=torch.int8, device=dev)
        tk2.int8_dot_s32(buf[1:].view(1040, 256), q)
    with pytest.raises(ValueError, match="N % 4"):
        acc = torch.zeros(1040, 130, dtype=torch.int32, device=dev)
        tk2.s32_epilogue(acc, xs, torch.ones(130, device=dev))
    assert (tk2.int8_dot_s32.launches, tk2.s32_epilogue.launches) == (b0, e0)
