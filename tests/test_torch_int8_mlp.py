"""The fused int8 FFN's plain PyTorch version against the JAX package's
Pallas kernel (interpret mode), and the shared shape gate. The kernel
itself is compared with the plain version on a card by
tests/test_torch_int8_mlp_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.ops.int8 import quantize_kernel
from lr2ppo_tpu.ops.pallas_int8_mlp import pallas_int8_mlp
from lr2ppo_tpu.ops.pallas_int8_mlp import supported as j_supported
from lr2ppo_torch.ops import int8_mlp as int8_mlp_mod
from lr2ppo_torch.ops.int8 import quantize_weight
from lr2ppo_torch.ops.int8_mlp import int8_mlp, int8_mlp_reference, supported

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _weights(seed=11, rows=530, d=256, hdn=512):
    """tests/test_int8.py's shapes and scales: 530 rows (not a multiple of
    any row block), D 256, H 512."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, d).astype(np.float32)
    w1 = (rng.randn(d, hdn) * 0.05).astype(np.float32)
    b1 = (rng.randn(hdn) * 0.01).astype(np.float32)
    w2 = (rng.randn(hdn, d) * 0.05).astype(np.float32)
    b2 = (rng.randn(d) * 0.01).astype(np.float32)
    return x, w1, b1, w2, b2


def _plain_and_pallas(dtype):
    """The plain version and Pallas interpret on _weights(), in `dtype`
    out, as float32 numpy, and one second-quantization step of a w2 row."""
    jdt, tdt = DTYPES[dtype]
    x, w1, b1, w2, b2 = _weights()
    q1, s1 = quantize_kernel(jnp.asarray(w1))
    q2, s2 = quantize_kernel(jnp.asarray(w2))
    ref = np.asarray(pallas_int8_mlp(
        jnp.asarray(x).astype(jdt), q1, s1, jnp.asarray(b1), q2, s2,
        jnp.asarray(b2), jdt, interpret=True), np.float32)

    t1, ts1 = quantize_weight(torch.from_numpy(w1.T.copy()))
    t2, ts2 = quantize_weight(torch.from_numpy(w2.T.copy()))
    got = int8_mlp(torch.from_numpy(x).to(tdt), t1, ts1, torch.from_numpy(b1),
                   t2, ts2, torch.from_numpy(b2), tdt)
    assert got.dtype == tdt and got.shape == x.shape
    h = np.maximum(x @ w1 + b1, 0)        # bounds |gelu(fc1)| from above
    step_bound = float(np.abs(h).max()) / 127.0 * float(np.abs(w2).max())
    return got.float().numpy(), ref, step_bound


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_pallas_interpret(dtype):
    """tests/test_int8.py's tolerance: the vast majority within 2e-5, the
    round-tie tail bounded by one step of the second quantization through a
    w2 row, and the mean error.

    With bfloat16 out, "within 2e-5" means bit-equal, and the share is 97%
    rather than 99%: under jit, XLA's CPU backend rewrites the scale's
    `amax / 127.0` as `amax * (1 / 127)`, one ulp off in a few percent of
    the rows, and a hidden value rounded to bfloat16 often sits exactly on
    a rounding tie of the second quantization, so it moves a whole int8
    step. The plain version, eager JAX and the CUDA kernel divide; the next
    test shows that the gap is this rewrite. The max and mean bounds stay
    as they are."""
    got, ref, step_bound = _plain_and_pallas(dtype)
    diff = np.abs(got - ref)
    assert (diff <= 2e-5).mean() > (0.99 if dtype == "f32" else 0.97)
    assert diff.max() < 4.0 * step_bound
    assert diff.mean() < 1e-4


def test_bf16_gap_is_the_jit_reciprocal_scale(monkeypatch):
    """Rounding the plain version's row scales as XLA's CPU jit does,
    `amax * (1 / 127)`, closes the bfloat16 gap of the test above: then all
    but a few elements in 100,000 are bit-equal."""
    recip = torch.tensor(np.float32(1.0) / np.float32(127.0))

    def quantize_rows_jit(xf):
        amax = xf.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) * recip
        return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale

    monkeypatch.setattr(int8_mlp_mod, "quantize_rows", quantize_rows_jit)
    got, ref, _ = _plain_and_pallas("bf16")
    assert (np.abs(got - ref) <= 2e-5).mean() > 0.9999


def test_plain_version_reshapes_leading_dims():
    x, w1, b1, w2, b2 = map(torch.from_numpy, _weights())
    q1, s1 = quantize_weight(w1.t())
    q2, s2 = quantize_weight(w2.t())
    flat = int8_mlp_reference(x, q1, s1, b1, q2, s2, b2, torch.float32)
    lead = int8_mlp_reference(x.reshape(2, 265, 256), q1, s1, b1, q2, s2, b2,
                              torch.float32)
    assert torch.equal(lead.reshape(530, 256), flat)


@pytest.mark.parametrize("x_shape,d,hdn,w2_out", [
    ((530, 256), 256, 512, 256),        # taken
    ((530, 256), 256, 512, 128),        # mismatched pair
    ((64, 256), 256, 512, 256),         # too few rows
    ((530, 2048), 2048, 4096, 2048),    # weights too large
    ((530, 200), 200, 512, 200),        # width not a multiple of 128
])
def test_supported_agrees_with_jax(x_shape, d, hdn, w2_out):
    """Same gate, weights given in each package's layout."""
    assert supported(x_shape, (hdn, d), (w2_out, hdn)) \
        == j_supported(x_shape, (d, hdn), (hdn, w2_out))


def test_wrapper_takes_the_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _weights())
    q1, s1 = quantize_weight(w1.t())
    q2, s2 = quantize_weight(w2.t())
    before = int8_mlp.launches
    got = int8_mlp(x, q1, s1, b1, q2, s2, b2, torch.float32)
    assert int8_mlp.launches == before
    assert torch.equal(got, int8_mlp_reference(x, q1, s1, b1, q2, s2, b2,
                                               torch.float32))


def test_gelu_polynomial_matches_jax_op_by_op():
    """The plain GELU rounds after every operation, as eager JAX does with
    the same polynomial (lr2ppo_tpu/ops/pallas_int8_mlp.py:_gelu_exact)."""
    from lr2ppo_tpu.ops.pallas_int8_mlp import _gelu_exact
    from lr2ppo_torch.ops.int8_mlp import gelu_poly

    x = np.random.RandomState(4).randn(4096).astype(np.float32) * 3
    x[:4] = [0.0, -6.0, 6.0, 1e-30]       # the clamp at +-4 and tiny values
    ref = np.asarray(_gelu_exact(jnp.asarray(x)))
    np.testing.assert_array_equal(gelu_poly(torch.from_numpy(x)).numpy(), ref)
