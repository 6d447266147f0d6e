"""lr2ppo_torch/ops/int8.py against lr2ppo_tpu/ops/int8.py: weight
quantization, the three routes of the int8 linear, and the state_dict
quantizer's gates. Weights are made with numpy and given to JAX in its
(in, out) layout and to the port in torch's (out, in) layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.ops.int8 import int8_matmul, quantize_kernel, quantize_tree
from lr2ppo_torch.ops import int8 as tint8
from lr2ppo_torch.ops.int8 import (int8_linear, quantize_state_dict,
                                   quantize_weight)

torch.set_num_threads(1)


@pytest.fixture
def gates_zero(monkeypatch):
    """Force the s8 route on both packages (tests/test_int8.py:25-34)."""
    for mod in (jint8, tint8):
        monkeypatch.setattr(mod, "INT8_MIN_KERNEL_ELEMENTS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_FLOPS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_WIDTH", 0)


def _xw(seed, rows=64, k=96, n=48):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, k).astype(np.float32),
            (rng.randn(k, n) * 0.05).astype(np.float32))


def test_quantize_weight_is_bit_exact():
    _, w = _xw(0)
    w[3, 5] = 0.0
    w[:, 7] = 0.0                        # an all-zero channel: the 1e-8 floor
    jq, js = quantize_kernel(jnp.asarray(w))
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_s8_route_is_bit_exact(gates_zero):
    """int32 sums and the same elementwise order: equal at float32."""
    x, w = _xw(1)
    jq, js = quantize_kernel(jnp.asarray(w))
    ref = np.asarray(int8_matmul(jnp.asarray(x), jq, js, jnp.float32))
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    got = int8_linear(torch.from_numpy(x), tq, ts, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    # leading dims and a float weight quantized on the fly
    got3 = int8_linear(torch.from_numpy(x).reshape(4, 16, 96),
                       torch.from_numpy(w.T.copy()), None, torch.float32)
    np.testing.assert_array_equal(got3.reshape(64, 48).numpy(), ref)


def test_dequant_route_matches():
    """Production gates: 4 rows are far below the FLOPs gate, so both
    packages dequantize and take a plain product. Only the summation order
    differs."""
    x, w = _xw(2, rows=4, k=768, n=3072)
    jq, js = quantize_kernel(jnp.asarray(w))
    ref = np.asarray(int8_matmul(jnp.asarray(x), jq, js, jnp.float32))
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    got = int8_linear(torch.from_numpy(x), tq, ts, torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _trees(seed=7):
    """A flax-layout tree and the same weights as a reference state_dict:
    one kernel above the production size gate, one below, a LayerNorm."""
    rng = np.random.RandomState(seed)
    big = rng.randn(2048, 1024).astype(np.float32)          # 2M elements
    small = rng.randn(128, 64).astype(np.float32)
    bias = rng.randn(1024).astype(np.float32)
    ln = rng.randn(64).astype(np.float32)
    flax = {"params": {"fc": {"kernel": jnp.asarray(big),
                              "bias": jnp.asarray(bias)},
                       "qkv": {"kernel": jnp.asarray(small)},
                       "ln": {"scale": jnp.asarray(ln)}}}
    sd = {"fc.weight": torch.from_numpy(big.T.copy()),
          "fc.bias": torch.from_numpy(bias),
          "qkv.weight": torch.from_numpy(small.T.copy()),
          "ln.weight": torch.from_numpy(ln)}
    return flax, sd


def test_quantize_state_dict_gates_like_quantize_tree():
    flax, sd = _trees()
    jq = quantize_tree(flax, jnp.bfloat16)["params"]
    tq = quantize_state_dict(sd, torch.bfloat16)
    assert set(tq) == {"fc.weight", "fc.weight_scale", "fc.bias",
                       "qkv.weight", "ln.weight"}
    assert tq["fc.weight"].dtype == torch.int8
    assert tq["fc.weight_scale"].dtype == torch.float32
    np.testing.assert_array_equal(tq["fc.weight"].numpy(),
                                  np.asarray(jq["fc"]["kernel"]).T)
    np.testing.assert_array_equal(tq["fc.weight_scale"].numpy(),
                                  np.asarray(jq["fc"]["kernel_scale"]))
    # below the gate: float, cast to the compute dtype like every other leaf
    for key, path in (("qkv.weight", ("qkv", "kernel")),
                      ("fc.bias", ("fc", "bias")), ("ln.weight", ("ln", "scale"))):
        leaf = jq[path[0]][path[1]]
        assert tq[key].dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16
        got = tq[key].float().numpy()
        np.testing.assert_array_equal(
            got.T if key == "qkv.weight" else got,
            np.asarray(leaf.astype(jnp.float32)))


def test_quantize_state_dict_is_idempotent():
    _, sd = _trees()
    q1 = quantize_state_dict(sd)
    q2 = quantize_state_dict(q1)
    assert set(q1) == set(q2)
    for k in q1:
        assert q1[k].dtype == q2[k].dtype
        assert torch.equal(q1[k], q2[k]), k
    assert q2["fc.weight_scale"].dtype == torch.float32


def test_quantize_state_dict_recomputes_a_ones_scale():
    """An int8-initialized model's state carries a ones `weight_scale`
    beside a float weight: it must not survive (quantize_tree's rule)."""
    _, sd = _trees()
    sd["fc.weight_scale"] = torch.ones(1024)
    q = quantize_state_dict(sd)
    assert torch.equal(q["fc.weight_scale"],
                       quantize_weight(sd["fc.weight"])[1])


def test_jax_tree_and_state_dict_route_the_same(gates_zero):
    """The same weights through JAX's quantize_tree + int8_matmul and the
    port's quantize_state_dict + int8_linear give equal results."""
    flax, sd = _trees()
    x = np.random.RandomState(3).randn(8, 2048).astype(np.float32)
    jq = quantize_tree(flax, jnp.float32)["params"]["fc"]
    tq = quantize_state_dict(sd, torch.float32)
    ref = np.asarray(int8_matmul(jnp.asarray(x), jq["kernel"],
                                 jq["kernel_scale"], jnp.float32))
    got = int8_linear(torch.from_numpy(x), tq["fc.weight"],
                      tq["fc.weight_scale"], torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
