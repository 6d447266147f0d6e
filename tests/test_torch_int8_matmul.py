"""The narrow int8 GEMM (K2) of the port against the JAX package's: its plain
version against the Pallas kernel (interpret mode) and the eager s8 route,
the shared shape gate, the narrow-site route of int8_linear, and int8
models in the narrow routing (fused FFN off, narrow sites on) against JAX in
the same routing. The kernel itself is compared with the plain version on a
card by tests/test_torch_int8_matmul_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.config import ModelConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.ops import pallas_int8_matmul as jk2
from lr2ppo_tpu.ops.int8 import quantize_kernel, quantize_tree
from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
from lr2ppo_torch.ops import int8 as tint8
from lr2ppo_torch.ops import int8_matmul as tk2
from lr2ppo_torch.ops.int8 import quantize_state_dict, quantize_weight
from lr2ppo_torch.train.checkpoints import params_from_flax

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _xw(seed, rows, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, k).astype(np.float32),
            (rng.randn(k, n) * 0.05).astype(np.float32))


def _both(dtype, rows, k, n, seed=7):
    """K2's plain version and the JAX Pallas kernel (interpret) on the same
    x and weight, in `dtype` in and out, as float32 numpy; and the JAX
    eager s8 route with the gates zeroed."""
    jdt, tdt = DTYPES[dtype]
    x, w = _xw(seed, rows, k, n)
    jq, js = quantize_kernel(jnp.asarray(w))
    jx = jnp.asarray(x).astype(jdt)
    pallas = np.asarray(jk2.pallas_int8_matmul(jx, jq, js, jdt,
                                               interpret=True), np.float32)
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    got = tk2.int8_matmul(torch.from_numpy(x).to(tdt), tq, ts, tdt)
    assert got.dtype == tdt and got.shape == (rows, n)
    return got.float().numpy(), pallas, jx, jq, js


@pytest.mark.parametrize("dtype,rows,k,n", [("f32", 1040, 256, 128),
                                            ("bf16", 600, 384, 256)])
def test_plain_version_matches_pallas_interpret(dtype, rows, k, n,
                                                monkeypatch):
    """tests/test_int8.py:233-234's bound, atol 2e-5 and rtol 1e-5, against
    the Pallas kernel; the eager JAX s8 route, which divides as the plain
    version does, is equal element for element.

    With bfloat16 in, about 1% of the elements, in 2% of the rows, are
    further off: under jit, XLA's CPU backend rewrites the scale's
    `amax / 127.0` as `amax * (1 / 127)` (ROADMAP.md, C), one ulp off in a
    few rows, and a bfloat16 x often sits exactly on a rounding tie of the
    quantization, so it moves a whole int8 step. The next test shows the
    gap is that rewrite. No element is off by more than two such steps,
    each at most max|x| * max(w_scale)."""
    got, pallas, jx, jq, js = _both(dtype, rows, k, n)
    bad = ~np.isclose(got, pallas, atol=2e-5, rtol=1e-5)
    if dtype == "f32":
        assert not bad.any()
    else:
        assert bad.mean() < 0.02
        step = (float(np.abs(np.asarray(jx, np.float32)).max())
                * float(np.asarray(js).max()))
        assert float(np.abs(got - pallas).max()) <= 2 * step
    for mod in ("INT8_MIN_KERNEL_ELEMENTS", "INT8_DYNQUANT_MIN_FLOPS",
                "INT8_DYNQUANT_MIN_WIDTH"):
        monkeypatch.setattr(jint8, mod, 0)
    eager = np.asarray(jint8.int8_matmul(jx, jq, js, jx.dtype), np.float32)
    np.testing.assert_array_equal(got, eager)


def test_bf16_gap_is_the_jit_reciprocal_scale(monkeypatch):
    """Rounding the plain version's row scales as XLA's CPU jit does,
    `amax * (1 / 127)`, closes the bfloat16 gap of the test above."""
    recip = torch.tensor(np.float32(1.0) / np.float32(127.0))

    def quantize_rows_jit(xf):
        amax = xf.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) * recip
        return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale

    monkeypatch.setattr(tk2, "quantize_rows", quantize_rows_jit)
    got, pallas, *_ = _both("bf16", 600, 384, 256)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-5)


def test_plain_version_reshapes_leading_dims():
    x, w = _xw(3, 1040, 256, 128)
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x)
    flat = tk2.int8_matmul_reference(xt, tq, ts, torch.float32)
    lead = tk2.int8_matmul_reference(xt.reshape(8, 130, 256), tq, ts,
                                     torch.float32)
    assert torch.equal(lead.reshape(1040, 128), flat)


@pytest.mark.parametrize("x_shape,k,n", [
    ((1040, 256), 256, 128),            # taken
    ((1040, 100), 100, 128),            # K not a multiple of 128
    ((64, 256), 256, 128),              # too few rows
    ((512, 49152), 49152, 128),         # the corners of the weight gate
    ((512, 128), 128, 49152),
    ((512, 2048), 2048, 3072),
    ((512, 6144), 6144, 1024),
    ((512, 6144), 6144, 1152),          # 6.75 MiB of weight: refused
    ((2, 256, 3072), 3072, 768),        # leading dims: 512 rows
    ((511, 3072), 3072, 768),
    ((530, 256), 128, 256),             # x does not match the weight
])
def test_supported_agrees_with_jax(x_shape, k, n):
    """The same gate, the weight given in each package's layout."""
    assert tk2.supported(x_shape, (n, k)) == jk2.supported(x_shape, (k, n))


def test_wrapper_takes_the_plain_version_on_cpu_and_checks():
    x, w = _xw(4, 1040, 256, 128)
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x)
    before = tk2.int8_matmul.launches
    got = tk2.int8_matmul(xt, tq, ts, torch.float32)
    assert tk2.int8_matmul.launches == before
    assert torch.equal(got, tk2.int8_matmul_reference(xt, tq, ts,
                                                      torch.float32))
    with pytest.raises(ValueError):                 # a float weight
        tk2.int8_matmul(xt, torch.from_numpy(w.T.copy()), ts, torch.float32)
    with pytest.raises(ValueError):                 # float16 x
        tk2.int8_matmul(xt.half(), tq, ts, torch.float32)
    with pytest.raises(ValueError):                 # non-contiguous weight
        wide = torch.zeros(128, 512, dtype=torch.int8)
        tk2.int8_matmul(xt, wide[:, ::2], ts, torch.float32)
    with pytest.raises(ValueError):                 # unsupported shape
        tk2.int8_matmul(xt[:64], tq, ts, torch.float32)


def test_narrow_site_routes_to_k2(monkeypatch):
    """tests/test_int8.py:247-249's gates: every site compute-bound and
    narrow. With NARROW_SITES on, int8_linear calls K2's wrapper once, and
    the result equals the plain s8 route; an unsupported shape falls
    through to the dequant route, as in JAX; with NARROW_SITES off K2 is
    not called."""
    monkeypatch.setattr(tint8, "INT8_DYNQUANT_MIN_FLOPS", 0)
    monkeypatch.setattr(tint8, "INT8_DYNQUANT_MIN_WIDTH", 10 ** 9)
    calls = []
    real = tk2.int8_matmul
    monkeypatch.setattr(tk2, "int8_matmul",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    x, w = _xw(8, 520, 256, 128)
    tq, ts = quantize_weight(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x)
    off = tint8.int8_linear(xt, tq, ts, torch.float32)
    assert calls == []
    monkeypatch.setattr(tint8, "NARROW_SITES", True)
    got = tint8.int8_linear(xt, tq, ts, torch.float32)
    assert calls == [(520, 256)]
    monkeypatch.setattr(tint8, "INT8_DYNQUANT_MIN_WIDTH", 0)
    monkeypatch.setattr(tint8, "NARROW_SITES", False)
    s8 = tint8.int8_linear(xt, tq, ts, torch.float32)
    assert torch.equal(got, s8)
    # 64 rows: below the row gate, so the dequant route, as without K2
    monkeypatch.setattr(tint8, "INT8_DYNQUANT_MIN_WIDTH", 10 ** 9)
    monkeypatch.setattr(tint8, "NARROW_SITES", True)
    small = tint8.int8_linear(xt[:64], tq, ts, torch.float32)
    assert len(calls) == 1
    assert torch.equal(small, off[:64])


# feat 128, hidden 512 (K and N multiples of 128), 4 items x 4 tags x 32
# text tokens = 512 text rows, K2's row gate; 4 image tokens
D, HEADS, SEQ, IMGS, B, T = 128, 4, 32, 4, 4, 4


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randn(B, T, SEQ, D).astype(np.float32)
    img = rng.randn(B, IMGS, D).astype(np.float32)
    index = np.stack([rng.permutation(T) for _ in range(B)]).astype(np.int32)
    return text, img, index


@pytest.fixture
def narrow_routing(monkeypatch):
    """Both packages in K2's routing: every weight int8, every site
    compute-bound, the production width gate (N < 1024 is narrow), the
    fused FFN off and the narrow sites on."""
    for mod in (jint8, tint8):
        monkeypatch.setattr(mod, "INT8_MIN_KERNEL_ELEMENTS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_FLOPS", 0)
    monkeypatch.setattr(jint8, "PALLAS_FUSED_FFN", False)
    monkeypatch.setattr(jint8, "PALLAS_NARROW_SITES", True)
    monkeypatch.setattr(tint8, "FUSED_FFN", False)
    monkeypatch.setattr(tint8, "NARROW_SITES", True)


@pytest.mark.parametrize("kind", ["score", "seq"])
def test_int8_models_in_the_narrow_routing_match_jax(kind, narrow_routing,
                                                     monkeypatch):
    """The same sites take K2 in both packages: each trunk's text_proj fc1
    and fc2, the XiT's queries, projection, fc1 and fc2 over the 512 text
    rows (the image rows and out_layer's rows are below the row gate).
    Scores within tests/test_torch_ppo.py's int8 bound (2% of the spread)
    and a tenth of it on average: a value on a tie of the quantization,
    one ulp apart in the two frameworks, moves an int8 step, and the
    chained sites carry that step to a few of the outputs."""
    counts = {"jax": 0, "torch": 0}
    jreal, treal = jk2.pallas_int8_matmul, tk2.int8_matmul_reference

    def jspy(*a, **k):
        counts["jax"] += 1
        return jreal(*a, **k)

    def tspy(*a, **k):
        counts["torch"] += 1
        return treal(*a, **k)

    monkeypatch.setattr(jk2, "pallas_int8_matmul", jspy)
    monkeypatch.setattr(tk2, "int8_matmul_reference", tspy)
    text, img, index = _inputs()
    cfg = ModelConfig(feat_size=D, seq_length=SEQ, max_imgs=IMGS,
                      visual_feat_dim=D, num_heads=HEADS, drop_p=0.0,
                      forward_drop_p=0.0)
    jargs = [jnp.asarray(text), jnp.asarray(img)]
    if kind == "seq":
        jargs.append(jnp.asarray(index))
    jcls, tcls = (JScore, ScoreModel) if kind == "score" else (JSeq,
                                                             SeqScoreModel)
    params = jcls(cfg).init(jax.random.PRNGKey(5), *jargs)
    sd = quantize_state_dict(
        params_from_flax(jax.tree.map(np.asarray, params)), torch.float32)
    qparams = quantize_tree(params, jnp.float32)
    ref = np.asarray(jcls(dataclasses.replace(cfg, int8=True)).apply(
        qparams, *jargs), np.float32)
    model = tcls(dataclasses.replace(cfg, int8=True), device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (text, img, index)[:len(jargs)]))
    got = got.float().numpy()
    # text_proj fc1/fc2 and the XiT's queries, projection, fc1 and fc2
    assert counts["torch"] == counts["jax"] == 6
    diff = np.abs(got - ref)
    spread = float(np.abs(ref).max()) + 1e-6
    assert diff.mean() < 0.002 * spread
    assert diff.max() < 0.02 * spread
