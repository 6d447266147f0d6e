"""lr2ppo_torch models against the JAX package's: Mlp, XiT, FusionTrunk
and ScoreModel (reg and cls) from the same weights through the bridge, and
the batched NDCG. Inputs come from numpy seeds; the JAX side runs as its own
tests run it (Pallas in interpret mode on this CPU backend)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.config import ModelConfig
from lr2ppo_tpu.models import Mlp as JMlp, XiT as JXiT
from lr2ppo_tpu.models.scorer import FusionTrunk as JTrunk
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.ops.int8 import quantize_tree
from lr2ppo_tpu.ops.ndcg import ndcg_from_scores as j_ndcg
from lr2ppo_torch.models import layers as tl
from lr2ppo_torch.models.scorer import FusionTrunk, ScoreModel
from lr2ppo_torch.ops import int8 as tint8
from lr2ppo_torch.ops.int8 import quantize_state_dict
from lr2ppo_torch.ops.ndcg import ndcg_from_scores
from lr2ppo_torch.train.checkpoints import params_from_flax

torch.set_num_threads(1)

# feat 128, 4 heads, 8 text tokens, 4 image tokens, 4 items x 8 tags:
# 256 text rows, enough for the fused FFN's row gate
D, HEADS, SEQ, IMGS, B, T = 128, 4, 8, 4, 4, 8
HID = 4 * D
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def model_config(**kw):
    return ModelConfig(feat_size=D, seq_length=SEQ, max_imgs=IMGS,
                       visual_feat_dim=D, num_heads=HEADS, drop_p=0.0,
                       forward_drop_p=0.0, **kw)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, SEQ, D).astype(np.float32),
            rng.randn(B, IMGS, D).astype(np.float32))


def bridge(flax_params, scope=""):
    """flax params of a whole model ("") or of one trunk module ("trunk",
    "text_proj", "xit") -> the torch module's state_dict."""
    tree = jax.tree.map(np.asarray, flax_params["params"])
    if scope == "trunk":
        tree = {"trunk": tree}
    elif scope:
        tree = {"trunk": {scope: tree}}
    sd = params_from_flax(tree)
    if scope and scope != "trunk":
        sd = {k[len(scope) + 1:]: v for k, v in sd.items()}
    return sd


@pytest.fixture
def force_int8(monkeypatch):
    """Zero the size gates on both packages (as tests/test_int8.py does) so
    these small models take every int8 route, and turn the fused FFN on in
    JAX, where the 8 fake CPU devices would turn it off."""
    for mod in (jint8, tint8):
        monkeypatch.setattr(mod, "INT8_MIN_KERNEL_ELEMENTS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_FLOPS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_WIDTH", 0)
    monkeypatch.setattr(jint8, "PALLAS_FUSED_FFN", True)
    monkeypatch.setattr(tint8, "FUSED_FFN", True)


def _pair(kind, jdt, tdt, int8, mode="reg"):
    """(flax module, torch module, bridge scope, args as numpy)."""
    text, img = inputs()
    cfg = model_config(mode=mode, int8=int8)
    if kind == "mlp":
        return (JMlp(HID, D, 0.0, dtype=jdt, int8=int8),
                tl.Mlp(D, HID, D, dtype=tdt, int8=int8), "text_proj", (text,))
    if kind == "xit":
        y = img[:, None]                                  # (B, 1, I, D)
        return (JXiT(feat_size=D, num_heads=HEADS, drop_p=0.0,
                     forward_drop_p=0.0, dtype=jdt, int8=int8),
                tl.XiT(D, HEADS, dtype=tdt, int8=int8), "xit", (text, y))
    if kind == "xit_fast":                 # scaled attention, real causal mask
        return (JXiT(feat_size=D, num_heads=HEADS, causal=True, faithful=False,
                     drop_p=0.0, forward_drop_p=0.0, dtype=jdt, int8=int8),
                tl.XiT(D, HEADS, causal=True, faithful=False, dtype=tdt,
                       int8=int8), "xit", (text, text))
    if kind == "trunk":
        return JTrunk(cfg, jdt), FusionTrunk(cfg, tdt), "trunk", (text, img)
    return JScore(cfg, jdt), ScoreModel(cfg, tdt), "", (text, img)


def run_both(kind, dtype="f32", int8=False, mode="reg"):
    jdt, tdt = DTYPES[dtype]
    jm, tm, scope, args = _pair(kind, jdt, tdt, int8, mode)
    jfloat = (jm.clone(int8=False) if kind in ("mlp", "xit", "xit_fast")
              else jm.clone(cfg=dataclasses.replace(jm.cfg, int8=False)))
    params = jfloat.init(jax.random.PRNGKey(3), *map(jnp.asarray, args))
    sd = bridge(params, scope)
    if int8:
        params = quantize_tree(params, jnp.float32 if dtype == "f32" else jdt)
        sd = quantize_state_dict(sd, tdt)
    ref = np.asarray(jm.apply(params, *map(jnp.asarray, args)), np.float32)
    tm.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).float().numpy()
    assert got.shape == ref.shape
    return got, ref


KINDS = ["mlp", "xit", "trunk", "score"]


@pytest.mark.parametrize("kind", KINDS + ["xit_fast"])
def test_forward_parity_f32(kind):
    """int8 off, float32: the same math in another summation order."""
    got, ref = run_both(kind)
    spread = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * spread)


def test_score_model_cls_parity_f32():
    got, ref = run_both("score", mode="cls")
    assert ref.shape == (B, T, 3)
    spread = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * spread)


FUSED_SITES = {"mlp": 1, "xit": 1, "trunk": 2, "score": 2}


@pytest.mark.parametrize("kind", KINDS)
def test_forward_parity_int8(kind, force_int8, monkeypatch):
    """int8 on with the fused FFN on both sides (Pallas interpret against
    the port's plain version): tests/test_int8.py's tie-flip tolerance. An
    activation one ulp apart in the two frameworks can round to the other
    int8 step, which moves the outputs it feeds by one quantization step."""
    calls = []
    real = tl.int8_mlp

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tl, "int8_mlp", spy)
    got, ref = run_both(kind, int8=True)
    # text_proj and the XiT FFN take the fused route; img_proj (16 rows)
    # and out_layer (32 rows) are below its row gate
    assert len(calls) == FUSED_SITES[kind]
    diff = np.abs(got - ref)
    spread = float(np.abs(ref).max()) + 1e-6
    assert (diff <= 1e-5 * spread).mean() > 0.98
    assert diff.max() < 0.02 * spread


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["xit", "score"])
def test_forward_parity_bf16(kind, int8, force_int8):
    """bfloat16 compute. Looser: JAX computes the XiT energies, softmax and
    GELU in bfloat16 (models/layers.py:222-223) where PyTorch's kernels
    compute in float32 and round once, so each bf16 rounding (8 bits of
    mantissa, ~0.4%) can land elsewhere; the bound is a few of those
    relative to the output spread."""
    got, ref = run_both(kind, "bf16", int8)
    diff = np.abs(got - ref)
    spread = float(np.abs(ref).max()) + 1e-6
    assert diff.mean() < 0.02 * spread
    assert diff.max() < 0.05 * spread


def test_ndcg_matches_jax_on_masked_ties():
    """Masked padding and tied scores: both sorts are stable, so ties rank
    in index order in both packages."""
    rng = np.random.RandomState(5)
    scores = rng.randint(0, 3, size=(6, 12)).astype(np.float32)   # many ties
    gold = rng.randint(0, 3, size=(6, 12)).astype(np.int32)
    mask = np.arange(12)[None] < rng.randint(1, 13, size=(6, 1))
    gold[5] = 0                                   # all-irrelevant row -> 1
    ref = np.stack([np.asarray(j_ndcg(jnp.asarray(s), jnp.asarray(g),
                                      mask=jnp.asarray(m)))
                    for s, g, m in zip(scores, gold, mask)])
    got = ndcg_from_scores(torch.from_numpy(scores), torch.from_numpy(gold),
                           mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert np.all(got[5] == 1.0)


def test_training_path_is_not_ported():
    m = tl.Mlp(D, HID, D)
    with pytest.raises(NotImplementedError):
        m(torch.zeros(2, D), deterministic=False)
