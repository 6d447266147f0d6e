"""lr2ppo_torch models against the JAX package's: Mlp, XiT, FusionTrunk,
ScoreModel (reg and cls) and SeqScoreModel from the same weights through the
bridge, eval and training (forward, gradients, hash dropout on shared
seeds), and the batched NDCG. Inputs come from numpy seeds; the JAX side runs as its own
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
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.ops import pallas_dropout as jpd
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.ops.int8 import quantize_tree
from lr2ppo_tpu.ops.ndcg import ndcg_from_scores as j_ndcg
from lr2ppo_torch.models import layers as tl
from lr2ppo_torch.models.scorer import (ActorCritic, FusionTrunk, ScoreModel,
                                        SeqScoreModel)
from lr2ppo_torch.ops import hash_dropout as thd
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


def _index(seed=1, k=4):
    """(B, K) tag positions with repeats, as the rollout's next_state."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, T, size=(B, k)).astype(np.int32)


def test_seq_score_model_eval_parity_f32():
    """The critic/reward scorer: trunk on the T tags, features gathered by
    index, position embeddings, the causal (faithful: no-op) XiT."""
    text, img = inputs()
    idx = _index()
    cfg = model_config()
    jm = JSeq(cfg)
    params = jm.init(jax.random.PRNGKey(4), *map(jnp.asarray, (text, img,
                                                               idx)))
    ref = np.asarray(jm.apply(params, *map(jnp.asarray, (text, img, idx))))
    tm = SeqScoreModel(cfg)
    tm.load_state_dict(bridge(params), strict=True)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (text, img, idx))).numpy()
    assert got.shape == ref.shape == (B,)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _seed_list(monkeypatch, n=16):
    """The same per-site seeds, in call order, for both packages: JAX's
    seed_from_key (which hash dropout calls once per site, at trace time)
    and the port's draw_seed are replaced by one fixed list each."""
    seeds = np.random.RandomState(9).randint(-2**31, 2**31 - 1, size=n)
    jseeds, tseeds = list(seeds), list(seeds)
    monkeypatch.setattr(jpd, "seed_from_key",
                        lambda key: jnp.int32(jseeds.pop(0)))
    monkeypatch.setattr(thd, "draw_seed", lambda gen: int(tseeds.pop(0)))
    return jseeds, tseeds


def _train_both(kind, cfg):
    """Training-mode output and parameter gradients of sum(out * w), JAX
    and port, from the same weights; gradients bridged to torch keys."""
    text, img = inputs()
    idx = _index()
    args = (text, img) if kind == "score" else (text, img, idx)
    jm = JScore(cfg) if kind == "score" else JSeq(cfg)
    params = jm.init(jax.random.PRNGKey(6), *map(jnp.asarray, args))
    w = np.random.RandomState(7).randn(*((B, T) if kind == "score"
                                         else (B,))).astype(np.float32)

    def loss(p):
        out = jm.apply(p, *map(jnp.asarray, args), False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(loss, has_aux=True)(params)
    tm = (ScoreModel if kind == "score" else SeqScoreModel)(cfg)
    tm.load_state_dict(bridge(params), strict=True)
    tout = tm(*map(torch.from_numpy, args), deterministic=False,
              generator=torch.Generator().manual_seed(0))
    (tout * torch.from_numpy(w)).sum().backward()
    tgrad = {k: p.grad for k, p in tm.named_parameters()}
    return (tout.detach().numpy(), np.asarray(jout), tgrad,
            bridge(jgrad))


def _assert_grads_close(tgrad, jgrad, rtol):
    """Each gradient within rtol of its largest entry. The keys' bias
    gradient is zero in exact arithmetic (a per-query constant added to
    every energy leaves the softmax unchanged), so both sides hold only
    rounding noise there: each must be below 1e-6 of the largest gradient
    of the model."""
    assert set(tgrad) == set(jgrad)
    top = max(float(np.abs(g.numpy()).max()) for g in jgrad.values())
    for k, ref in jgrad.items():
        ref = ref.numpy()
        if k.endswith("keys.bias"):
            assert float(np.abs(ref).max()) < 1e-6 * top, k
            assert float(tgrad[k].abs().max()) < 1e-6 * top, k
            continue
        scale = float(np.abs(ref).max()) + 1e-12
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


@pytest.mark.parametrize("kind", ["score", "seq"])
def test_training_forward_and_grad_parity_without_dropout(kind):
    """deterministic=False with every dropout rate 0: the training forward
    and every parameter's gradient agree with JAX at float32 (1e-4 of each
    gradient's largest entry: another summation order)."""
    tout, jout, tgrad, jgrad = _train_both(kind, model_config())
    np.testing.assert_allclose(tout, jout, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jout).max()))
    _assert_grads_close(tgrad, jgrad, 1e-4)


@pytest.mark.parametrize("kind", ["score", "seq"])
def test_training_parity_with_hash_dropout(kind, monkeypatch):
    """Hash dropout at the XiT sites (rates 0.1) on the same per-site
    seeds: the same masks in both packages, so the outputs and gradients
    agree as without dropout. The actor has 3 sites, the critic 6."""
    jseeds, tseeds = _seed_list(monkeypatch)
    cfg = dataclasses.replace(model_config(hash_dropout=True), drop_p=0.1,
                              forward_drop_p=0.1)
    tout, jout, tgrad, jgrad = _train_both(kind, cfg)
    sites = 3 if kind == "score" else 6
    assert len(jseeds) == len(tseeds) == 16 - sites
    np.testing.assert_allclose(tout, jout, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jout).max()))
    _assert_grads_close(tgrad, jgrad, 1e-4)
    # dropout is live: another seed list moves the output
    monkeypatch.setattr(thd, "draw_seed", lambda gen: 5)
    tm = ScoreModel(cfg)
    tl.init_weights(tm, torch.Generator().manual_seed(0))
    a = tm(*map(torch.from_numpy, inputs()), deterministic=False,
           generator=torch.Generator())
    b = tm(*map(torch.from_numpy, inputs()), deterministic=True)
    assert not torch.allclose(a, b)


def test_actor_critic_keys_are_the_reference_prefixes():
    ac = ActorCritic(model_config())
    keys = set(ac.state_dict())
    assert "actor.xit.0.0.1.fn.1.0.weight" in keys
    assert {"critic.pos_emb.weight", "critic.xitt.1.0.weight"} <= keys
    assert all(k.split(".")[0] in ("actor", "critic") for k in keys)
