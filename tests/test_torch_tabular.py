"""The port's tabular (LETOR) models against the JAX package's, float32 with
dropout off, each JAX tree carried across by params_from_flax and loaded
strict: ScoreModel, SeqScoreModel, the ActorCritic pair and the 2-data
TwoDataScoreModel (forward and projection), at D 32 with 4 heads and raw
dims 7 and 11; and the int8 routes of the tabular sites at the full width,
which the fused FFN (K1) never takes in either package."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.cli.pointwise_2data_infer_trad import _dims_from_params
from lr2ppo_tpu.config import ModelConfig as JModelConfig
from lr2ppo_tpu.models import layers as jlayers
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.models.scorer import TwoDataScoreModel as JTwo
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_torch.config import ModelConfig
from lr2ppo_torch.models.layers import Linear, fused_int8_ffn_ok
from lr2ppo_torch.models.scorer import (ActorCritic, ScoreModel,
                                        SeqScoreModel, TwoDataScoreModel)
from lr2ppo_torch.ops import int8 as tint8
from lr2ppo_torch.train import checkpoints as tck
from lr2ppo_torch.train.checkpoints import load_any, params_from_flax

torch.set_num_threads(1)

D, HEADS, DIMS, B, T = 32, 4, [7, 11], 3, 5
# float32 on both sides; the products sum in other orders
RTOL, ATOL = 1e-5, 1e-6


def _cfgs(**kw):
    kw = dict(feat_size=D, num_heads=HEADS, family="tabular",
              trad_dims=DIMS, **kw)
    return JModelConfig(**kw), ModelConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["reg", "cls"])
def test_score_model_matches_jax(mode):
    """A document is one token that self-attends; the trunk has no
    projections, so a JAX tabular tree loads strict (xit, out_layer of
    fan-in 2·D, head)."""
    jc, tc = _cfgs(mode=mode, labels_num=3)
    x = np.random.RandomState(0).randn(B, T, D).astype(np.float32)
    params = JScore(jc).init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = ScoreModel(tc)
    model.load_state_dict(params_from_flax(_np(params)), strict=True)
    assert not hasattr(model, "text_proj") and not hasattr(model, "img_proj")
    assert model.out_layer.fc1.in_features == 2 * D
    got = model(torch.from_numpy(x))
    assert got.shape == ((B, T) if mode == "reg" else (B, T, 3))
    _close(got, JScore(jc).apply(params, jnp.asarray(x)))


def test_seq_score_model_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, D).astype(np.float32)
    idx = rng.randint(0, T, (B, 4)).astype(np.int32)
    params = JSeq(jc).init(jax.random.PRNGKey(1), jnp.asarray(x), None,
                           jnp.asarray(idx))
    model = SeqScoreModel(tc)
    model.load_state_dict(params_from_flax(_np(params)), strict=True)
    _close(model(torch.from_numpy(x), None, torch.from_numpy(idx)),
           JSeq(jc).apply(params, jnp.asarray(x), None, jnp.asarray(idx)))


def test_actor_critic_pickle_loads_strict_both_ways(tmp_path):
    """A JAX {"actor", "critic"} pickle of tabular trees loads strict into
    the port's ActorCritic; the port's `.bin` of it reads back in the JAX
    package as the same tree."""
    jc, tc = _cfgs()
    x = jnp.asarray(np.random.RandomState(2).randn(B, 2, D), jnp.float32)
    idx = jnp.zeros((B, 4), jnp.int32)
    tree = {"actor": _np(JScore(jc).init(jax.random.PRNGKey(2), x)),
            "critic": _np(JSeq(jc).init(jax.random.PRNGKey(3), x, None,
                                         idx))}
    path = str(tmp_path / "ac.ckpt")
    jck.save_checkpoint(path, tree)
    sd = load_any(path)
    ac = ActorCritic(tc)
    ac.actor.load_state_dict(sd["actor"], strict=True)
    ac.critic.load_state_dict(sd["critic"], strict=True)
    out = str(tmp_path / "ac.bin")
    tck.save_actor_critic(out, ac.actor, ac.critic)
    back = jck.load_any(out, kind="actor_critic")
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _two_data_tree(jc):
    """Both projections, as the JAX TwoDataTrainer merges them: one init
    per raw dim, the second's projection added to the first tree."""
    rng = np.random.RandomState(3)
    xs = [rng.randn(B, T, d).astype(np.float32) for d in DIMS]
    trees = [_np(JTwo(jc).init(jax.random.PRNGKey(4), jnp.asarray(x)))
             for x in xs]
    merged = dict(trees[0]["params"])
    for k, v in trees[1]["params"].items():
        merged.setdefault(k, v)
    return {"params": merged}, xs


def test_two_data_model_matches_jax():
    """The reference's names (text_proj for 7, text_proj3 for 11), the
    input's width picks the projection; forward and project() agree with
    JAX for both domains, and the dims read from a reference-keyed
    state_dict are the JAX exporter's."""
    jc, tc = _cfgs()
    tree, xs = _two_data_tree(jc)
    sd = params_from_flax(tree)
    assert tck.trad_dims_from_state_dict(sd) == _dims_from_params(tree) \
        == DIMS
    model = TwoDataScoreModel(tc)
    model.load_state_dict(sd, strict=True)
    assert model.text_proj.fc1.in_features == 7
    assert model.text_proj3.fc1.in_features == 11
    for x in xs:
        _close(model(torch.from_numpy(x)),
               JTwo(jc).apply(tree, jnp.asarray(x)))
        rows = x.reshape(-1, x.shape[-1])
        _close(model.project(torch.from_numpy(rows)),
               JTwo(jc).apply(tree, jnp.asarray(rows),
                              method=JTwo.project))


def test_two_data_checkpoint_round_trip(tmp_path):
    """A JAX pickle of the 2-data tree and the port's `.bin` of it give the
    same dims and the same state_dict through load_any."""
    jc, tc = _cfgs()
    tree, _ = _two_data_tree(jc)
    path = str(tmp_path / "two.ckpt")
    jck.save_checkpoint(path, tree)
    model = TwoDataScoreModel(tc)
    model.load_state_dict(load_any(path), strict=True)
    out = str(tmp_path / "two.bin")
    tck.save_model(out, model)
    sd = load_any(out)
    assert tck.trad_dims_from_state_dict(sd) == DIMS
    with open(path, "rb") as f:
        want = params_from_flax(pickle.load(f)["tree"])
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k])


# the tabular int8 sites at the full width: the rollout's actor twin runs
# B·2 rows and the frozen reward's xitt B·4, at batch 256
@pytest.mark.parametrize("rows", [256 * 2, 256 * 4])
def test_int8_sites_take_the_dequant_route_as_in_jax(rows):
    """At D 768 / H 3072 the compute-bound gate (2·rows·D·H >= 50e9) needs
    10,597 rows; the tabular sites have 512 and 1,024. So neither package
    fuses the FFN (K1), and both int8 products dequantize the weight for a
    plain float product: the port's int8_linear equals its dequantized
    product bit for bit, and JAX's equals its own, and the two agree."""
    d, h = 768, 3072
    fc1 = Linear(d, h, int8=True, device="meta")
    fc2 = Linear(h, d, int8=True, device="meta")
    assert fc1.use_int8 and fc2.use_int8
    assert not fused_int8_ffn_ok(fc1, fc2, (rows // 2, 2, 1, d))
    assert not jlayers._fused_int8_ffn_ok(True, True, (rows // 2, 2, 1, d),
                                          h, d)
    assert 2 * rows * d * h < tint8.INT8_DYNQUANT_MIN_FLOPS \
        == jint8.INT8_DYNQUANT_MIN_FLOPS
    rng = np.random.RandomState(5)
    x = rng.randn(rows, d).astype(np.float32)
    w = (rng.randn(h, d) * 0.05).astype(np.float32)
    q, s = tint8.quantize_weight(torch.from_numpy(w))
    got = tint8.int8_linear(torch.from_numpy(x), q, s, torch.float32)
    deq = torch.from_numpy(x) @ (q.float() * s[:, None]).t()
    assert torch.equal(got, deq)
    jq, js = jint8.quantize_kernel(jnp.asarray(w.T))
    np.testing.assert_array_equal(np.asarray(jq), q.numpy().T)
    jgot = jint8.int8_matmul(jnp.asarray(x), jq, js, jnp.float32)
    jdeq = jnp.dot(jnp.asarray(x), (jq.astype(jnp.float32) * js))
    np.testing.assert_array_equal(np.asarray(jgot), np.asarray(jdeq))
    # outputs of magnitude ~1.4, each a 768-term float32 sum taken in
    # another order by each framework: ~768 · 2^-24 · 1.4 apart at most,
    # so an absolute 1e-5 (the models' 1e-6 is for outputs ~0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=RTOL,
                               atol=1e-5)
