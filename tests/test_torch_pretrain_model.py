"""The towers' training path against the JAX package, on the CPU, at a tiny
size (2 layers of 16, 4 heads, vocabulary 40): every target's loss, correct
count and denominator on bridged weights; the tower's loss and every
parameter's gradient against jax.grad at dropout 0; the dropout sites
(hash dropout bit for bit against JAX's `_apply` at each site, 1 + 3 x
layers of them, the fused-attention gate off in training mode); `remat` of
the tower encoder and of the fusion trunk (the same gradients and generator
state, bit for bit); and the weight bridge with the target keys, both ways,
including a JAX pickle checkpoint."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.ops import hash_dropout as jhd
from lr2ppo_tpu.towers import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers import torch_tower_to_flax
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_tpu.train import checkpoints as jckpt
from lr2ppo_torch.config import ModelConfig
from lr2ppo_torch.models.layers import init_weights as init_fusion_weights
from lr2ppo_torch.models.scorer import ScoreModel
from lr2ppo_torch.ops import hash_dropout as thd
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint,
                                 tower_params_from_flax)
from lr2ppo_torch.towers import layers as tlayers
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.towers.torch_import import encoder_state
from lr2ppo_torch.train.checkpoints import save_model

torch.set_num_threads(1)

V, S, B, LAYERS = 40, 12, 3, 2
# float32 on both sides; the two sum in other orders
RTOL = 1e-5


def raw_cfg(**kw):
    return {**dict(emb_size=16, hidden_size=16, feedforward_size=32,
                   heads_num=4, layers_num=LAYERS, dropout=0.0,
                   max_seq_length=16, vocab_size=V,
                   embedding=["word", "pos", "seg"], encoder="transformer",
                   mask="fully_visible", layernorm_positioning="post",
                   target=["mlm"], labels_num=3), **kw}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    seg = np.array([[1] * S, [1] * 7 + [2] * 3 + [0] * 2, [1] * 4 + [0] * 8],
                   np.int32)
    tok = (np.where(rng.rand(B, S) < 0.5, rng.randint(5, V, (B, S)), 0)
           * (seg > 0)).astype(np.int32)
    tok[0, 1] = src[0, 1] = 9        # some masked positions to get right
    return src, seg, tok, rng


def _targets(kind, tok, rng):
    """The tgt of each target kind, as numpy."""
    if kind in ("mlm", "lm"):
        return tok
    if kind == "bilm":
        return (tok, np.roll(tok, 1, axis=1))
    if kind == "cls":
        return rng.randint(0, 3, B).astype(np.int32)
    if kind == "sp":
        return rng.randint(0, 2, B).astype(np.int32)
    raise KeyError(kind)


TARGET_CASES = {
    "mlm": dict(target=["mlm"]),
    "mlm_factorized": dict(target=["mlm"], emb_size=8,
                           factorized_embedding_parameterization=True),
    "lm": dict(target=["lm"], mask="causal"),
    "lm_smoothed": dict(target=["lm"], mask="causal", label_smoothing=0.1,
                        has_lmtarget_bias=True),
    "bilm": dict(target=["bilm"]),
    "cls": dict(target=["cls"], pooling="mean"),
    "cls_max": dict(target=["cls"], pooling="max"),
    "sp": dict(target=["sp"]),
    "composite": dict(target=["mlm", "sp"]),
}


def _tgt(raw, tok, rng):
    kinds = raw["target"]
    if len(kinds) == 1:
        return _targets(kinds[0], tok, rng)
    return {k: _targets(k, tok, rng) for k in kinds}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _jax_model(raw, src, tgt, seg, seed=0):
    model = JTowerModel(JTowerConfig.from_dict(raw))
    params = model.init(jax.random.PRNGKey(seed), src, tgt, seg)
    return model, jax.tree.map(np.asarray, params)


def _port_model(raw, params, **kw):
    cfg = TowerConfig.from_dict(raw)
    model = TowerModel(cfg, with_target=True, **kw)
    model.load_state_dict(tower_params_from_flax(params), strict=True)
    return model


def _parts(out):
    """A target's output as a list of tuples of floats, one per target."""
    if isinstance(out, dict):
        return [p for k in sorted(out) for p in _parts(out[k])]
    return [tuple(float(np.asarray(v)) for v in out)]


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_targets_match_jax(case):
    """Loss to 1e-5 relative, correct and denominator exactly."""
    raw = raw_cfg(**TARGET_CASES[case])
    src, seg, tok, rng = _inputs(1)
    tgt = _tgt(raw, tok, rng)
    jmodel, params = _jax_model(raw, src, tgt, seg)
    want = _parts(jmodel.apply(params, src, tgt, seg))
    model = _port_model(raw, params)
    with torch.no_grad():
        got = _parts(model(torch.from_numpy(src), _to_torch(tgt),
                           torch.from_numpy(seg)))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL)
        assert g[1:] == w[1:], (case, got, want)


@pytest.mark.parametrize("ln", ["post", "pre"])
def test_tower_loss_and_every_gradient_match_jax_grad(ln):
    """MLM loss and the gradient of every parameter (embedding, encoder,
    target) at dropout 0, each within 1e-5 of its tensor's largest
    magnitude (or of 1% of the model's largest gradient, if larger)."""
    raw = raw_cfg(layernorm_positioning=ln)
    src, seg, tok, _ = _inputs(2)
    jmodel, params = _jax_model(raw, src, tok, seg, seed=3)

    def loss_fn(p):
        return jmodel.apply({"params": p}, src, tok, seg,
                            deterministic=False)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params["params"]))
    want = tower_params_from_flax(jax.tree.map(np.asarray, jgrads))
    model = _port_model(raw, params)
    loss = model(torch.from_numpy(src), torch.from_numpy(tok),
                 torch.from_numpy(seg), deterministic=False,
                 generator=torch.Generator().manual_seed(0))[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in got.items():
        w = want[k].numpy()
        # the key projection's bias has a zero gradient but for rounding
        # (softmax ignores a shift shared by every key): a tensor's scale is
        # floored at 1% of the largest gradient of the model
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=RTOL * scale,
                                   err_msg=k)


def _record_hash_sites(monkeypatch):
    """Wrap the port's hash_dropout: every call's input, seed, rate and
    output."""
    sites, real = [], thd.hash_dropout

    def rec(x, seed, rate):
        y = real(x, seed, rate)
        sites.append((x.detach().clone(), seed, rate, y.detach().clone()))
        return y

    monkeypatch.setattr(thd, "hash_dropout", rec)
    return sites


@pytest.mark.parametrize("ln", ["post", "pre"])
def test_hash_dropout_sites_are_jaxs_apply_bit_for_bit(monkeypatch, ln):
    """A training forward reaches 1 + 3 x layers sites (the embedding, then
    per layer the attention probabilities and the two residual branches),
    each the JAX `_apply` of its input under its seed, bit for bit."""
    raw = raw_cfg(dropout=0.1, hash_dropout=True, layernorm_positioning=ln)
    src, seg, tok, _ = _inputs(3)
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    init_weights(model, torch.Generator().manual_seed(4))
    sites = _record_hash_sites(monkeypatch)
    model(torch.from_numpy(src), torch.from_numpy(tok),
          torch.from_numpy(seg), deterministic=False,
          generator=torch.Generator().manual_seed(5))
    assert len(sites) == 1 + 3 * LAYERS
    shapes = [tuple(x.shape) for x, *_ in sites]
    assert shapes == [(B, S, 16)] + [(B, 4, S, S), (B, S, 16),
                                     (B, S, 16)] * LAYERS
    assert len({seed for _, seed, _, _ in sites}) == len(sites)
    for x, seed, rate, y in sites:
        want = jhd._apply(jnp.asarray(x.numpy()), jnp.int32(seed), rate)
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))
        assert rate == 0.1
    # evaluation reaches none
    sites.clear()
    with torch.no_grad():
        model(torch.from_numpy(src), torch.from_numpy(tok),
              torch.from_numpy(seg))
    assert sites == []


def test_training_pass_takes_the_plain_attention(monkeypatch):
    """pallas_attention routes a deterministic pass through the fused
    kernel's wrapper, once per layer; a training pass never reaches it
    (the kernel has no backward) and equals the same pass with the option
    off."""
    calls = []
    real = tlayers.fused_attention

    def rec(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tlayers, "fused_attention", rec)
    src, seg, tok, _ = _inputs(4)
    on = TowerModel(TowerConfig.from_dict(raw_cfg(
        dropout=0.1, hash_dropout=True, pallas_attention=True)),
        with_target=True)
    init_weights(on, torch.Generator().manual_seed(6))
    off = TowerModel(TowerConfig.from_dict(raw_cfg(
        dropout=0.1, hash_dropout=True)), with_target=True)
    off.load_state_dict(on.state_dict(), strict=True)
    args = (torch.from_numpy(src), torch.from_numpy(tok),
            torch.from_numpy(seg))
    with torch.no_grad():
        on(*args)
    assert len(calls) == LAYERS
    calls.clear()
    got = on(*args, deterministic=False,
             generator=torch.Generator().manual_seed(7))
    want = off(*args, deterministic=False,
               generator=torch.Generator().manual_seed(7))
    assert calls == []
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("hash_on", [True, False], ids=["hash", "canonical"])
def test_tower_remat_gives_the_same_gradients_and_generator(monkeypatch,
                                                            hash_on):
    """remat recomputes each layer in the backward (the layers' hash sites
    run twice) with the forward's seeds: the gradients and the generator's
    state after the step are those without remat, bit for bit."""
    raw = raw_cfg(dropout=0.1, hash_dropout=hash_on)
    src, seg, tok, _ = _inputs(5)
    args = (torch.from_numpy(src), torch.from_numpy(tok),
            torch.from_numpy(seg))
    runs = {}
    for remat in (False, True):
        model = TowerModel(TowerConfig.from_dict({**raw, "remat": remat}),
                           with_target=True)
        init_weights(model, torch.Generator().manual_seed(8))
        gen = torch.Generator().manual_seed(9)
        sites = _record_hash_sites(monkeypatch)
        loss = model(*args, deterministic=False, generator=gen)[0]
        loss.backward()
        monkeypatch.undo()
        runs[remat] = (float(loss.detach()), _grads(model), gen.get_state(),
                       len(sites))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = runs[False], runs[True]
    assert l0 == l1
    assert g0.keys() == g1.keys() and len(g0) > 0
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(s0, s1)
    if hash_on:
        assert (n0, n1) == (1 + 3 * LAYERS, 1 + 6 * LAYERS)


@pytest.mark.parametrize("hash_on", [True, False], ids=["hash", "canonical"])
def test_fusion_trunk_remat_gives_the_same_gradients_and_generator(hash_on):
    """ModelConfig.remat on the ScoreModel's trunk, dropout on."""
    base = ModelConfig(feat_size=16, seq_length=4, max_imgs=3,
                       visual_feat_dim=16, num_heads=2, drop_p=0.1,
                       forward_drop_p=0.1, hash_dropout=hash_on)
    rng = np.random.RandomState(0)
    text = torch.from_numpy(rng.randn(2, 3, 4, 16).astype(np.float32))
    img = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    runs = {}
    for remat in (False, True):
        model = ScoreModel(dataclasses.replace(base, remat=remat))
        init_fusion_weights(model, torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        out = model(text, img, False, gen)
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        runs[remat] = (out.detach(), _grads(model), gen.get_state())
    (o0, g0, s0), (o1, g1, s1) = runs[False], runs[True]
    assert torch.equal(o0, o1)
    assert g0.keys() == g1.keys() and len(g0) > 0
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(s0, s1)


def test_bridge_carries_the_target_both_ways(tmp_path):
    """A JAX tower tree with its target subtree loads strict into the port's
    TowerModel (also from a JAX pickle checkpoint, the pretrainer's -best
    form); the port's `.bin` goes back to the same JAX tree bit for bit, and
    its encoder keys load strict into a tower built for extraction."""
    raw = raw_cfg(target=["mlm", "sp"])
    src, seg, tok, rng = _inputs(6)
    _, params = _jax_model(raw, src, _tgt(raw, tok, rng), seg, seed=2)
    state = tower_params_from_flax(params)
    assert {"target.mlm.linear_1.weight", "target.mlm.layer_norm.gamma",
            "target.mlm.linear_2.bias", "target.sp.linear_2.weight"} \
        <= set(state)
    jckpt.save_checkpoint(str(tmp_path / "jax-best"), params, {"step": 1})
    loaded = load_tower_checkpoint(str(tmp_path / "jax-best"))
    assert loaded.keys() == state.keys()
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    model.load_state_dict(loaded, strict=True)
    save_model(str(tmp_path / "port.bin"), model)
    back = torch_tower_to_flax({k: v.numpy() for k, v in
                                load_tower_checkpoint(
                                    str(tmp_path / "port.bin")).items()})
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)
    tower = TowerModel(TowerConfig.from_dict(raw))
    tower.load_state_dict(encoder_state(model.state_dict()), strict=True)
    # every JAX target kind is ported; a kind outside them still raises
    with pytest.raises(KeyError, match="targets"):
        tower_params_from_flax({"params": {"target": {"mystery": {
            "logit_scale": np.zeros(())}}}})
