"""The towers' feature-extraction path against the JAX package, on the CPU:
K4's plain version against the Pallas kernel in interpret mode, the tiny
towers' `encode` (post-LN word+pos+seg text, pre-LN patch+pos image) with
weights bridged from the JAX init, the config copy and the weight bridge.
The kernel itself is held against its plain version on a card by
tests/test_torch_attention_cuda.py."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.ops import pallas_attention as j_attn
from lr2ppo_tpu.towers import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers import torch_tower_to_flax
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_torch.ops.attention import fused_attention, reference_attention
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 tower_params_from_flax)
from lr2ppo_torch.towers.layers import additive_mask_from_seg
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.towers.torch_import import encoder_state

torch.set_num_threads(1)


def _qkvb(seed, b, h, s, dh, real):
    """q, k, v (B, H, S, dh) and a 0 / -10000 key bias with `real[i]` real
    keys in row i, float32 numpy."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, dh).astype(np.float32) for _ in range(3))
    bias = np.where(np.arange(s)[None] < np.asarray(real)[:, None], 0.0,
                    -10000.0).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("shape,real", [((2, 4, 24, 16), (20, 24)),
                                        ((3, 2, 7, 4), (1, 7, 3))])
def test_attention_plain_version_matches_pallas_and_reference(shape, real):
    """tests/test_pallas_attention.py's bounds (float32)."""
    q, k, v, bias = _qkvb(0, *shape, real)
    scale = 1.0 / np.sqrt(shape[-1])
    want_pallas = np.asarray(j_attn.fused_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), scale, interpret=True))
    want_ref = np.asarray(j_attn.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), scale))
    before = fused_attention.launches
    got = fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                          scale)
    assert fused_attention.launches == before      # the CPU runs no kernel
    plain = reference_attention(*(torch.from_numpy(a)
                                  for a in (q, k, v, bias)), scale)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5, rtol=1e-4)


def test_attention_plain_version_bf16_rounds_like_jax():
    """bfloat16 q, k, v: float32 scores and softmax, probabilities rounded
    to bfloat16, float32 accumulation, a bfloat16 result: within one
    bfloat16 step of the output of JAX's reference."""
    q, k, v, bias = _qkvb(3, 2, 3, 19, 8, (19, 11))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_attn.reference_attention(jq, jk, jv,
                                                 jnp.asarray(bias), 0.25),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fused_attention(tq, tk, tv, torch.from_numpy(bias), 0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_attention_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, bias = (torch.from_numpy(a)
                     for a in _qkvb(1, 1, 2, 5, 4, (5,)))
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_attention(q.requires_grad_(True), k, v, bias, 0.5)
    with torch.no_grad():                       # no graph: allowed
        fused_attention(q, k, v, bias, 0.5)
    q = q.detach()
    big = torch.zeros(1, 2, 5, 129)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(big, big, big, bias, 0.5)
    with pytest.raises(ValueError, match="key_bias"):
        fused_attention(q, k, v, bias.double(), 0.5)
    with pytest.raises(ValueError, match="float32 or"):
        fused_attention(q.double(), k.double(), v.double(), bias, 0.5)


def text_cfg(**kw):
    """A tiny XLM-R: word + pos + seg embeddings, post-LN."""
    return {**dict(emb_size=16, hidden_size=16, feedforward_size=32,
                   heads_num=4, layers_num=2, max_seq_length=12, dropout=0.0,
                   vocab_size=30, embedding=["word", "pos", "seg"],
                   encoder="transformer", mask="fully_visible",
                   layernorm_positioning="post", target=["mlm"]), **kw}


def vit_cfg(**kw):
    """A tiny ViT: patch + pos embeddings, no embedding layer norm, pre-LN."""
    return {**dict(emb_size=16, hidden_size=16, feedforward_size=32,
                   heads_num=4, layers_num=2, dropout=0.0, max_seq_length=5,
                   embedding=["patch", "pos"],
                   remove_embedding_layernorm=True, encoder="transformer",
                   mask="fully_visible", layernorm_positioning="pre",
                   target=["cls"], image_height=8, image_width=8,
                   patch_size=4), **kw}


def _jax_tower(raw, src, seg, seed=0):
    cfg = JTowerConfig.from_dict(raw)
    model = JTowerModel(cfg)
    params = model.init(jax.random.PRNGKey(seed), src, seg,
                        method=model.encode)
    params = jax.tree_util.tree_map(np.asarray, params)
    out = model.apply(params, src, seg, method=model.encode)
    return params, np.asarray(out)


def _port_encode(raw, params, src, seg):
    cfg = TowerConfig.from_dict(raw)
    model = TowerModel(cfg)
    model.load_state_dict(tower_params_from_flax(
        params, cfg.channels_num), strict=True)
    with torch.inference_mode():
        return model.encode(torch.from_numpy(src), torch.from_numpy(seg))


def _text_inputs():
    rng = np.random.RandomState(2)
    src = rng.randint(0, 30, size=(3, 10)).astype(np.int64)
    seg = np.array([[1] * 10, [1] * 4 + [2] * 3 + [0] * 3,
                    [1] * 2 + [0] * 8], np.int64)
    return src, seg


VARIANTS = {
    "base": {},
    # one shared layer, gated FFN, T5 layer norms, tanh GELU, dh 8 != H/heads
    "variants": dict(parameter_sharing=True, feed_forward="gated",
                     layernorm="t5", hidden_act="gelu_fast",
                     attention_head_size=8),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("mask", ["fully_visible", "causal",
                                  "causal_with_prefix"])
def test_text_tower_encode_matches_jax(mask, pallas, variant):
    """The JAX tower tests' bounds (float32). With pallas_attention the
    fully-visible pass takes the fused path in both packages; the causal
    masks keep the plain path."""
    raw = text_cfg(mask=mask, pallas_attention=pallas, **VARIANTS[variant])
    src, seg = _text_inputs()
    params, want = _jax_tower(raw, src.astype(np.int32), seg.astype(np.int32))
    before = fused_attention.launches
    got = _port_encode(raw, params, src, seg)
    assert fused_attention.launches == before
    assert got.shape == (3, 10, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("pallas", [False, True])
def test_vit_tower_encode_matches_jax(pallas):
    raw = vit_cfg(pallas_attention=pallas)
    pix = np.random.RandomState(4).rand(3, 3, 8, 8).astype(np.float32)
    seg = np.ones((3, 5), np.int64)
    params, want = _jax_tower(raw, pix, seg.astype(np.int32), seed=1)
    got = _port_encode(raw, params, pix, seg)
    assert got.shape == (3, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("kind", ["text", "vit"])
def test_fused_path_gives_the_plain_paths_output(kind):
    """pallas_attention on and off, the same weights: the same features."""
    if kind == "text":
        raw, (src, seg) = text_cfg(), _text_inputs()
        jsrc = src.astype(np.int32)
    else:
        raw = vit_cfg()
        src = np.random.RandomState(5).rand(2, 3, 8, 8).astype(np.float32)
        seg, jsrc = np.ones((2, 5), np.int64), src
    params, _ = _jax_tower(raw, jsrc, seg.astype(np.int32))
    off = _port_encode({**raw, "pallas_attention": False}, params, src, seg)
    on = _port_encode({**raw, "pallas_attention": True}, params, src, seg)
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=2e-5, rtol=2e-4)


def test_additive_masks_match_jax():
    from lr2ppo_tpu.towers.layers import additive_mask_from_seg as j_mask

    _, seg = _text_inputs()
    for kind in ("fully_visible", "causal", "causal_with_prefix"):
        got = additive_mask_from_seg(torch.from_numpy(seg), kind)
        want = np.asarray(j_mask(jnp.asarray(seg), kind))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        additive_mask_from_seg(torch.from_numpy(seg), "bogus")


@pytest.mark.parametrize("make", [text_cfg, vit_cfg])
def test_bridge_round_trip_is_bit_for_bit(make):
    raw = make()
    if raw["embedding"][0] == "patch":
        src = np.zeros((1, 3, 8, 8), np.float32)
        seg = np.ones((1, 5), np.int32)
    else:
        src, seg = np.zeros((1, 6), np.int32), np.ones((1, 6), np.int32)
    params, _ = _jax_tower(raw, src, seg, seed=7)
    state = tower_params_from_flax(params)
    back = torch_tower_to_flax({k: v.numpy() for k, v in state.items()})
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)
    # and the port's model holds exactly the bridged keys
    assert set(TowerModel(TowerConfig.from_dict(raw)).state_dict()) \
        == set(state)


def test_reference_keys_and_encoder_state():
    """The TencentPretrain layout; a reference checkpoint's target heads are
    dropped before the strict load."""
    model = TowerModel(TowerConfig.from_dict(vit_cfg()))
    keys = set(model.state_dict())
    assert {"embedding.patch.projection.weight", "embedding.patch.cls_emb",
            "embedding.pos.embedding.weight",
            "encoder.transformer.1.self_attn.linear_layers.2.weight",
            "encoder.transformer.0.self_attn.final_linear.bias",
            "encoder.transformer.0.feed_forward.linear_1.weight",
            "encoder.transformer.0.layer_norm_1.gamma",
            "encoder.layer_norm.beta"} <= keys
    assert model.state_dict()["embedding.patch.projection.weight"].shape \
        == (16, 3, 4, 4)
    state = {**model.state_dict(), "target.mlm.linear_1.weight":
             torch.zeros(2, 2)}
    assert set(encoder_state(state)) == keys
    model.load_state_dict(encoder_state(state), strict=True)


def test_config_copy_has_every_field_and_parses_like_jax(tmp_path):
    names = [f.name for f in dataclasses.fields(TowerConfig)]
    assert names == [f.name for f in dataclasses.fields(JTowerConfig)]
    raw = {**text_cfg(), "embedding": "word", "target": "mlm",
           "encoder": "bilstm", "unknown_key": 3, "stream_0": {"a": 1}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    got = TowerConfig.from_json(str(path), layers_num=5)
    want = JTowerConfig.from_json(str(path), layers_num=5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_what_waits_for_pretraining_raises():
    """The decoder, T5's relative bias, sinusoidal positions, the lstm
    encoder and the contrastive target of a dual tower build, initialize and
    give a finite loss (tests/test_torch_seq2seq.py and
    tests/test_torch_encoders.py hold them against JAX), and so does a
    tower with ViLT's word_patch embedding."""
    src, seg = (torch.from_numpy(a) for a in _text_inputs())
    for kw in (dict(decoder="transformer"),
               dict(relative_position_embedding=True),
               dict(embedding=["word", "sinusoidalpos"])):
        model = TowerModel(TowerConfig.from_dict(text_cfg(**kw)),
                           with_target=True)
        init_weights(model, torch.Generator().manual_seed(0))
        tgt = torch.where(seg > 0, src, 0)
        extra = (src, seg) if "decoder" in kw else ()
        loss = model(src, tgt, seg, *extra)[0]
        assert torch.isfinite(loss), kw
    tgt = torch.where(seg > 0, src, 0)
    lstm = TowerModel(TowerConfig.from_dict(text_cfg(encoder="lstm",
                                                     target=["lm"])),
                      with_target=True)
    init_weights(lstm, torch.Generator().manual_seed(1))
    assert torch.isfinite(lstm(src, tgt, seg)[0])
    stream = dict(embedding=["word", "pos"], encoder="transformer")
    dual = TowerModel(TowerConfig.from_dict(text_cfg(
        encoder="dual", target=["clr"], projection=True, feature_size=8,
        stream_0=stream, stream_1={**stream, "pooling": "mean"})),
        with_target=True)
    init_weights(dual, torch.Generator().manual_seed(2))
    loss, correct, n = dual((src, src.flip(1)), torch.arange(3),
                            (seg, seg.flip(1)))
    assert torch.isfinite(loss) and float(n) == 3 and 0 <= float(correct) <= 3
    # the image and speech embeddings build too (tests/
    # test_torch_vision_speech.py holds them against JAX): ViLT's word_patch
    # reads a (tokens, pixels) source, with seg over text + [CLS] + patches
    vilt = TowerModel(TowerConfig.from_dict(text_cfg(
        embedding=["word_patch", "pos", "seg"], max_seq_length=16,
        image_height=8, image_width=8, patch_size=4)), with_target=True)
    init_weights(vilt, torch.Generator().manual_seed(3))
    pixels = torch.rand(3, 3, 8, 8, generator=torch.Generator().manual_seed(4))
    both = torch.cat([seg, torch.full((3, 5), 2)], dim=1)
    assert torch.isfinite(vilt((src, pixels), torch.cat(
        [tgt, torch.zeros(3, 5, dtype=tgt.dtype)], dim=1), both)[0])
    # training mode is ported (tests/test_torch_pretrain_model.py); a tower
    # built for extraction has no target to give a loss
    model = TowerModel(TowerConfig.from_dict(text_cfg()))
    src, seg = (torch.from_numpy(a) for a in _text_inputs())
    with pytest.raises(ValueError, match="encode"):
        model(src, src, seg)
