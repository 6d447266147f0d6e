"""The rest of the tower zoo against the JAX package, on the CPU, at a tiny
size (vocabulary 30, 9 positions, a padded row in every batch): rnn, lstm,
gru, lstm with `bidirectional`, the birnn, bilstm and bigru stacks at 2
layers (where they differ from bidirectional=True), the gated CNN at 3
layers in blocks of 2, the dual encoder with and without tied weights, the
clr target's loss, correct count and n, and one AdamW step of an lstm + lm,
a bilstm + bilm, a tiny clip tower, a gated CNN + lm and a speech seq2seq
tower (the loss and every updated parameter, the decay of the gated CNN's
and the speech convolutions' biases among them). Each case carries the JAX
tree across with `tower_params_from_flax`; the gated CNN also loads from a reference-layout
`.bin` with split biases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.config import Config as JConfig
from lr2ppo_tpu.towers import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_tpu.train import pretrain as jtrain
from lr2ppo_tpu.train.common import init_state as jinit_state
from lr2ppo_tpu.train.optim import build_optimizer as jbuild_optimizer
from lr2ppo_torch.config import Config
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint,
                                 tower_params_from_flax)
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.train import pretrain as ttrain
from lr2ppo_torch.train.common import TrainState
from lr2ppo_torch.train.optim import build_optimizer, no_decay_names

torch.set_num_threads(1)

V, S, B = 30, 9, 3
# float32 on both sides, the products and the recurrences summed in other
# orders: each output within RTOL of its tensor's largest magnitude
RTOL = 1e-5
# one AdamW step at lr 1e-2 (no bias correction) moves an element by
# lr * 0.1 g / (0.032 |g| + 1e-6): where |g| is near eps that amplifies a
# gradient's float32 rounding (~1e-8 here) by up to lr * 0.1 / eps = 1e3,
# so an update is held to 1e-3 of lr
STEP_ATOL = 1e-5


def raw_cfg(**kw):
    return {**dict(emb_size=12, hidden_size=16, feedforward_size=32,
                   heads_num=4, layers_num=2, dropout=0.0, max_seq_length=16,
                   vocab_size=V, embedding=["word", "pos"],
                   encoder="lstm", target=["lm"]), **kw}


def _inputs(seed=0, s=S):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, s)).astype(np.int32)
    seg = np.ones((B, s), np.int32)
    seg[1, s - 3:] = 0
    seg[2, 4:] = 0
    src = src * seg
    tgt = (np.roll(src, -1, axis=1) * seg).astype(np.int32)
    return src, tgt, seg


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


def _pair(raw, src, tgt, seg, seed=0):
    """(JAX model, its params as numpy, the port's model on them)."""
    jmodel = JTowerModel(JTowerConfig.from_dict(raw))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), src, tgt, seg))
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    model.load_state_dict(tower_params_from_flax(params), strict=True)
    return jmodel, params, model


def _t(x):
    return (tuple(_t(v) for v in x) if isinstance(x, tuple)
            else torch.from_numpy(np.asarray(x)))


ENCODERS = {
    "rnn": dict(encoder="rnn"),
    "lstm": dict(encoder="lstm"),
    "gru": dict(encoder="gru"),
    "lstm_bidirectional": dict(encoder="lstm", bidirectional=True),
    "birnn": dict(encoder="birnn"),
    "bilstm": dict(encoder="bilstm"),
    "bigru": dict(encoder="bigru"),
    "gatedcnn": dict(encoder="gatedcnn", layers_num=3, block_size=2,
                     kernel_size=3),
}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoder_matches_jax(case):
    """The encoder's output on JAX's weights, padded rows included, and
    the key layout: torch's flat names under `encoder.rnn` (the bi-stacks'
    `rnn_forward` / `rnn_backward`), the gated CNN's 4-D Conv2d kernels."""
    raw = raw_cfg(**ENCODERS[case])
    src, tgt, seg = _inputs(1)
    jmodel, params, model = _pair(raw, src, tgt, seg)
    want = jmodel.apply(params, src, seg, method=JTowerModel.encode)
    got = model.encode(_t(src), _t(seg))
    assert got.shape == want.shape
    _close(got.detach(), want, case)
    keys = set(model.state_dict())
    if case == "gatedcnn":
        assert model.state_dict()["encoder.conv_1.weight"].shape == \
            (16, 1, 3, 12)
        assert model.state_dict()["encoder.gate.1.weight"].shape == \
            (16, 16, 3, 1)
    elif case.startswith("bi"):
        assert {"encoder.rnn_forward.weight_ih_l1",
                "encoder.rnn_backward.bias_hh_l0"} <= keys
    else:
        assert "encoder.rnn.weight_hh_l1" in keys
        assert ("encoder.rnn.weight_ih_l1_reverse" in keys) == (
            case == "lstm_bidirectional")


def test_bi_stacks_differ_from_bidirectional_at_two_layers():
    """bilstm's second layer reads one direction, bidirectional's both:
    their layer-1 input widths differ."""
    stack = TowerModel(TowerConfig.from_dict(raw_cfg(encoder="bilstm")))
    bidir = TowerModel(TowerConfig.from_dict(raw_cfg(encoder="lstm",
                                                     bidirectional=True)))
    assert stack.state_dict()["encoder.rnn_forward.weight_ih_l1"].shape == \
        (32, 8)
    assert bidir.state_dict()["encoder.rnn.weight_ih_l1"].shape == (32, 16)


def test_gatedcnn_loads_a_reference_bin_with_split_biases(tmp_path):
    """A reference `.bin` carries each convolution's Conv2d bias and a
    second per-channel bias (`conv_b1`, `conv_b.<i>`, `gate_b1`,
    `gate_b.<i>`): load_tower_checkpoint folds them into the one bias, and
    the tower loads strict and equals the folded form."""
    raw = raw_cfg(**ENCODERS["gatedcnn"])
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    init_weights(model, torch.Generator().manual_seed(2))
    folded = model.state_dict()
    gen = torch.Generator().manual_seed(3)
    split = dict(folded)
    for tag in ("conv", "gate"):
        for conv, extra in [(f"{tag}_1", f"{tag}_b1")] + [
                (f"{tag}.{i}", f"{tag}_b.{i}") for i in range(2)]:
            second = torch.randn(1, 16, 1, 1, generator=gen)
            split[f"encoder.{extra}"] = second
            split[f"encoder.{conv}.bias"] = (folded[f"encoder.{conv}.bias"]
                                            - second.reshape(-1))
    path = str(tmp_path / "gatedcnn.bin")
    torch.save(split, path)
    loaded = load_tower_checkpoint(path)
    again = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    again.load_state_dict(loaded, strict=True)
    src, tgt, seg = _inputs(2)
    with torch.no_grad():
        np.testing.assert_allclose(
            again.encode(_t(src), _t(seg)).numpy(),
            model.encode(_t(src), _t(seg)).numpy(), rtol=0, atol=1e-5)
    for k, v in folded.items():
        np.testing.assert_allclose(loaded[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def dual_raw(tie=False, **kw):
    """Stream 0: a causal transformer over words (last pooling); stream 1:
    a ViT-style transformer over 16 x 16 images at patch 8 (first pooling),
    or, untied, a gru over words of its own widths."""
    text = dict(embedding=["word", "pos"], encoder="transformer",
                mask="causal", pooling="last", hidden_size=16, emb_size=16)
    image = dict(embedding=["patch", "pos"], encoder="transformer",
                 pooling="first", hidden_size=16, emb_size=16,
                 layernorm_positioning="pre")
    return raw_cfg(**{**dict(encoder="dual", target=["clr"],
                             projection=True, feature_size=8,
                             image_height=16, image_width=16, patch_size=8,
                             tie_weights=tie, stream_0=text,
                             stream_1=image), **kw})


def _dual_inputs(seed=0):
    src, _, seg = _inputs(seed)
    rng = np.random.RandomState(seed + 1)
    img = rng.rand(B, 3, 16, 16).astype(np.float32)
    return (src, img), np.arange(B, dtype=np.int32), (seg, np.ones((B, 5),
                                                                   np.int32))


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_dual_encoder_matches_jax(tie):
    """Both streams' outputs; tied, only `encoder.encoder_0` holds weights
    and both streams run it."""
    raw = dual_raw(tie)
    src, tgt, seg = _dual_inputs(3)
    jmodel, params, model = _pair(raw, src, tgt, seg)
    want = jmodel.apply(params, src, seg, method=JTowerModel.encode)
    got = model.encode(_t(src), _t(seg))
    for i in range(2):
        _close(got[i].detach(), want[i], f"stream {i}")
    keys = set(model.state_dict())
    assert "embedding_1.patch.projection.weight" in keys
    assert any(k.startswith("encoder.encoder_1.") for k in keys) != tie


def test_dual_streams_of_other_encoders_match_jax():
    """An untied dual tower whose second stream is a gru of its own
    hidden size, with mean pooling: the overlay reaches the encoder, the
    embedding and the clr projection."""
    raw = dual_raw(False)
    raw["stream_1"] = dict(embedding=["word"], encoder="gru",
                           hidden_size=24, emb_size=12, pooling="mean")
    src, tgt, seg = _dual_inputs(4)
    src, seg = (src[0], src[0][:, ::-1].copy()), (seg[0], seg[0])
    jmodel, params, model = _pair(raw, src, tgt, seg)
    for got, want in zip(model(_t(src), _t(tgt), _t(seg)),
                         jmodel.apply(params, src, tgt, seg)):
        _close(got.detach(), want, "clr")
    assert model.state_dict()["target.clr.encoder_1_projection"].shape == \
        (24, 8)


def test_clr_loss_and_accuracy_match_jax():
    """The symmetric cross-entropy, the symmetric retrieval count (with its
    own n) and every gradient, logit_scale's and the projections' among
    them."""
    raw = dual_raw(False)
    src, tgt, seg = _dual_inputs(5)
    jmodel, params, model = _pair(raw, src, tgt, seg)

    def loss_fn(p):
        return jmodel.apply({"params": p}, src, tgt, seg)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params["params"]))
    _, jcorrect, jn = jmodel.apply(params, src, tgt, seg)
    loss, correct, n = model(_t(src), _t(tgt), _t(seg))
    loss.backward()
    _close(loss.detach(), jloss, "loss")
    assert float(correct) == float(jcorrect) and float(n) == float(jn) == B
    want = tower_params_from_flax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(float(np.abs(w).max()),
                                                   1e-2 * top), err_msg=k)


def _lm_batch(seed):
    src, tgt, seg = _inputs(seed)
    return {"src": src, "tgt": tgt, "seg": seg}


def _bilm_batch(seed):
    src, tgt, seg = _inputs(seed)
    bwd = (np.roll(src, 1, axis=1) * seg).astype(np.int32)
    return {"src": src, "tgt_fwd": tgt, "tgt_bwd": bwd, "seg": seg}


def _clip_batch(seed):
    (src, img), tgt, (seg, seg_img) = _dual_inputs(seed)
    return {"src_text": src, "seg_text": seg, "src_image": img,
            "seg_image": seg_img, "tgt": tgt}


FRAMES, N_MELS = 16, 80


def _speech_batch(seed):
    """16 frames of 80 bins (4 positions after the two stride-2
    convolutions), a padded target row."""
    rng = np.random.RandomState(seed)
    src = rng.standard_normal((B, FRAMES, N_MELS)).astype(np.float32)
    seg = np.ones((B, FRAMES // 4), np.int32)
    seg[1, 3:] = 0
    tgt_in = rng.randint(5, V, (B, 6)).astype(np.int32)
    tgt_seg = np.ones((B, 6), np.int32)
    tgt_seg[2, 4:] = 0
    tgt_in *= tgt_seg
    tgt_out = (np.roll(tgt_in, -1, axis=1) * tgt_seg).astype(np.int32)
    return {"src": src, "tgt_out": tgt_out, "seg": seg, "tgt_in": tgt_in,
            "tgt_seg": tgt_seg}


def _speech_biases(params, rng):
    """JAX starts the speech convolutions' biases at 0, where decay moves
    nothing: N(0, 1) instead, so the step shows whether they decay."""
    speech = params["params"]["embedding"]["speech"]
    for k in speech:
        if k.endswith("_bias"):
            speech[k] = rng.standard_normal(speech[k].shape).astype(
                np.float32)
    return params


SPEECH_RAW = raw_cfg(emb_size=16, hidden_size=16, encoder="transformer",
                     embedding=["speech", "sinusoidalpos"],
                     tgt_embedding=["word", "sinusoidalpos"],
                     decoder="transformer", target=["lm"],
                     layernorm_positioning="pre", max_audio_frames=FRAMES)

# (tower config, batch form, batch maker[, a change to JAX's init])
STEPS = {
    "lstm_lm": (raw_cfg(encoder="lstm", layers_num=2), "simple", _lm_batch),
    "bilstm_bilm": (raw_cfg(encoder="bilstm", target=["bilm"]), "bilm",
                    _bilm_batch),
    "clip": (dual_raw(False), "clip", _clip_batch),
    "gatedcnn_lm": (raw_cfg(**ENCODERS["gatedcnn"]), "simple", _lm_batch),
    "speech_s2t": (SPEECH_RAW, "seq2seq", _speech_batch, _speech_biases),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_one_training_step_matches_jax(case):
    """One AdamW step (a constant lr of 1e-2, dropout 0) of JAX's
    make_pretrain_step_form and the port's make_pretrain_step from the same
    weights and batch: the step's loss and accuracy, and every parameter
    after the update (all of them moved)."""
    raw, form, make, *prepare = STEPS[case]
    mb = make(7)
    jmodel = JTowerModel(JTowerConfig.from_dict(raw))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), *jtrain.form_args(form, mb)))
    for change in prepare:
        params = change(params, np.random.RandomState(8))
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.optim.learning_rate, c.optim.scheduler = 1e-2, "constant"
    tx = jbuild_optimizer(jcfg.optim, 10)
    jstep = jtrain.make_pretrain_step_form(jmodel, tx, 1, form)
    jstate, jm = jstep(jinit_state(jax.tree.map(jnp.asarray, params), tx),
                       jax.random.PRNGKey(1),
                       {k: jnp.asarray(v)[None] for k, v in mb.items()})
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    model.load_state_dict(tower_params_from_flax(params), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, build_optimizer(
        cfg.optim, dict(model.named_parameters()), 10,
        no_decay=no_decay_names(model)))
    m = ttrain.make_pretrain_step(1, form=form)(
        state, torch.Generator().manual_seed(0),
        {k: torch.from_numpy(v) for k, v in mb.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]), atol=1e-6)
    want = tower_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert not torch.equal(got[k], start[k]), k
        if k.endswith("self_attn.linear_layers.1.bias"):
            # the key bias's gradient is 0 but for rounding (softmax does
            # not see a constant added to every key), so its Adam step is
            # that rounding's sign in either package
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=STEP_ATOL + RTOL * float(
                                       w.abs().max()), err_msg=k)


def test_init_styles():
    """The JAX package's init styles, seeded: recurrent weights and biases
    U(+-1/sqrt(hs)), gated-CNN kernels N(0, 0.02) and biases N(0, 1), the
    clr projections N(0, 1) and logit_scale ln(1 / 0.07)."""
    gen = torch.Generator().manual_seed(0)
    lstm = TowerModel(TowerConfig.from_dict(raw_cfg(hidden_size=64)))
    init_weights(lstm, gen)
    w = lstm.state_dict()["encoder.rnn.weight_hh_l0"]
    assert float(w.abs().max()) <= 1 / 8 and float(w.abs().max()) > 0.12
    cnn = TowerModel(TowerConfig.from_dict(raw_cfg(
        **ENCODERS["gatedcnn"], hidden_size=64)))
    init_weights(cnn, gen)
    sd = cnn.state_dict()
    assert abs(float(sd["encoder.conv.0.weight"].std()) - 0.02) < 0.002
    assert abs(float(sd["encoder.gate_1.bias"].std()) - 1.0) < 0.3
    dual = TowerModel(TowerConfig.from_dict(dataclasses.asdict(
        TowerConfig.from_dict(dual_raw(False, feature_size=64)))),
        with_target=True)
    init_weights(dual, gen)
    sd = dual.state_dict()
    assert abs(float(sd["target.clr.encoder_0_projection"].std()) - 1) < 0.1
    assert float(sd["target.clr.logit_scale"]) == pytest.approx(
        np.log(1 / 0.07), rel=1e-7)
