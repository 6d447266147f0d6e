"""The seq2seq towers of the port against the JAX package, on the CPU, at a
tiny size (2 + 2 layers of 16, 4 heads): T5's relative position buckets
(exactly, for every relative position in [-600, 600]), the relative bias and
attention with the bias and the chained scores, `encode` with the relative
bias and with residual attention (pre- and post-LN), the sinusoidal table
and the sqrt(emb) word scale, the seq2seq loss and every gradient against
jax.grad (T5's RMS norm at pre-LN, the normal norm at post-LN with
sinusoidal positions, and a decoder deeper than the encoder), the hash
dropout sites (1 + 3 x layers in the encoder, 1 + 5 x layers in the decoder,
each JAX's `_apply` of its input bit for bit), the weight bridge both ways
with strict loading, the mt, t5, gsg and bart processors' items over two
epochs, and the pretraining CLI's t5 run against the JAX trainer."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.cli import pretrain as jcli
from lr2ppo_tpu.data import pretrain_processors as jpp
from lr2ppo_tpu.data.tokenizers import SpaceTokenizer as JSpace
from lr2ppo_tpu.ops import hash_dropout as jhd
from lr2ppo_tpu.towers import torch_tower_to_flax
from lr2ppo_tpu.towers import embeddings as jemb
from lr2ppo_tpu.towers import layers as jlayers
from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_tpu.train import checkpoints as jckpt
from lr2ppo_torch.cli import pretrain as tcli
from lr2ppo_torch.data import pretrain_processors as tpp
from lr2ppo_torch.data.tokenizers import SpaceTokenizer
from lr2ppo_torch.ops import hash_dropout as thd
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint,
                                 tower_params_from_flax)
from lr2ppo_torch.towers import embeddings as temb
from lr2ppo_torch.towers import layers as tlayers
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.train.checkpoints import save_model
from test_torch_seq2seq_parallel import t5_raw

torch.set_num_threads(1)

V, B, S, T, W, HEADS = 40, 3, 12, 10, 16, 4
# float32 on both sides, summed in other orders
RTOL = 1e-5
# JAX's float32 exp, sin and cos round some table entries differently from
# torch's (the reference's own recipe): within one float32 ulp of the
# largest angle, 2^-14 below 512 radians
SIN_ATOL = 2.0 ** -14


def mt_raw(**kw):
    """A tiny Transformer base: word + sinusoidal positions on both sides,
    post-LN, the normal norm, biases and the attention scale."""
    return {**dict(emb_size=W, hidden_size=W, feedforward_size=32,
                   heads_num=HEADS, layers_num=2, dropout=0.0,
                   max_seq_length=16, vocab_size=V,
                   embedding=["word", "sinusoidalpos"],
                   tgt_embedding=["word", "sinusoidalpos"],
                   encoder="transformer", mask="fully_visible",
                   decoder="transformer", target=["lm"], hidden_act="relu",
                   layernorm_positioning="post"), **kw}


def _batch(seed=0):
    """src, tgt_out, seg, tgt_in, tgt_seg with padded rows on both sides
    and a segment-2 stretch on the source (sinusoidal positions count it
    twice)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    seg = np.array([[1] * S, [1] * 6 + [2] * 2 + [0] * 4, [1] * 5 + [0] * 7],
                   np.int32)
    tin = rng.randint(5, V, (B, T)).astype(np.int32)
    tseg = np.array([[1] * T, [1] * 6 + [0] * 4, [1] * 3 + [0] * 7],
                    np.int32)
    tout = (rng.randint(5, V, (B, T)) * tseg).astype(np.int32)
    return src, tout, seg, tin, tseg


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_model(raw, batch, seed=0):
    model = JTowerModel(JTowerConfig.from_dict(raw))
    params = model.init(jax.random.PRNGKey(seed), *batch)
    return model, jax.tree.map(np.asarray, params)


def _port_model(raw, params):
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    model.load_state_dict(tower_params_from_flax(params), strict=True)
    return model


# -- the buckets, the bias, the attention ------------------------------------
@pytest.mark.parametrize("num_buckets", [32, 8])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "one_way"])
def test_buckets_are_jaxs_exactly(bidirectional, num_buckets):
    """Every relative position in [-600, 600], through the function and
    through the host table the bias module reads."""
    rel = np.arange(-600, 601, dtype=np.int32)
    want = np.asarray(jlayers.t5_relative_buckets(
        jnp.asarray(rel), bidirectional, num_buckets, 128))
    got = tlayers.t5_relative_buckets(torch.from_numpy(rel), bidirectional,
                                      num_buckets, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    table = tlayers._bucket_table(601, 601, bidirectional, num_buckets, 128,
                                  torch.device("cpu"))
    ctx, mem = np.arange(601)[:, None], np.arange(601)[None, :]
    np.testing.assert_array_equal(table.numpy(), want[(mem - ctx) + 600])


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "one_way"])
def test_relative_bias_and_chained_attention_match_jax(bidirectional):
    """The (1, H, Sq, Sk) bias from the carried table bit for bit; the
    attention with that bias, a mask and earlier chained scores: its output
    and its chained scores to RTOL, in JAX's order (bias, scale, mask,
    chain), with and without the scale."""
    jrel = jlayers.RelativePositionEmbedding(HEADS, bidirectional, 8)
    rparams = jax.tree.map(np.asarray,
                           jrel.init(jax.random.PRNGKey(0), S, T))
    want_bias = np.asarray(jrel.apply(rparams, S, T))
    rel = tlayers.RelativePositionEmbedding(HEADS, bidirectional, 8)
    rel.relative_attention_bias.weight.data = torch.tensor(
        rparams["params"]["relative_attention_bias"])
    bias = rel(S, T)
    np.testing.assert_array_equal(bias.detach().numpy(), want_bias)

    rng = np.random.RandomState(1)
    q = rng.randn(B, S, W).astype(np.float32)
    kv = rng.randn(B, T, W).astype(np.float32)
    mask = np.where(rng.rand(B, 1, S, T) < 0.2, -10000.0, 0.0).astype(
        np.float32)
    prev = rng.randn(B, HEADS, S, T).astype(np.float32)
    for with_scale in (True, False):
        jattn = jlayers.MultiHeadedAttention(W, HEADS, W // HEADS, 0.0,
                                             with_scale=with_scale)
        aparams = jax.tree.map(np.asarray, jattn.init(
            jax.random.PRNGKey(2), kv, kv, q, mask, want_bias, prev))
        jout, jscores = jattn.apply(aparams, kv, kv, q, mask, want_bias, prev)
        attn = tlayers.MultiHeadedAttention(W, HEADS, W // HEADS,
                                            with_scale=with_scale)
        state = tower_params_from_flax({"encoder": aparams["params"]})
        attn.load_state_dict({k.split(".", 1)[1]: v
                              for k, v in state.items()}, strict=True)
        with torch.no_grad():
            out, scores = attn(*_t([kv, kv, q, mask]), bias, _t([prev])[0])
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   rtol=RTOL, atol=RTOL)


ENCODE_CASES = {"relative": dict(relative_position_embedding=True),
                "residual": dict(has_residual_attention=True)}


@pytest.mark.parametrize("ln", ["post", "pre"])
@pytest.mark.parametrize("variant", sorted(ENCODE_CASES))
def test_encode_matches_jax(monkeypatch, variant, ln):
    """An encoder-only tower (word + pos + seg, biases, the scale) with the
    relative bias or residual attention, pallas_attention set: the features
    to RTOL, and the fused kernel never reached (JAX's gate closes on
    either flag)."""
    raw = {**mt_raw(embedding=["word", "pos", "seg"], decoder=None,
                    tgt_embedding=None, target=["mlm"],
                    layernorm_positioning=ln, pallas_attention=True),
           **ENCODE_CASES[variant]}
    src, _, seg, _, _ = _batch(2)
    model = JTowerModel(JTowerConfig.from_dict(raw))
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(3), src, seg, method=model.encode))
    want = np.asarray(model.apply(params, src, seg, method=model.encode))
    calls = []
    monkeypatch.setattr(tlayers, "fused_attention",
                        lambda *a, **kw: calls.append(1))
    port = TowerModel(TowerConfig.from_dict(raw))
    port.load_state_dict(tower_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = port.encode(*_t([src, seg]))
    assert calls == []
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)


# -- sinusoidal positions ------------------------------------------------------
@pytest.mark.parametrize("interleaved", [True, False],
                         ids=["interleaved", "concatenated"])
def test_sinusoidal_table_and_word_scale(interleaved):
    """The table is the reference's torch recipe bit for bit and JAX's
    within SIN_ATOL (rows max_seq_length + 2, an odd width's zero column);
    the forward reads rows 2.. under seg.sum as JAX does; the word lookup's
    sqrt(emb) scale is JAX's bit for bit."""
    for emb, rows in ((768, 516), (17, 10)):
        got = temb.sinusoid_table(rows, emb, interleaved)
        half = emb // 2
        value = math.log(10000) / (half - 1)
        half_exp = torch.exp(torch.arange(half, dtype=torch.float) * -value)
        half_mat = (torch.arange(rows, dtype=torch.float).unsqueeze(1)
                    * half_exp.unsqueeze(0))
        if interleaved:
            ref = torch.zeros(rows, 2 * half)
            ref[:, 0::2] = torch.sin(half_mat)
            ref[:, 1::2] = torch.cos(half_mat)
        else:
            ref = torch.cat([torch.sin(half_mat), torch.cos(half_mat)], 1)
        if emb % 2:
            ref = torch.cat([ref, torch.zeros(rows, 1)], 1)
        assert torch.equal(got, ref)
        jtable = np.asarray(jemb.SinusoidalposEmbedding(
            rows - 2, emb, interleaved)._table())
        np.testing.assert_allclose(got.numpy(), jtable, rtol=0,
                                   atol=SIN_ATOL)
    _, _, seg, _, _ = _batch(4)
    jpos = jemb.SinusoidalposEmbedding(14, W, interleaved)
    want = np.asarray(jpos.apply({}, None, jnp.asarray(seg)))
    got = temb.SinusoidalposEmbedding(14, W, interleaved)(None,
                                                          _t([seg])[0])
    assert got.shape == want.shape == (B, S, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SIN_ATOL)
    # a row's tokens past seg.sum read zeros: row 1 holds 8 tokens, and its
    # two of segment 2 count twice
    assert got[1, 9].any() and not got[1, 10:].any()
    assert got[2, 4].any() and not got[2, 5:].any()

    src = np.random.RandomState(5).randint(0, V, (B, S)).astype(np.int32)
    jword = jemb.WordEmbedding(V, W, sinusoidalpos=True)
    wparams = jax.tree.map(np.asarray,
                           jword.init(jax.random.PRNGKey(6), src, seg))
    word = temb.WordEmbedding(V, W, sinusoidalpos=True)
    word.embedding.weight.data = torch.tensor(
        wparams["params"]["embedding"])
    np.testing.assert_array_equal(
        word(*_t([src, seg])).detach().numpy(),
        np.asarray(jword.apply(wparams, src, seg)))


# -- the seq2seq loss and its gradients ----------------------------------------
GRAD_CASES = {"t5_pre": t5_raw(), "t5_deeper_decoder": t5_raw(
    decoder_layers_num=3), "mt_post_sinusoidal": mt_raw()}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_seq2seq_loss_and_every_gradient_match_jax_grad(case):
    """The LM loss over the decoder, its correct count and denominator, and
    the gradient of every parameter (both embeddings, both stacks, both
    bias tables, the head) at dropout 0: the loss to RTOL, each gradient
    within RTOL of its tensor's largest magnitude (or of 1% of the model's
    largest gradient, if larger)."""
    raw = GRAD_CASES[case]
    batch = _batch(7)
    jmodel, params = _jax_model(raw, batch, seed=8)

    def loss_fn(p):
        return jmodel.apply({"params": p}, *batch, deterministic=False)

    jloss, jcorrect, jdenom = jax.jit(loss_fn)(params["params"])
    jgrads = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(
        jax.tree.map(jnp.asarray, params["params"]))
    want = tower_params_from_flax(jax.tree.map(np.asarray, jgrads))
    model = _port_model(raw, params)
    loss, correct, denom = model(*_t(batch), deterministic=False,
                                 generator=torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    assert (float(correct), float(denom)) == (float(jcorrect), float(jdenom))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert any(k.startswith("decoder.transformer_decoder.") for k in got)
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in got.items():
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=RTOL * scale,
                                   err_msg=k)


def _record_hash_sites(monkeypatch):
    sites, real = [], thd.hash_dropout

    def rec(x, seed, rate):
        y = real(x, seed, rate)
        sites.append((x.detach().clone(), seed, rate, y.detach().clone()))
        return y

    monkeypatch.setattr(thd, "hash_dropout", rec)
    return sites


@pytest.mark.parametrize("ln", ["pre", "post"])
def test_hash_dropout_sites_are_jaxs_apply_bit_for_bit(monkeypatch, ln):
    """A training forward of T5-tiny reaches 1 + 3 x 2 encoder sites and
    1 + 5 x 2 decoder sites (the target embedding's too, with no norm
    before it), in forward order and with distinct seeds, the context
    probabilities (B, H, T, S) not square; each is JAX's `_apply` of its
    input under its seed, bit for bit. Evaluation reaches none."""
    raw = t5_raw(dropout=0.1, hash_dropout=True, layernorm_positioning=ln)
    batch = _batch(9)
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    init_weights(model, torch.Generator().manual_seed(10))
    sites = _record_hash_sites(monkeypatch)
    model(*_t(batch), deterministic=False,
          generator=torch.Generator().manual_seed(11))
    enc = [(B, S, W)] + [(B, HEADS, S, S), (B, S, W), (B, S, W)] * 2
    dec = [(B, T, W)] + [(B, HEADS, T, T), (B, T, W), (B, HEADS, T, S),
                         (B, T, W), (B, T, W)] * 2
    assert [tuple(x.shape) for x, *_ in sites] == enc + dec
    assert len({seed for _, seed, _, _ in sites}) == len(sites)
    for x, seed, rate, y in sites:
        want = jhd._apply(jnp.asarray(x.numpy()), jnp.int32(seed), rate)
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))
        assert rate == 0.1
    sites.clear()
    with torch.no_grad():
        model(*_t(batch))
    assert sites == []


def test_encoder_remat_with_residual_attention_is_bit_equal():
    """remat of a layer carries the position bias and the chained scores:
    the loss, every gradient and the generator's state equal the run
    without remat, hash dropout on."""
    batch = _batch(12)
    runs = {}
    for remat in (False, True):
        raw = t5_raw(dropout=0.1, hash_dropout=True,
                     has_residual_attention=True, remat=remat)
        model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
        init_weights(model, torch.Generator().manual_seed(13))
        gen = torch.Generator().manual_seed(14)
        loss = model(*_t(batch), deterministic=False, generator=gen)[0]
        loss.backward()
        runs[remat] = (float(loss.detach()), {
            k: p.grad.clone() for k, p in model.named_parameters()},
            gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    assert l0 == l1 and torch.equal(s0, s1)
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


# T5-base's widths (google-t5/t5-base config.json), cut to 2 + 2 layers
T5_BASE_WIDTHS = dict(emb_size=768, hidden_size=768, feedforward_size=3072,
                      heads_num=12, relative_attention_buckets_num=32,
                      vocab_size=32128, layers_num=2, decoder_layers_num=2)


def test_t5_base_parameter_count_is_jaxs():
    """At T5-base's widths (2 + 2 layers, shapes only: JAX's init under
    eval_shape, the port on the meta device) both count the same
    parameters, per part: 7,079,424 an encoder layer, 9,439,488 a decoder
    layer, 24,674,304 in each word table and the head, the two final norms
    and the two 32 x 12 bias tables; 272,252,160 at the published 12 +
    12."""
    raw = t5_raw(**T5_BASE_WIDTHS)
    batch = _batch(17)
    shapes = jax.eval_shape(JTowerModel(JTowerConfig.from_dict(raw)).init,
                            jax.random.PRNGKey(0), *batch)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = TowerModel(TowerConfig.from_dict(raw), device="meta",
                       with_target=True)
    params = dict(model.named_parameters())
    assert sum(p.numel() for p in params.values()) == want

    def part(prefix):
        return sum(p.numel() for k, p in params.items()
                   if k.startswith(prefix))

    assert part("encoder.transformer.1.") == 7_079_424
    assert part("decoder.transformer_decoder.1.") == 9_439_488
    table = 32128 * 768
    assert part("embedding.") == part("tgt_embedding.") == table
    assert part("target.") == table
    rest = want - 2 * 7_079_424 - 2 * 9_439_488 - 3 * table
    assert rest == 2 * 32 * 12 + 2 * 768    # bias tables, final norms
    assert 12 * 7_079_424 + 12 * 9_439_488 + 3 * table + rest == 272_252_160


# -- the weight bridge -------------------------------------------------------
@pytest.mark.parametrize("make", [t5_raw, mt_raw], ids=["t5", "mt"])
def test_bridge_round_trip_is_bit_for_bit(tmp_path, make):
    """A JAX seq2seq tree (and its pickle checkpoint) loads strict into the
    port under the decoder's reference keys; the port's `.bin` goes back
    through JAX's torch_tower_to_flax to the same tree bit for bit."""
    raw = make()
    batch = _batch(15)
    _, params = _jax_model(raw, batch, seed=16)
    state = tower_params_from_flax(params)
    keys = {"tgt_embedding.word.embedding.weight",
            "decoder.transformer_decoder.1.context_attn.linear_layers.2."
            "weight", "decoder.transformer_decoder.0.layer_norm_3."
            + ("weight" if make is t5_raw else "gamma")}
    if make is t5_raw:
        keys |= {"encoder.relative_pos_emb.relative_attention_bias.weight",
                 "decoder.self_pos_emb.relative_attention_bias.weight",
                 "decoder.layer_norm.weight"}
    assert keys <= set(state)
    jckpt.save_checkpoint(str(tmp_path / "jax"), params, {"step": 1})
    loaded = load_tower_checkpoint(str(tmp_path / "jax"))
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
    # a dual tower's embedding_0 is a tower's root; a VQGAN tree is not (its
    # bridge is towers/vqgan.py:vqgan_params_from_flax)
    with pytest.raises(KeyError, match="decoder"):
        tower_params_from_flax({"params": {"vqgan": {
            "word": {"embedding": np.zeros((2, 2))}}}})


# -- the processors ------------------------------------------------------------
TOKENS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + list("abcdefgh")
MASK, VOCAB = 4, 13


@pytest.fixture(autouse=True)
def _restore_special_ids():
    """Both packages' frame ids are module-wide (the CLIs set them): put
    them back after each test."""
    old = [(m, (m.CLS, m.PAD, m.SEP)) for m in (jpp, tpp)]
    yield
    for m, ids in old:
        m.set_special_ids(*ids)


@pytest.fixture
def files(tmp_path):
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(6):
        for _ in range(6):
            lines.append(" ".join(rng.choice(list("abcdefgh"),
                                             int(rng.integers(3, 8)))))
        lines.append("")
    (tmp_path / "docs.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "mt.tsv").write_text("".join(
        " ".join(rng.choice(list("abcdefgh"), int(rng.integers(2, 9))))
        + "\t" + " ".join(rng.choice(list("abcdefgh"),
                                     int(rng.integers(2, 12)))) + "\n"
        for _ in range(10)) + "no tab here\n")
    return {k: str(tmp_path / f) for k, f in
            (("vocab", "v.txt"), ("docs", "docs.txt"), ("mt", "mt.tsv"))}


def _build(mod, tok, name, files):
    return {
        "mt": lambda: mod.MtTsvDataset(files["mt"], tok, 8, 6),
        "t5": lambda: mod.T5CorpusDataset(files["docs"], tok, 12, 10,
                                          VOCAB + 100, sentinel_start=VOCAB,
                                          seed=3),
        "gsg": lambda: mod.GsgDocsDataset(files["docs"], tok, 32, 24, MASK,
                                          strategy="random", seed=4),
        "bart": lambda: mod.BartDocsDataset(files["docs"], tok, 32, VOCAB,
                                            MASK, seed=5),
    }[name]()


@pytest.mark.parametrize("layout", ["xlmr", "bert"])
@pytest.mark.parametrize("name", ["mt", "t5", "gsg", "bart"])
def test_seq2seq_processors_give_jaxs_items(files, name, layout):
    """Same corpus, tokenizer ids and seed: the same items, every array of
    the five seq2seq keys equal with its dtype, in epochs 0 and 1, at the
    XLM-R frame ids and at others (each dataset keeps the ids it was
    built with)."""
    if layout == "bert":
        for m in (jpp, tpp):
            m.set_special_ids(2, 1, 3)
    jds = _build(jpp, JSpace(files["vocab"]), name, files)
    tds = _build(tpp, SpaceTokenizer(files["vocab"]), name, files)
    for m in (jpp, tpp):
        m.set_special_ids(7, 6, 5)
    assert len(tds) == len(jds) > 0
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            want, got = jds.get(i), tds.get(i)
            assert set(got) == {"src", "tgt_out", "seg", "tgt_in", "tgt_seg"}
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {i} {k}")
                assert got[k].dtype == want[k].dtype


# -- the CLI -------------------------------------------------------------------
CLI_TOKENS = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + list("abcdefghi")
STEPS = 4
# float32 on both sides over 4 AdamW steps (tests/test_torch_pretrain.py)
TOL = 1e-4


def _cli_files(tmp_path, raw):
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in CLI_TOKENS))
    rng = np.random.RandomState(0)
    words = list("abcdefghi")
    (tmp_path / "c.txt").write_text("".join(
        " ".join(rng.choice(words, 10)) + "\n" for _ in range(30)))
    docs = []
    for _ in range(8):
        docs += [" ".join(rng.choice(words, rng.randint(3, 7)))
                 for _ in range(5)] + [""]
    (tmp_path / "d.txt").write_text("\n".join(docs) + "\n")
    (tmp_path / "mt.tsv").write_text("".join(
        " ".join(rng.choice(words, 6)) + "\t" + " ".join(
            rng.choice(words, 5)) + "\n" for _ in range(24)))
    (tmp_path / "tower.json").write_text(json.dumps(raw))
    return {k: str(tmp_path / f) for k, f in
            (("vocab", "v.txt"), ("corpus", "c.txt"), ("docs", "d.txt"),
             ("mt", "mt.tsv"), ("tower", "tower.json"))}


def _cli_argv(files, out, processor="t5", corpus="corpus", *extra):
    return ["--corpus_path", files[corpus], "--tower_config", files["tower"],
            "--data_processor", processor, "--tokenizer", "space",
            "--vocab_path", files["vocab"], "--output_model_path", out,
            "--batch_size", "4", "--accumulation_steps", "2",
            "--seq_length", "16", "--tgt_seq_length", "12",
            "--total_steps", str(STEPS), "--report_steps", "1",
            "--learning_rate", "1e-2", "--log_path", out + ".log", *extra]


def _records(out):
    with open(out + ".log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_t5_cli_matches_the_jax_trainer(tmp_path):
    """Both CLIs pretrain T5-tiny with --data_processor t5 from the same
    `.bin` (4 steps of 2 accumulated micro-batches, dropout 0): the same
    per-step losses and accuracies and the same final weights, to TOL; the
    vocabulary grows by the 100 sentinels, and by what --sentinel_start
    puts past the vocabulary's end."""
    files = _cli_files(tmp_path, t5_raw(vocab_size=None))
    n = len(CLI_TOKENS)
    assert n == 14
    cfg = TowerConfig.from_dict(t5_raw(vocab_size=n + 100))
    init = str(tmp_path / "init.bin")
    model = TowerModel(cfg, with_target=True)
    init_weights(model, torch.Generator().manual_seed(3))
    save_model(init, model)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main(_cli_argv(files, jout, "t5", "corpus",
                        "--pretrained_model_path", init, "--dp", "1"))
    tcli.main(_cli_argv(files, tout, "t5", "corpus",
                        "--pretrained_model_path", init), device="cpu")
    jrec, trec = _records(jout), _records(tout)
    assert [r["step"] for r in trec] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in trec],
                               [r["loss"] for r in jrec], rtol=TOL)
    np.testing.assert_allclose([r["acc"] for r in trec],
                               [r["acc"] for r in jrec], atol=TOL)
    want, got = load_tower_checkpoint(jout), load_tower_checkpoint(tout)
    assert got.keys() == want.keys()
    assert got["target.lm.output_layer.weight"].shape[0] == n + 100
    start = load_tower_checkpoint(init)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=TOL * float(w.abs().max()),
                                   err_msg=k)
    assert not torch.equal(
        got["decoder.transformer_decoder.1.context_attn.linear_layers.1."
            "weight"], start["decoder.transformer_decoder.1.context_attn."
                             "linear_layers.1.weight"])
    # the sentinels [start, start + 100) against the 14-entry vocabulary
    for extra, size in (([], 114), (["--sentinel_start", "4"], 104),
                        (["--sentinel_start", "20"], 120)):
        trainer, _ = tcli.build(tcli.parser().parse_args(_cli_argv(
            files, str(tmp_path / "b"), "t5", "corpus", *extra)), "cpu")
        assert (trainer.tower_cfg.vocab_size, trainer.form) == (
            size, "seq2seq"), extra


@pytest.mark.parametrize("processor,corpus", [
    ("mt", "mt"), ("gsg", "docs"), ("bart", "docs")])
def test_mt_gsg_and_bart_cli_runs_on_the_cpu(tmp_path, processor, corpus):
    """The other three seq2seq processors through the CLI (mt with
    Transformer base's sinusoidal positions, post-LN): finite losses,
    every step logged, checkpoints that load strict."""
    raw = (mt_raw(vocab_size=None) if processor == "mt"
           else t5_raw(vocab_size=None))
    files = _cli_files(tmp_path, raw)
    out = str(tmp_path / processor)
    tcli.main(_cli_argv(files, out, processor, corpus, "--total_steps", "2",
                        "--hash_dropout"), device="cpu")
    rec = _records(out)
    assert [r["step"] for r in rec] == [1, 2]
    assert np.isfinite([r["loss"] for r in rec]).all()
    cfg = TowerConfig.from_dict({**raw, "vocab_size": len(CLI_TOKENS)})
    TowerModel(cfg, with_target=True).load_state_dict(
        load_tower_checkpoint(out), strict=True)


def test_tgt_seq_length_past_the_position_table_raises(tmp_path):
    files = _cli_files(tmp_path, mt_raw(vocab_size=None))
    with pytest.raises(SystemExit, match="--tgt_seq_length"):
        tcli.main(_cli_argv(files, str(tmp_path / "x"), "mt", "mt",
                            "--tgt_seq_length", "40"), device="cpu")
