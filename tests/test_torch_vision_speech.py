"""Image and speech pretraining, the port against the JAX package on the
CPU at a tiny size: the word_patch, masked_patch and speech embeddings
(forward and every gradient, BEiT's mask with a repeated index, odd frame
counts at 1-3 convolutions); SpecAugment, the log-mel filterbank, CMVN and
the wav reader (8-, 16- and 32-bit, stereo) byte for byte; the vit, vilt,
s2t, beit and dalle datasets' items over two epochs byte for byte (beit and
dalle tokenize with one taming checkpoint read by both packages); and both
pretrain CLIs at the five processors on the same files and starting weights
(towers of 2 layers x 16), the same per-step losses to TOL."""

import json
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lr2ppo_tpu.cli import pretrain as jcli
from lr2ppo_tpu.data import augment as jaug
from lr2ppo_tpu.data import pretrain_data as jpd
from lr2ppo_tpu.data import pretrain_processors as jpp
from lr2ppo_tpu.data import tokenizers as jtok
from lr2ppo_tpu.towers import embeddings as jemb
from lr2ppo_torch.cli import pretrain as tcli
from lr2ppo_torch.data import augment as taug
from lr2ppo_torch.data import pretrain_data as tpd
from lr2ppo_torch.data import pretrain_processors as tpp
from lr2ppo_torch.data import tokenizers as ttok
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 tower_params_from_flax)
from lr2ppo_torch.towers import embeddings as temb
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.towers.vqgan import VQGANConfig, VQGANEncoder, init_vqgan
from lr2ppo_torch.train.checkpoints import save_model

torch.set_num_threads(1)

TOKENS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + list("abcdefgh")
MASK = 4
TINY_VQ = dict(ch=8, ch_mult=(1, 2, 2), num_res_blocks=1,
               attn_resolutions=(8,), resolution=16, z_channels=8,
               n_embed=16, embed_dim=8)
# an embedding's output and gradients: float32 products summed in other
# orders, within RTOL of each tensor's largest magnitude
RTOL = 1e-5
# the CLIs' per-step losses: float32 on both sides over 4 AdamW steps
TOL = 1e-4
N_MELS = 80


@pytest.fixture(autouse=True)
def _restore_special_ids():
    """Both CLIs set their processors' module-wide frame ids: restore them
    after each test."""
    old = [(m, (m.CLS, m.PAD, m.SEP)) for m in (jpp, tpp)]
    yield
    for m, ids in old:
        m.set_special_ids(*ids)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * max(float(np.abs(want).max()),
                                               1e-30))


# -- the embeddings --------------------------------------------------------
def _embedding_case(kind, rng, conv_layers=2, frames=13, sinusoidal=False):
    """(the JAX module, the port's, its inputs as numpy, the port's source
    from them)."""
    if kind == "speech":
        jm = jemb.SpeechEmbedding(16, conv_layers=conv_layers,
                                  sinusoidalpos=sinusoidal)
        tm = temb.SpeechEmbedding(16, conv_layers=conv_layers,
                                  sinusoidalpos=sinusoidal)
        x = rng.standard_normal((2, frames, N_MELS)).astype(np.float32)
        return jm, tm, (x,), lambda a: a[0]
    pixels = rng.random((2, 3, 16, 16), dtype=np.float32)
    if kind == "masked_patch":
        jm = jemb.MaskedPatchEmbedding(16, 16, 16, 8)
        tm = temb.MaskedPatchEmbedding(16, 16, 16, 8)
        # a repeated index (3 twice in row 0) counts once
        mask = np.array([[3, 1, 3], [4, 2, 1]], np.int32)
        return jm, tm, (pixels, mask), tuple
    jm = jemb.WordPatchEmbedding(13, 16, 16, 16, 8)
    tm = temb.WordPatchEmbedding(13, 16, 16, 16, 8)
    tokens = rng.integers(0, 13, (2, 6)).astype(np.int32)
    return jm, tm, (tokens, pixels), tuple


CASES = {"masked_patch": dict(kind="masked_patch"),
         "word_patch": dict(kind="word_patch"),
         "speech_1_conv_odd": dict(kind="speech", conv_layers=1, frames=7),
         "speech_2_conv_odd": dict(kind="speech", conv_layers=2, frames=13),
         "speech_3_conv_odd_sinusoidal": dict(kind="speech", conv_layers=3,
                                              frames=21, sinusoidal=True),
         "speech_2_conv_even": dict(kind="speech", conv_layers=2,
                                    frames=16)}


@pytest.mark.parametrize("case", CASES)
def test_embedding_and_its_gradients_match_jax(case):
    """The port's module from the JAX module's weights through the tower
    bridge: the output, the gradient of <output, w> for every weight and
    for a float input."""
    kind = CASES[case]["kind"]
    rng = np.random.default_rng(0)
    jm, tm, inputs, to_src = _embedding_case(rng=rng, **CASES[case])
    seg = np.ones((2, 1), np.int32)
    params = jm.init(jax.random.PRNGKey(1), tuple(map(jnp.asarray, inputs))
                     if kind != "speech" else jnp.asarray(inputs[0]),
                     jnp.asarray(seg))["params"]
    params = jax.tree.map(np.asarray, params)
    prefix = f"embedding.{kind}."

    def bridged(tree):
        return {k[len(prefix):]: v for k, v in tower_params_from_flax(
            {"embedding": {kind: tree}}).items()}

    tm.load_state_dict(bridged(params), strict=True)
    float_at = 1 if kind == "word_patch" else 0     # pixels, or the frames

    def jfn(p, x):
        src = list(map(jnp.asarray, inputs))
        src[float_at] = x
        src = tuple(src) if kind != "speech" else src[0]
        return jm.apply({"params": p}, src, jnp.asarray(seg))

    want = np.asarray(jfn(params, jnp.asarray(inputs[float_at])))
    w = rng.standard_normal(want.shape).astype(np.float32)
    jgrad = jax.grad(lambda p, x: jnp.sum(jfn(p, x) * w), argnums=(0, 1))(
        params, jnp.asarray(inputs[float_at]))
    src = [torch.from_numpy(a) for a in inputs]
    src[float_at].requires_grad_(True)
    out = tm(to_src(src), torch.from_numpy(seg))
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), want)
    want_grads = bridged(jax.tree.map(np.asarray, jgrad[0]))
    got_grads = dict(tm.named_parameters())
    assert got_grads.keys() == want_grads.keys()
    for k, g in want_grads.items():
        _close(got_grads[k].grad, g)
    _close(src[float_at].grad, jgrad[1])
    if kind == "speech":
        frames = CASES[case]["frames"]
        for _ in range(CASES[case]["conv_layers"]):
            frames = -(-frames // 2)
        assert out.shape == (2, frames, 16)
    if kind == "masked_patch":
        hit = out.detach()[0, 3]
        _close(hit, np.asarray(params["mask_emb"])[0])


def test_speech_frames_that_do_not_fit_seg_raise():
    """S2T's seg spans max_audio_frames // 4; a frame count that is not a
    multiple of 4 gives the embedding another length, which JAX's mask
    cannot broadcast against either."""
    cfg = TowerConfig(emb_size=16, hidden_size=16, feedforward_size=32,
                      heads_num=4, layers_num=1, embedding=["speech"],
                      max_audio_frames=30)
    model = TowerModel(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 30, N_MELS)
    with pytest.raises(ValueError, match="multiple of 4"):
        model.encode(x, torch.ones(1, 30 // 4, dtype=torch.long))
    assert model.encode(x[:, :28], torch.ones(1, 7, dtype=torch.long)
                        ).shape == (1, 7, 16)


# -- audio and SpecAugment -------------------------------------------------
def _write_wav(path, x, width, channels=1, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(x.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Seeded tones plus noise: 16-bit mono of 0.2-0.55 s (the datasets'),
    and one of each of 8-bit unsigned, 32-bit and 16-bit stereo."""
    d = tmp_path_factory.mktemp("wav")
    rng = np.random.default_rng(0)
    out = {}
    for i in range(8):
        n = int(16000 * (0.2 + 0.05 * i))
        t = np.arange(n) / 16000
        x = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) \
            + 0.05 * rng.standard_normal(n)
        out[f"mono{i}"] = _write_wav(
            d / f"m{i}.wav", (np.clip(x, -1, 1) * 32767).astype(np.int16), 2)
    x = rng.standard_normal(4000) * 0.2
    out["u8"] = _write_wav(d / "u8.wav", np.clip(x * 128 + 128, 0, 255)
                           .astype(np.uint8), 1)
    out["s32"] = _write_wav(d / "s32.wav", (np.clip(x, -1, 1) * 2**31 * 0.9)
                            .astype(np.int32), 4)
    out["stereo"] = _write_wav(
        d / "st.wav", (np.clip(np.stack([x, -x / 2], 1), -1, 1) * 32767)
        .astype(np.int16), 2, channels=2)
    return out


@pytest.mark.parametrize("name", ["mono0", "u8", "s32", "stereo"])
def test_wav_filterbank_and_cmvn_are_jaxs_bytes(wavs, name):
    x, rate = tpp.read_wav(wavs[name])
    want_x, want_rate = jpp.read_wav(wavs[name])
    assert rate == want_rate and x.dtype == want_x.dtype
    np.testing.assert_array_equal(x, want_x)
    feat = tpp.logmel_fbank(x * (2 ** 15), rate, N_MELS)
    np.testing.assert_array_equal(
        feat, jpp.logmel_fbank(want_x * (2 ** 15), rate, N_MELS))
    for means, variances in ((True, True), (True, False), (False, True)):
        np.testing.assert_array_equal(
            tpp.utterance_cmvn(feat, means, variances),
            jpp.utterance_cmvn(feat, means, variances))


@pytest.mark.parametrize("kw", [
    dict(time_warp_W=5, freq_mask_N=2, freq_mask_F=10, time_mask_N=2,
         time_mask_T=20),
    dict(freq_mask_N=1, freq_mask_F=200, time_mask_N=3, time_mask_T=40,
         time_mask_p=0.2, mask_value=0.0),
], ids=["warp", "capped"])
def test_specaugment_is_jaxs_bytes(kw):
    spec = np.random.default_rng(1).standard_normal((100, N_MELS)).astype(
        np.float32)
    port, ref = taug.SpecAugment(seed=3, **kw), jaug.SpecAugment(seed=3, **kw)
    for _ in range(3):
        np.testing.assert_array_equal(port(spec), ref(spec))


# -- the datasets ----------------------------------------------------------
@pytest.fixture(scope="module")
def files(tmp_path_factory, wavs):
    """PIL-written 16 x 16 images, the vocabulary, the manifests of the
    five processors and a taming checkpoint of the tiny VQGAN."""
    from PIL import Image

    d = tmp_path_factory.mktemp("vision_speech")
    rng = np.random.RandomState(0)
    imgs = []
    for i in range(8):
        p = d / f"im{i}.png"
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(p)
        imgs.append(str(p))

    def words(n):
        return " ".join(rng.choice(list("abcdefgh"), n))

    manifests = {
        "vit": [f"{i % 3}\t{p}" for i, p in enumerate(imgs)],
        "vilt": [f"{words(3 + i % 4)}\t{p}" for i, p in enumerate(imgs)],
        "s2t": [f"{words(2 + i % 5)}\t{wavs[f'mono{i}']}" for i in range(8)],
        "beit": list(imgs),
        "dalle": [f"{words(2 + i % 4)}\t{p}" for i, p in enumerate(imgs)],
    }
    out = {"dir": d, "imgs": imgs}
    for name, rows in manifests.items():
        (d / f"{name}.tsv").write_text("".join(r + "\n" for r in rows))
        out[name] = str(d / f"{name}.tsv")
    (d / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    out["vocab"] = str(d / "v.txt")
    vq = VQGANEncoder(VQGANConfig(**TINY_VQ))
    init_vqgan(vq, torch.Generator().manual_seed(5))
    torch.save({"state_dict": vq.state_dict()}, d / "vq.ckpt")
    out["vq"] = str(d / "vq.ckpt")
    return out


def _pairs(path):
    return [tuple(line.rstrip("\n").split("\t"))
            for line in open(path, encoding="utf-8")]


def _datasets(files, name):
    """(the port's dataset, JAX's) of `name` on the same files."""
    vocab = files["vocab"]
    tok, jt = ttok.SpaceTokenizer(vocab), jtok.SpaceTokenizer(vocab)
    if name == "vit":
        items = [(p, int(lbl)) for lbl, p in _pairs(files["vit"])]
        return (tpd.VitImageDataset(items, 16, 16, 8),
                jpd.VitImageDataset(items, 16, 16, 8))
    if name == "vilt":
        pairs = _pairs(files["vilt"])
        kw = dict(seq_length=8, vocab_size=len(TOKENS), mask_id=MASK,
                  image_height=16, image_width=16, patch_size=8, seed=3)
        return (tpp.ViltPairsDataset(pairs, tok, **kw),
                jpp.ViltPairsDataset(pairs, jt, **kw))
    if name == "s2t":
        return (tpp.S2tDataset(files["s2t"], tok, 8, 64),
                jpp.S2tDataset(files["s2t"], jt, 8, 64))
    port_img = ttok.ImageTokenizer(vqgan_model_path=files["vq"],
                                   vqgan_config=TINY_VQ, device="cpu")
    jax_img = jtok.ImageTokenizer(vqgan_model_path=files["vq"],
                                  vqgan_config=TINY_VQ)
    if name == "beit":
        paths = files["imgs"]
        return (tpp.BeitImageDataset(paths, port_img, 16, 16, 8, seed=3),
                jpp.BeitImageDataset(paths, jax_img, 16, 16, 8, seed=3))
    pairs = _pairs(files["dalle"])
    return (tpp.DalleDataset(pairs, tok, port_img, 8, len(TOKENS)),
            jpp.DalleDataset(pairs, jt, jax_img, 8, len(TOKENS)))


@pytest.mark.parametrize("name", ["vit", "vilt", "s2t", "beit", "dalle"])
def test_dataset_items_are_jaxs_bytes(files, name):
    port, ref = _datasets(files, name)
    assert len(port) == len(ref) == 8
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            got, want = port.get(i), ref.get(i)
            assert got.keys() == want.keys()
            for k, v in want.items():
                v = np.asarray(v)
                assert np.asarray(got[k]).dtype == v.dtype, (name, k)
                np.testing.assert_array_equal(got[k], v, err_msg=f"{name} "
                                              f"{k} item {i} epoch {epoch}")


# -- both CLIs -------------------------------------------------------------
TOWERS = {
    "vit": dict(embedding=["patch", "pos"], target=["cls"], labels_num=3,
                layernorm_positioning="pre"),
    "vilt": dict(embedding=["word_patch", "pos", "seg"],
                 target=["mlm", "sp"]),
    "s2t": dict(embedding=["speech", "sinusoidalpos"],
                tgt_embedding=["word", "sinusoidalpos"],
                decoder="transformer", target=["lm"],
                layernorm_positioning="pre", max_audio_frames=64),
    "beit": dict(embedding=["masked_patch", "pos"], target=["mlm"],
                 layernorm_positioning="pre"),
    "dalle": dict(embedding=["word", "pos", "seg"], mask="causal",
                  target=["lm"]),
}
STEPS = 4


def _speech_tree(state):
    """The JAX tree of a port state dict of a speech tower: the JAX
    package's importer for everything but the convolutions, which it has
    no reference layout for; those as its (k * dim, out) kernels."""
    from lr2ppo_tpu.towers.torch_import import torch_tower_to_flax

    sd = {k: v.numpy() for k, v in state.items()}
    conv = {k: sd.pop(k) for k in list(sd)
            if k.startswith("embedding.speech.")}
    tree = torch_tower_to_flax(sd)
    speech = tree["params"]["embedding"].setdefault("speech", {})
    for key, arr in conv.items():
        name, leaf = key.split(".")[-2:]
        if leaf == "bias":
            speech[f"{name}_bias"] = jnp.asarray(arr)
        else:
            speech[name] = jnp.asarray(
                arr.transpose(2, 1, 0).reshape(-1, arr.shape[0]))
    return tree


@pytest.mark.parametrize("processor", list(TOWERS))
def test_cli_matches_the_jax_cli(files, tmp_path, monkeypatch, processor):
    """Both CLIs from one seeded starting `.bin` (the JAX side reads a
    speech tower through _speech_tree), beit and dalle tokenizing with the
    tiny VQGAN of one taming checkpoint in both (the CLIs build the
    published f16-1024 one): the same per-step losses and accuracies."""
    import lr2ppo_tpu.towers as jtowers

    tower = {"emb_size": 16, "hidden_size": 16, "feedforward_size": 32,
             "heads_num": 4, "layers_num": 2, "max_seq_length": 32,
             "dropout": 0.0, "encoder": "transformer", "image_height": 16,
             "image_width": 16, "patch_size": 8, **TOWERS[processor]}
    (tmp_path / "tower.json").write_text(json.dumps(tower))
    monkeypatch.setattr(jcli, "_image_tok", lambda args: jtok.ImageTokenizer(
        vqgan_model_path=files["vq"], vqgan_config=TINY_VQ))
    monkeypatch.setattr(tcli, "_image_tok", lambda args: ttok.ImageTokenizer(
        vqgan_model_path=files["vq"], vqgan_config=TINY_VQ,
        device=args.device))
    argv = ["--corpus_path", files[processor], "--tower_config",
            str(tmp_path / "tower.json"), "--data_processor", processor,
            "--tokenizer", "space", "--vocab_path", files["vocab"],
            "--batch_size", "2", "--accumulation_steps", "2",
            "--seq_length", "8", "--tgt_seq_length", "8", "--total_steps",
            str(STEPS), "--report_steps", "1", "--learning_rate", "1e-2",
            "--pretrained_model_path", str(tmp_path / "init.bin")]
    trainer, _ = tcli.build(tcli.parser().parse_args(
        argv + ["--output_model_path", ""]), "cpu")
    cfg = trainer.tower_cfg
    want_vocab = {"beit": 1024, "dalle": len(TOKENS) + 1024}
    assert cfg.vocab_size == want_vocab.get(processor, len(TOKENS))
    assert trainer.form == jcli.str2form[processor]
    model = TowerModel(cfg, with_target=True)
    init_weights(model, torch.Generator().manual_seed(3))
    save_model(str(tmp_path / "init.bin"), model)
    if processor == "s2t":
        tree = _speech_tree(model.state_dict())
        monkeypatch.setattr(jtowers, "load_tower_checkpoint",
                            lambda path: tree)
    records = {}
    for name, run in (("jax", lambda a: jcli.main(a + ["--dp", "1"])),
                      ("port", lambda a: tcli.main(a, device="cpu"))):
        out = str(tmp_path / name)
        run(argv + ["--output_model_path", out, "--log_path", out + ".log"])
        with open(out + ".log.jsonl") as f:
            records[name] = [json.loads(line) for line in f]
    got, want = records["port"], records["jax"]
    assert [r["step"] for r in got] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=TOL)
    np.testing.assert_allclose([r["acc"] for r in got],
                               [r["acc"] for r in want], atol=TOL)
    assert np.isfinite([r["loss"] for r in got]).all()
