"""The VQGAN image tokenizer, the port against the JAX package on the CPU at
the JAX tests' tiny configuration (TINY_VQ): the encoder through both
bridges (`vqgan_params_from_flax` of a JAX tree, and one taming-keyed state
dict read by both packages' `load_taming_checkpoint`), quant_conv's output
z within Z_ATOL and the tokens equal wherever the JAX side's margin between
its two nearest codes exceeds what the gap in the distances can flip; the
attention placed by `cfg.resolution`, not by the input's size; the codebook
mismatch refused with JAX's message; the image, virtual and text_image
tokenizers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lr2ppo_tpu.data import tokenizers as jtok
from lr2ppo_tpu.towers import vqgan as jvq
from lr2ppo_torch.data import tokenizers as ttok
from lr2ppo_torch.towers.vqgan import (VQGANConfig, VQGANEncoder, init_vqgan,
                                       load_taming_checkpoint,
                                       make_image_tokenizer,
                                       vqgan_params_from_flax)

torch.set_num_threads(1)

TINY_VQ = dict(ch=8, ch_mult=(1, 2, 2), num_res_blocks=1,
               attn_resolutions=(8,), resolution=16, z_channels=8,
               n_embed=16, embed_dim=8)
# quant_conv's output, float32 convolutions and group norms summed in other
# orders (flax's group norm takes E[x^2] - E[x]^2, torch's another form)
Z_ATOL = 1e-5
# at least this share of the tokens must be decided by the margin rule, so
# the equality below is not vacuous
DECIDED_SHARE = 0.9


def _pixels(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _jax_z_and_tokens(params, cfg, px):
    """The JAX encoder's quant_conv output (B, N, C) and its tokens."""
    model = jvq.VQGANEncoder(jvq.VQGANConfig(**cfg))
    (idx, _), state = model.apply(
        params, jnp.asarray(px), capture_intermediates=lambda m, _:
        m.name == "quant_conv", mutable=["intermediates"])
    z = np.asarray(state["intermediates"]["quant_conv"]["__call__"][0])
    return z.reshape(z.shape[0], -1, z.shape[-1]), np.asarray(idx)


def _held(z_port, idx_port, z_ref, idx_ref, codebook):
    """z within Z_ATOL; the tokens equal where the reference's margin
    between its two nearest codes exceeds twice the largest gap between the
    two sides' distances; returns the share so decided."""
    np.testing.assert_allclose(z_port, z_ref, rtol=0, atol=Z_ATOL)
    e = codebook.astype(np.float64)

    def dist(z):
        z = z.astype(np.float64)
        return ((z ** 2).sum(-1, keepdims=True) - 2 * z @ e.T
                + (e ** 2).sum(-1))

    d_ref, d_port = dist(z_ref), dist(z_port)
    gap = np.abs(d_ref - d_port).max()
    two = np.sort(d_ref, axis=-1)[..., :2]
    decided = (two[..., 1] - two[..., 0]) > 2 * gap
    np.testing.assert_array_equal(idx_port[decided], idx_ref[decided])
    return decided.mean()


@pytest.fixture(scope="module")
def jax_params():
    model = jvq.VQGANEncoder(jvq.VQGANConfig(**TINY_VQ))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 16, 16)))
    return jax.tree.map(np.asarray, params)


def _port(state, cfg=TINY_VQ):
    model = VQGANEncoder(VQGANConfig(**cfg))
    model.load_state_dict(state, strict=True)
    return model.eval()


@pytest.mark.parametrize("size", [16, 24], ids=["resolution", "larger"])
def test_encoder_matches_jax_through_the_flax_bridge(jax_params, size):
    """The bridged weights load strict (every key of taming's encode path)
    and give JAX's z and tokens, at the config's resolution and at a larger
    input, where the attention still sits where cfg.resolution puts it."""
    px = _pixels((3, 3, size, size))
    model = _port(vqgan_params_from_flax(jax_params))
    with torch.no_grad():
        z = model.features(torch.from_numpy(px)).numpy()
        idx, zq = model.quantize_features(torch.from_numpy(z))
    z_ref, idx_ref = _jax_z_and_tokens(jax_params, TINY_VQ, px)
    codebook = jax_params["params"]["codebook"]
    share = _held(z, idx.numpy(), z_ref, idx_ref, codebook)
    assert share >= DECIDED_SHARE
    assert idx.shape == (3, (size // 4) ** 2)
    np.testing.assert_array_equal(zq.numpy(), codebook[idx.numpy()])
    # the taming layout: attention at the last level (res 16 / 4 = 4 is not
    # in (8,); the middle level's res 8 is), a downsample on all but the
    # last level
    keys = set(model.state_dict())
    assert "encoder.down.1.attn.0.q.weight" in keys
    assert not any(k.startswith(("encoder.down.0.attn", "encoder.down.2.attn",
                                 "encoder.down.2.downsample")) for k in keys)


def _taming_state(seed=5):
    model = VQGANEncoder(VQGANConfig(**TINY_VQ))
    init_vqgan(model, torch.Generator().manual_seed(seed))
    return model


def test_one_taming_checkpoint_loads_in_both_packages(tmp_path):
    """A taming-keyed checkpoint with decoder and loss keys beside the
    encode path's: both importers keep the encode path, and the two
    encoders give the same z and tokens."""
    src = _taming_state()
    sd = dict(src.state_dict())
    sd["decoder.conv_in.weight"] = torch.zeros(4, 4, 3, 3)
    sd["loss.discriminator.main.0.weight"] = torch.zeros(2)
    path = str(tmp_path / "vq.ckpt")
    torch.save({"state_dict": sd}, path)
    state = load_taming_checkpoint(path, VQGANConfig(**TINY_VQ))
    assert set(state) == set(src.state_dict())
    model = _port(state)
    jparams = jvq.load_taming_checkpoint(path, jvq.VQGANConfig(**TINY_VQ))
    px = _pixels((4, 3, 16, 16), seed=1)
    with torch.no_grad():
        z = model.features(torch.from_numpy(px)).numpy()
        idx, _ = model.quantize_features(torch.from_numpy(z))
    z_ref, idx_ref = _jax_z_and_tokens(jparams, TINY_VQ, px)
    share = _held(z, idx.numpy(), z_ref, idx_ref,
                  state["quantize.embedding.weight"].numpy())
    assert share >= DECIDED_SHARE


def test_a_codebook_that_does_not_fit_raises_like_jax(tmp_path):
    path = str(tmp_path / "vq.ckpt")
    torch.save({"state_dict": _taming_state().state_dict()}, path)
    wrong = {**TINY_VQ, "n_embed": 32}
    with pytest.raises(ValueError, match=r"does not match config") as port:
        load_taming_checkpoint(path, VQGANConfig(**wrong))
    with pytest.raises(ValueError, match=r"does not match config") as ref:
        jvq.load_taming_checkpoint(path, jvq.VQGANConfig(**wrong))
    assert str(port.value) == str(ref.value)


def test_the_image_tokenizers_match(tmp_path):
    """ImageTokenizer from one taming checkpoint in both packages: the
    <img_i> vocabulary, (B, N) int32 tokens equal under the margin rule,
    and text refused."""
    src = _taming_state()
    path = str(tmp_path / "vq.ckpt")
    torch.save({"state_dict": src.state_dict()}, path)
    port = ttok.ImageTokenizer(vqgan_model_path=path, vqgan_config=TINY_VQ,
                               device="cpu")
    ref = jtok.ImageTokenizer(vqgan_model_path=path, vqgan_config=TINY_VQ)
    assert port.vocab == ref.vocab and port.inv_vocab == ref.inv_vocab
    assert port.cfg.tokens_per_image == ref.cfg.tokens_per_image == 16
    px = _pixels((5, 3, 16, 16), seed=2)
    got, want = port.tokenize_images(px), ref.tokenize_images(px)
    assert got.dtype == want.dtype == np.int32 and got.shape == (5, 16)
    with torch.no_grad():
        z = src.features(torch.from_numpy(px)).numpy()
    z_ref, _ = _jax_z_and_tokens(jvq.load_taming_checkpoint(path), TINY_VQ,
                                 px)
    assert _held(z, got, z_ref, want,
                 src.quantize.embedding.weight.detach().numpy()) \
        >= DECIDED_SHARE
    with pytest.raises(TypeError, match="tokenizes images"):
        port.tokenize("a b")


def test_seeded_weights_and_the_other_tokenizers(tmp_path):
    """Without weights the tokenizer is seeded (taming's symmetric codebook
    in [-1/n, 1/n]); the virtual tokenizer gives nothing and text_image is
    BERT's tokenizer with the image vocabulary's size, as in JAX."""
    a, cfg = make_image_tokenizer(VQGANConfig(**TINY_VQ), seed=3,
                                  device="cpu")
    b, _ = make_image_tokenizer(VQGANConfig(**TINY_VQ), seed=3, device="cpu")
    c, _ = make_image_tokenizer(VQGANConfig(**TINY_VQ), seed=4, device="cpu")
    cb = a.model.quantize.embedding.weight.detach()
    assert torch.equal(cb, b.model.quantize.embedding.weight)
    assert not torch.equal(cb, c.model.quantize.embedding.weight)
    assert float(cb.abs().max()) <= 1.0 / cfg.n_embed and float(cb.min()) < 0
    px = _pixels((2, 3, 16, 16))
    np.testing.assert_array_equal(a(px), b(torch.from_numpy(px)))
    assert ttok.VirtualTokenizer().encode("a b") == \
        jtok.VirtualTokenizer().encode("a b") == []
    vocab = tmp_path / "v.txt"
    vocab.write_text("".join(t + "\n" for t in
                             ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                              "hello", "world"]))
    port = ttok.str2tokenizer["text_image"](str(vocab), image_vocab_size=64)
    ref = jtok.str2tokenizer["text_image"](str(vocab), image_vocab_size=64)
    assert port.encode("Hello world x") == ref.encode("Hello world x")
    assert port.image_vocab_size == ref.image_vocab_size == 64
    assert set(ttok.str2tokenizer) == set(jtok.str2tokenizer)
