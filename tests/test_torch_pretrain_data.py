"""The port's pretraining data against the JAX package's, on the CPU: the
text tokenizers (space, char, BERT wordpiece, GPT-2 byte-level BPE on a vocab
and merges written here) give equal ids; mask_tokens and the mlm, lm and cls
datasets give equal arrays for the same seed and epoch. Exact equality
throughout: both sides are the same numpy and Python code."""

import numpy as np
import pytest

from lr2ppo_tpu.data import pretrain_data as jpd
from lr2ppo_tpu.data import tokenizers as jtok
from lr2ppo_torch.data import pretrain_data as tpd
from lr2ppo_torch.data import tokenizers as ttok

SPECIALS = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"]
WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "fast"]
TEXTS = ["the cat sat on the mat", "a dog ran fast , the cat sat",
         "  unknown words here ", "Hello, World! Ünïcode tëxt 猫",
         "cat's dog'll  run\tfast"]


def _vocab(tmp_path, tokens, name="vocab.txt"):
    path = tmp_path / name
    path.write_text("".join(t + "\n" for t in tokens), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("kind", ["space", "char"])
def test_space_and_char_tokenizers_give_jax_ids(tmp_path, kind):
    tokens = SPECIALS + WORDS + list("abcdefghijklmnopqrstuvwxyz ,'")
    vp = _vocab(tmp_path, tokens)
    j, t = jtok.str2tokenizer[kind](vp), ttok.str2tokenizer[kind](vp)
    for text in TEXTS:
        assert t.tokenize(text) == j.tokenize(text)
        assert t.encode(text) == j.encode(text)
        assert t.tokenize(text, use_vocab=False) == j.tokenize(
            text, use_vocab=False)
    assert t.specials == j.specials


def test_bert_wordpiece_gives_jax_ids(tmp_path):
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
              + ["hello", "world", "un", "##known", "##s", "##ic", "##ode",
                 "text", ",", "!", "'", "猫", "wor", "##d", "##l"])
    vp = _vocab(tmp_path, tokens)
    j, t = jtok.BertTokenizer(vp), ttok.BertTokenizer(vp)
    for text in TEXTS + ["unknowns words", "x" * 120]:
        assert t.tokenize(text) == j.tokenize(text)
        assert t.encode(text) == j.encode(text)
    # BERT spellings resolve the specials, as in JAX
    assert t.specials == j.specials and t.specials["mask_token"] == "[MASK]"


def test_bpe_gives_jax_ids(tmp_path):
    byte_map = jtok.bytes_to_unicode()
    assert ttok.bytes_to_unicode() == byte_map
    space = byte_map[ord(" ")]
    merges = [("t", "h"), ("th", "e"), (space, "c"), (space + "c", "a"),
              (space + "ca", "t"), ("a", "t"), (space, "s"),
              (space + "s", "at"), ("o", "n")]
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    pieces = sorted(set(byte_map.values()) | {a + b for a, b in merges})
    vp = _vocab(tmp_path, SPECIALS + pieces)
    mp = str(tmp_path / "merges.txt")
    j, t = jtok.BPETokenizer(vp, mp), ttok.BPETokenizer(vp, mp)
    for text in TEXTS:
        assert t.tokenize(text) == j.tokenize(text)
        assert t.encode(text) == j.encode(text)
        assert t.decode(t.tokenize(text)) == j.decode(j.tokenize(text))


def test_unported_tokenizers_raise_naming_roadmap():
    """The image tokenizers that waited are ported (tests/
    test_torch_vqgan.py holds them against JAX): each package names the
    same tokenizers, the virtual one gives no tokens, and the image one
    refuses text as JAX's does."""
    assert set(ttok.str2tokenizer) == set(jtok.str2tokenizer)
    assert ttok.str2tokenizer["virtual"]().encode("a b") == []
    tiny = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                resolution=8, z_channels=8, n_embed=16, embed_dim=8)
    for tok in (ttok.str2tokenizer["image"](vqgan_config=tiny, device="cpu"),
                jtok.str2tokenizer["image"](vqgan_config=tiny)):
        with pytest.raises(TypeError, match="tokenizes images"):
            tok.tokenize("a b")


@pytest.mark.parametrize("exclude", [(), (7, 9, 30)])
def test_mask_tokens_gives_jax_arrays(exclude):
    ids = np.random.RandomState(3).randint(0, 40, (6, 33)).astype(np.int32)
    seg = (np.arange(33)[None] < np.array([33, 20, 5, 33, 1, 0])[:, None]
           ).astype(np.int32)
    got = tpd.mask_tokens(ids, seg, 40, 4, np.random.default_rng(11),
                          mlm_prob=0.4, exclude_ids=exclude)
    want = jpd.mask_tokens(ids, seg, 40, 4, np.random.default_rng(11),
                           mlm_prob=0.4, exclude_ids=exclude)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).any()


def _corpus(tmp_path):
    rng = np.random.RandomState(5)
    lines = [" ".join(rng.choice(WORDS, rng.randint(1, 12)))
             for _ in range(40)]
    lines[7] = ""                          # an empty line is skipped
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("kind", ["mlm", "lm"])
def test_corpus_datasets_give_jax_arrays(tmp_path, kind):
    vp = _vocab(tmp_path, SPECIALS + WORDS)
    corpus = _corpus(tmp_path)
    cls = {"mlm": "MlmCorpusDataset", "lm": "LmCorpusDataset"}[kind]
    j = getattr(jpd, cls)(corpus, jtok.SpaceTokenizer(vp), 16, 14, 4, 2, 3,
                          0, seed=9)
    t = getattr(tpd, cls)(corpus, ttok.SpaceTokenizer(vp), 16, 14, 4, 2, 3,
                          0, seed=9)
    assert len(t) == len(j) > 5
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_array_equal(t.seg, j.seg)
    for epoch in (0, 3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(t)):
            got, want = t.get(i), j.get(i)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


def test_cls_dataset_gives_jax_arrays(tmp_path):
    vp = _vocab(tmp_path, SPECIALS + WORDS)
    rng = np.random.RandomState(6)
    path = tmp_path / "cls.tsv"
    path.write_text("".join(
        f"{i % 3}\t{' '.join(rng.choice(WORDS, rng.randint(1, 20)))}\n"
        for i in range(12)) + "no label here\n", encoding="utf-8")
    j = jpd.ClsTsvDataset(str(path), jtok.SpaceTokenizer(vp), 10)
    t = tpd.ClsTsvDataset(str(path), ttok.SpaceTokenizer(vp), 10)
    assert len(t) == len(j) == 12
    for i in range(len(t)):
        got, want = t.get(i), j.get(i)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
