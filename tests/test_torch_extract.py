"""The port's feature extraction against the JAX package's, on the CPU: the
tokenizer copy, the two extractors on tiny towers with weights bridged from
the JAX init, the whole CLI on the same files, the clean_feat.h5 round trip
into the port's MovieNet dataset, and the frame loader."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lr2ppo_tpu.cli import preprocess as j_pre
from lr2ppo_tpu.data import tokenizers as j_tok
from lr2ppo_tpu.towers import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers import extract as j_ext
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_torch.cli import preprocess
from lr2ppo_torch.data import tokenizers
from lr2ppo_torch.data.movienet import MovieNetDataset
from lr2ppo_torch.ops.attention import fused_attention
from lr2ppo_torch.towers import TowerConfig, tower_params_from_flax
from lr2ppo_torch.towers.extract import (ImageFeatureExtractor,
                                         TextFeatureExtractor,
                                         write_clean_feat)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def write_vocab(path, seed=0):
    """A synthetic Unigram vocabulary (token<TAB>score): the XLM-R specials
    first, then the letters, '▁'-prefixed words and pieces of a few
    letters, with seeded scores."""
    rng = np.random.RandomState(seed)
    pieces = ["<s>", "<pad>", "</s>", "<unk>"]
    letters = list("abcdefghijklmnopqrstuvwxyz")
    pieces += letters + ["▁" + c for c in letters]
    pieces += ["▁" + "".join(rng.choice(letters, n)) for n in (2, 3, 4)
               for _ in range(40)]
    pieces += ["".join(rng.choice(letters, n)) for n in (2, 3)
               for _ in range(40)]
    seen, lines = set(), []
    for p in pieces:
        if p not in seen:
            seen.add(p)
            lines.append(f"{p}\t{-rng.uniform(1.0, 12.0):.4f}")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return len(lines)


TEXTS = ["the quick brown fox", "  Über   café  ", "naïve\tZZZ 123 !!",
         "", "abcabcabc xyz", "ｆｕｌｌ ｗｉｄｔｈ", "日本語 text"]


def test_tokenizer_copy_gives_the_same_ids(tmp_path):
    vocab = tmp_path / "vocab.tsv"
    write_vocab(vocab)
    mine = tokenizers.XLMRobertaTokenizer(vocab_path=str(vocab))
    ref = j_tok.XLMRobertaTokenizer(vocab_path=str(vocab))
    assert mine.backend == ref.backend == "unigram"
    for t in TEXTS:
        assert mine.tokenize(t) == ref.tokenize(t)
        assert mine.encode(t) == ref.encode(t)
    assert any(len(mine.encode(t)) > 3 for t in TEXTS)


def test_char_tokenizer_and_vocab_file_match(tmp_path):
    vocab = tmp_path / "chars.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "a", "b", "c"]) + "\n")
    mine = tokenizers.CharTokenizer(vocab_path=str(vocab))
    ref = j_tok.CharTokenizer(vocab_path=str(vocab))
    assert mine.unk == ref.unk == "[UNK]"
    for t in ("abc", " cab x ", ""):
        assert mine.encode(t) == ref.encode(t)


def test_xlmr_tokenizer_needs_a_backend():
    with pytest.raises(RuntimeError, match="needs"):
        tokenizers.XLMRobertaTokenizer()


def tiny_text_cfg():
    return dict(emb_size=16, hidden_size=16, feedforward_size=32,
                heads_num=4, layers_num=2, max_seq_length=32, dropout=0.0,
                vocab_size=300, embedding=["word", "pos", "seg"],
                encoder="transformer", mask="fully_visible",
                target=["mlm"], pallas_attention=True)


def tiny_vit_cfg():
    return dict(emb_size=16, hidden_size=16, feedforward_size=32,
                heads_num=4, layers_num=2, dropout=0.0, max_seq_length=5,
                embedding=["patch", "pos"], remove_embedding_layernorm=True,
                encoder="transformer", mask="fully_visible",
                layernorm_positioning="pre", target=["cls"],
                image_height=8, image_width=8, patch_size=4, labels_num=2,
                pallas_attention=True)


def jax_params(raw, src, seg, seed):
    model = JTowerModel(JTowerConfig.from_dict(raw))
    params = model.init(jax.random.PRNGKey(seed), src, seg,
                        method=model.encode)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def towers(tmp_path):
    """Both tiny towers' JAX params, their configs as JSON, their weights as
    reference `.bin` files, and a vocabulary."""
    vocab = tmp_path / "vocab.tsv"
    n = write_vocab(vocab)
    assert n <= 300
    tparams = jax_params(tiny_text_cfg(), np.zeros((1, 8), np.int32),
                         np.ones((1, 8), np.int32), 0)
    vparams = jax_params(tiny_vit_cfg(), np.zeros((1, 3, 8, 8), np.float32),
                         np.ones((1, 5), np.int32), 1)
    paths = {"vocab": str(vocab)}
    for name, raw, params in (("text", tiny_text_cfg(), tparams),
                              ("vit", tiny_vit_cfg(), vparams)):
        cfg_path = tmp_path / f"{name}_config.json"
        cfg_path.write_text(json.dumps(raw))
        ckpt = tmp_path / f"{name}.bin"
        torch.save(tower_params_from_flax(params), ckpt)
        paths[f"{name}_config"], paths[f"{name}_ckpt"] = str(cfg_path), \
            str(ckpt)
    return tparams, vparams, paths


def test_extractors_match_jax(towers):
    tparams, vparams, paths = towers
    jtok = j_tok.XLMRobertaTokenizer(vocab_path=paths["vocab"])
    tok = tokenizers.XLMRobertaTokenizer(vocab_path=paths["vocab"])
    jtx = j_ext.TextFeatureExtractor(JTowerConfig.from_dict(tiny_text_cfg()),
                                     tparams, jtok, seq_length=12)
    tx = TextFeatureExtractor(TowerConfig.from_dict(tiny_text_cfg()),
                              tower_params_from_flax(tparams), tok,
                              seq_length=12, device=CPU)
    tags = ["the quick brown fox", "café", "abc xyz abc", "z"]
    src, seg = tx.prepare(tags)
    jsrc, jseg = jtx.prepare(tags)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(seg, jseg)
    got = tx(tags, batch=3)                     # 2 chunks, the last padded
    assert got.shape == (4, 12, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, jtx(tags, batch=3), atol=2e-5,
                               rtol=2e-4)
    assert tx([], batch=3).shape == (0, 12, 16)

    jix = j_ext.ImageFeatureExtractor(JTowerConfig.from_dict(tiny_vit_cfg()),
                                      vparams)
    ix = ImageFeatureExtractor(TowerConfig.from_dict(tiny_vit_cfg()),
                               tower_params_from_flax(vparams), device=CPU)
    frames = np.random.RandomState(0).rand(5, 3, 8, 8).astype(np.float32)
    got = ix(frames, batch=2)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, jix(frames, batch=2), atol=2e-5,
                               rtol=2e-4)


def _keyframes(root, items):
    from PIL import Image

    rng = np.random.RandomState(3)
    for iid, n in items:
        d = root / iid
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.rand(10, 12, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"f{i:02d}.png")


def test_cli_matches_the_jax_cli(towers, tmp_path):
    """Both CLIs on the same JSON, keyframes, configs, `.bin` weights and
    vocabulary: the same items, the same clean_feat.h5 layout, the same
    features within the tower bounds. An item without keyframes is skipped
    by both."""
    import h5py

    _, _, paths = towers
    items = [{"id": f"item{i}", "tags": [{"tag": t, "target": j % 3}
                                         for j, t in enumerate(tags)]}
             for i, tags in enumerate((["abc", "the fox"], ["zz top"] * 5,
                                       [], ["gone"]))]
    (tmp_path / "data.json").write_text(json.dumps(items))
    _keyframes(tmp_path / "frames", [("item0", 3), ("item1", 2),
                                     ("item2", 1)])
    argv = ["--data_json", str(tmp_path / "data.json"),
            "--image_root", str(tmp_path / "frames"),
            "--text_config", paths["text_config"],
            "--text_ckpt", paths["text_ckpt"],
            "--vit_config", paths["vit_config"],
            "--vit_ckpt", paths["vit_ckpt"], "--vocab_path", paths["vocab"],
            "--seq_length", "12", "--batch", "4", "--decode_workers", "2"]
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    res = preprocess.main(argv + ["--output", mine], device="cpu")
    j_pre.main(argv + ["--output", ref])
    assert res["items"] == 3 and res["skipped"] == 1
    with h5py.File(mine, "r") as a, h5py.File(ref, "r") as b:
        assert sorted(a) == sorted(b) == ["item0", "item1", "item2"]
        for iid in a:
            for key in ("text_emb", "img_emb"):
                assert a[iid][key].shape == b[iid][key].shape
                np.testing.assert_allclose(a[iid][key][()], b[iid][key][()],
                                           atol=2e-5, rtol=2e-4)
        assert a["item1"]["text_emb"].shape == (5, 12, 16)
        assert a["item0"]["img_emb"].shape == (1, 3, 16)
        assert a["item2"]["text_emb"].shape == (0, 12, 16)


def test_extract_loop_runs_on_a_frame_source_and_a_sink(towers):
    """What chip_smoke.py drives: synthetic frames in, features to a dict,
    an unreadable item skipped. On the CPU no kernel launches."""
    tparams, vparams, paths = towers
    tok = tokenizers.XLMRobertaTokenizer(vocab_path=paths["vocab"])
    tx = TextFeatureExtractor(TowerConfig.from_dict(tiny_text_cfg()),
                              tower_params_from_flax(tparams), tok,
                              seq_length=12, device=CPU)
    ix = ImageFeatureExtractor(TowerConfig.from_dict(tiny_vit_cfg()),
                               tower_params_from_flax(vparams), device=CPU)
    items = [{"id": "a", "tags": [{"tag": "abc"}]},
             {"id": "b", "tags": [{"tag": "x"}, {"tag": "yz"}]}]
    frames = {"a": np.zeros((2, 3, 8, 8), np.float32)}

    def frames_of(item):
        if item["id"] not in frames:
            raise FileNotFoundError(item["id"])
        return frames[item["id"]]

    out, logged = {}, []
    before = fused_attention.launches
    res = preprocess.extract_items(
        items, frames_of, lambda iid, t, i: out.__setitem__(iid, (t, i)),
        tx, ix, batch=2, log=logged.append)
    assert fused_attention.launches == before
    assert res["items"] == 1 and res["skipped"] == 1
    assert out["a"][0].shape == (1, 12, 16) and out["a"][1].shape == (2, 16)
    assert logged[-1].startswith("SKIP b")


def test_clean_feat_round_trip_into_the_dataset(towers, tmp_path):
    """tests/test_extract.py's loop for the port: extract, write the h5,
    read it back with the port's MovieNetDataset."""
    import h5py

    tparams, vparams, paths = towers
    tok = tokenizers.XLMRobertaTokenizer(vocab_path=paths["vocab"])
    tx = TextFeatureExtractor(TowerConfig.from_dict(tiny_text_cfg()),
                              tower_params_from_flax(tparams), tok,
                              seq_length=8, device=CPU)
    ix = ImageFeatureExtractor(TowerConfig.from_dict(tiny_vit_cfg()),
                               tower_params_from_flax(vparams), device=CPU)
    items, h5_path = [], str(tmp_path / "clean_feat.h5")
    with h5py.File(h5_path, "w") as hf:
        for iid in ("item0", "item1"):
            tags = ["abc", "def", "ghij"]
            text_emb = tx(tags, batch=2)
            frames = np.random.RandomState(0).rand(2, 3, 8, 8).astype(
                np.float32)
            img_emb = ix(frames, batch=2)
            write_clean_feat(h5_path, iid, text_emb, img_emb, h5_file=hf)
            items.append({"id": iid, "tags": [
                {"tag": t, "target": i % 3} for i, t in enumerate(tags)]})
    # the writer also appends to a file by path
    write_clean_feat(h5_path, "item2", text_emb, img_emb)
    items.append({**items[0], "id": "item2"})
    jp = tmp_path / "data.json"
    jp.write_text(json.dumps(items))
    ds = MovieNetDataset(str(jp), h5_path, "eval", max_imgs=2)
    for i in range(3):
        item = ds.get(i)
        assert item["text"].shape == (3, 8, 16)
        assert item["img"].shape == (2, 16)
        assert np.isfinite(item["text"]).all()
    np.testing.assert_allclose(ds.get(0)["img"], img_emb, rtol=1e-6)


def test_load_frames_threaded_matches_sequential_and_jax(tmp_path):
    from PIL import Image

    d = tmp_path / "item0"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        arr = (rng.rand(10, 12, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"f{i:02d}.png")
    (d / "broken.png").write_bytes(b"not an image")
    seq = preprocess.load_frames(str(d), 8, 8, workers=1)
    par = preprocess.load_frames(str(d), 8, 8, workers=4)
    assert seq.shape == (6, 3, 8, 8)
    np.testing.assert_array_equal(seq, par)
    np.testing.assert_array_equal(seq, j_pre.load_frames(str(d), 8, 8))
    empty = tmp_path / "empty"
    os.mkdir(empty)
    with pytest.raises(FileNotFoundError):
        preprocess.load_frames(str(empty), 8, 8)
