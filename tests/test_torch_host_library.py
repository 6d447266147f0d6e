"""The port's host-side library against the JAX package's on seeded inputs:
Vocab.build (one pass and a pool of 3 workers), save/load, add/get/len; the
host dcg_at_k / ndcg_at_k and the meter's compute_ndcg_at_k /
return_ndcg_at_k, exactly; the native parse_tsv, and its refusal of a
ragged file, where JAX returns None."""

import numpy as np
import pytest

from lr2ppo_tpu import native as jnative
from lr2ppo_tpu.data.tokenizers import SpaceTokenizer as JSpace
from lr2ppo_tpu.data.tokenizers import Vocab as JVocab
from lr2ppo_tpu.ops import ndcg as jndcg
from lr2ppo_torch import native
from lr2ppo_torch.data.tokenizers import SpaceTokenizer, Vocab
from lr2ppo_torch.ops import ndcg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("vocab") / "c.txt"
    words = list("abcdefghijk") + ["xy", "zz"]
    lines = [" ".join(rng.choice(words, rng.integers(1, 9)))
             for _ in range(301)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("min_count", [1, 30])
def test_vocab_build_is_jaxs(corpus, workers, min_count):
    want = JVocab.build(corpus, JSpace(None), min_count=min_count,
                        workers_num=workers)
    got = Vocab.build(corpus, SpaceTokenizer(None), min_count=min_count,
                      workers_num=workers)
    assert got.i2w == want.i2w and got.w2i == want.w2i
    assert len(got) == len(want) > 5


def test_vocab_save_load_add_get(corpus, tmp_path):
    v = Vocab.build(corpus, SpaceTokenizer(None), specials=["<pad>", "<x>"])
    path = str(tmp_path / "v.txt")
    v.save(path)
    jv = JVocab().load(path)
    back = Vocab().load(path)
    assert back.i2w == v.i2w == jv.i2w and back.w2i == jv.w2i
    for vocab in (back, jv):
        assert vocab.add("new") == len(v) and vocab.add("a") == v.get("a")
    assert back.get("new") == jv.get("new") and len(back) == len(jv)
    with pytest.raises(KeyError):
        back.get("absent")


def test_host_ndcg_is_jaxs_exactly():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 40):
        rel = rng.integers(0, 4, n)
        pred = rng.permutation(rel)
        for k in (1, 3, 5, 10, 100000000):
            assert ndcg.dcg_at_k(rel, k) == jndcg.dcg_at_k(rel, k)
            assert (ndcg.ndcg_at_k(pred, rel, k)
                    == jndcg.ndcg_at_k(pred, rel, k))
    assert ndcg.ndcg_at_k([0, 0], [0, 0], 3) == 1.0


def test_meter_methods_are_jaxs_exactly():
    rng = np.random.default_rng(2)
    got, want = ndcg.AverageNDCGMeter(), jndcg.AverageNDCGMeter()
    for _ in range(6):
        ideal = np.sort(rng.integers(0, 3, 12))[::-1]
        pred = rng.permutation(ideal)
        g, w = (m.return_ndcg_at_k(pred, ideal) for m in (got, want))
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
        got.compute_ndcg_at_k(pred, ideal)
        want.compute_ndcg_at_k(pred, ideal)
    assert got.ndcg == want.ndcg
    assert got.value() == want.value()


def test_parse_tsv_is_jaxs(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((9, 5)).astype(np.float32)
    path = tmp_path / "d.tsv"
    np.savetxt(path, arr, delimiter="\t", fmt="%.7g")
    with open(path, "a") as f:
        f.write("\n\n")                         # blank lines are skipped
    got, want = native.parse_tsv(str(path)), jnative.parse_tsv(str(path))
    assert got.dtype == np.float32 and got.shape == (9, 5)
    np.testing.assert_array_equal(got, want)
    empty = tmp_path / "empty.tsv"
    empty.write_text("")
    assert native.parse_tsv(str(empty)) is None
    assert jnative.parse_tsv(str(empty)) is None


def test_parse_tsv_raises_on_a_ragged_file(tmp_path):
    path = tmp_path / "ragged.tsv"
    path.write_text("1\t2\t3\n4\t5\n")
    assert jnative.parse_tsv(str(path)) is None
    with pytest.raises(ValueError, match="rows of different lengths"):
        native.parse_tsv(str(path))
    with pytest.raises(ValueError, match="could not read"):
        native.parse_tsv(str(tmp_path / "missing.tsv"))
