"""The port's LETOR pipeline (lr2ppo_torch/data/letor.py, lr2ppo_torch/native
and the preprocess_data CLI) against the JAX package's on the same seeded
files: the parses, the grouping, the qid offset, the tsv round trip, the
three datasets' examples and every preprocess_data subcommand's output are
equal; the native parser never falls back to numpy on its own."""

import os

import h5py
import numpy as np
import pytest
import torch

from fixtures import make_letor_groups, make_svmlight
from lr2ppo_tpu.cli import preprocess_data as jpre
from lr2ppo_tpu.data import letor as jletor
from lr2ppo_torch import native
from lr2ppo_torch.cli import preprocess_data as tpre
from lr2ppo_torch.data import letor as tletor

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FEAT = 12


@pytest.fixture
def svm(tmp_path):
    return make_svmlight(str(tmp_path / "d.svm"), n_rows=200, n_feat=N_FEAT,
                         n_qids=7, seed=3)


def test_parser_source_is_the_jax_packages():
    with open(os.path.join(REPO, "lr2ppo_tpu/native/parser.cpp"), "rb") as f:
        want = f.read()
    with open(native.SRC, "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("use_native", [True, False])
def test_parse_svmlight_equals_jax(svm, use_native):
    """The same parser on both sides: equal arrays, qid-sorted; the native
    and the numpy parse are equal too (the file's values are short
    decimals, which both round to float32 alike)."""
    got = tletor.parse_svmlight_file(svm, N_FEAT, use_native=use_native)
    want = jletor.parse_svmlight_file(svm, N_FEAT, use_native=use_native)
    assert got.dtype == np.float32 and got.shape == (200, 2 + N_FEAT)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got[:, 1]) >= 0).all()
    other = tletor.parse_svmlight_file(svm, N_FEAT,
                                       use_native=not use_native)
    np.testing.assert_array_equal(got, other)


def test_native_build_failure_raises(svm, monkeypatch):
    """A compiler that is not there: the native parse raises and names the
    numpy opt-out, where the JAX package would fall back silently; the
    numpy parser still runs when asked for."""
    monkeypatch.setattr(native, "CXX", os.path.join(
        os.path.dirname(svm), "no-such-compiler"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="use_native_loader 0"):
        tletor.parse_svmlight_file(svm, N_FEAT)
    assert tletor.parse_svmlight_file(svm, N_FEAT, use_native=False).shape \
        == (200, 2 + N_FEAT)


@pytest.mark.parametrize("line", ["1 qid:3 1:0.5 99:1.0",     # index > F
                                  "1 qid:3 1:",                # no value
                                  "1 3 1:0.5"])                # no qid
def test_native_parser_rejects_malformed_lines(tmp_path, line):
    """A data line the native parser cannot read raises ValueError: no
    silent numpy retry, no dropped row."""
    path = tmp_path / "bad.svm"
    path.write_text(f"0 qid:1 1:0.25\n{line}\n")
    with pytest.raises(ValueError, match="native parser"):
        tletor.parse_svmlight_file(str(path), 3)


def test_group_disjoint_and_tsv_round_trip_equal_jax(svm, tmp_path):
    arr = jletor.parse_svmlight_file(svm, N_FEAT, use_native=False)
    for docs, seed in ((20, 0), (5, 7)):
        got = tletor.group_queries(arr, docs, seed)
        want = jletor.group_queries(arr, docs, seed)
        assert list(got) == list(want)
        for q in want:
            assert got[q].shape == (docs, 2 + N_FEAT)
            np.testing.assert_array_equal(got[q], want[q])
    np.testing.assert_array_equal(tletor.make_qids_disjoint(arr, 1000),
                                  jletor.make_qids_disjoint(arr, 1000))
    tletor.write_tsv(arr, str(tmp_path / "t.tsv"))
    jletor.write_tsv(arr, str(tmp_path / "j.tsv"))
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    np.testing.assert_array_equal(tletor.read_tsv(str(tmp_path / "t.tsv")),
                                  arr)


def _same_examples(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got.get(i), want.get(i)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_datasets_equal_jax():
    """LTRPointwiseDataset, LTRRewardDataset (5 classes, the 4-index
    orderings) and LTRPPODataset (train pairs and eval queries) give the
    JAX package's examples for the same groups and seeds."""
    groups = make_letor_groups(n_queries=6, docs=20, n_feat=8, n_classes=5,
                               seed=2)
    tq, jq = tletor.LetorQueries(groups), jletor.LetorQueries(groups)
    _same_examples(tletor.LTRPointwiseDataset(tq),
                   jletor.LTRPointwiseDataset(jq))
    for max_tags, seed in ((20, 0), (3, 5)):
        _same_examples(tletor.LTRRewardDataset(tq, max_tags, 5, seed),
                       jletor.LTRRewardDataset(jq, max_tags, 5, seed))
        for train in (True, False):
            _same_examples(tletor.LTRPPODataset(tq, train, max_tags, seed),
                           jletor.LTRPPODataset(jq, train, max_tags, seed))


def _h5(path):
    with h5py.File(path, "r") as hf:
        return {k: hf[k][()] for k in hf.keys()}


@pytest.mark.parametrize("cmd", ["svm2tsv", "svm2tsv_numpy", "disjoint",
                                 "tsv2h5", "combine", "check_disjoint",
                                 "check_overlap"])
def test_preprocess_data_writes_what_jax_writes(tmp_path, svm, cmd, capsys):
    """Each subcommand through both CLIs on the same inputs: byte-equal tsv
    files, equal grouped .h5 contents, the same printed report and exit."""
    src = str(tmp_path / "src.tsv")
    jpre.main(["svm2tsv", svm, src, "--num_features", str(N_FEAT)])
    other = str(tmp_path / "other.tsv")
    jpre.main(["disjoint", src, other, "--offset", "50"])
    capsys.readouterr()
    argv = {
        "svm2tsv": ["svm2tsv", svm, "{out}.tsv", "--num_features",
                    str(N_FEAT)],
        "svm2tsv_numpy": ["svm2tsv", svm, "{out}.tsv", "--num_features",
                          str(N_FEAT), "--use_native_loader", "0"],
        "disjoint": ["disjoint", src, "{out}.tsv"],
        "tsv2h5": ["tsv2h5", src, "{out}.h5", "--docs_per_query", "9",
                   "--seed", "4"],
        "combine": ["combine", src, other, "{out}.tsv"],
        "check_disjoint": ["check", src, other],
        "check_overlap": ["check", src, src],
    }[cmd]
    outs, printed, exits = {}, {}, {}
    for name, main in (("jax", jpre.main), ("torch", tpre.main)):
        out = str(tmp_path / name)
        try:
            main([a.format(out=out) for a in argv])
            exits[name] = 0
        except SystemExit as e:
            exits[name] = e.code
        printed[name] = capsys.readouterr().out.replace(out, "OUT")
        outs[name] = out
    assert printed["torch"] == printed["jax"] and exits["torch"] == exits["jax"]
    if "{out}.tsv" in argv:
        with open(outs["torch"] + ".tsv", "rb") as t, \
                open(outs["jax"] + ".tsv", "rb") as j:
            assert t.read() == j.read()
    elif "{out}.h5" in argv:
        got, want = _h5(outs["torch"] + ".h5"), _h5(outs["jax"] + ".h5")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        # the count of shared qids; exit 1 where there are any
        want = (0, "intersection: 0") if cmd == "check_disjoint" else (
            1, "intersection: 7")
        assert (exits["torch"], printed["torch"].strip()) == want


def jletor_loader(q, cfg):
    """The JAX 2-data CLI's training loader of one domain
    (lr2ppo_tpu/cli/pointwise_2data_trad.py)."""
    from lr2ppo_tpu.data import Loader

    return Loader(jletor.LTRPointwiseDataset(q), cfg.batch_size,
                  shuffle=True, seed=cfg.seed,
                  num_workers=cfg.data.num_workers, reuse_buffers=True)


@pytest.mark.parametrize("kind", ["pointwise", "reward", "ppo",
                                  "two_data"])
def test_cli_loader_builders_equal_jax(tmp_path, kind):
    """The port's LETOR builders (lr2ppo_torch/cli/_common.py) give the JAX
    package's batches, in order, from the same {train,test}.h5 dirs and
    flags: the training loader's first epoch and every eval batch."""
    from fixtures import make_planted_letor_dirs
    from lr2ppo_tpu.cli import _common as jcommon
    from lr2ppo_tpu.config import parse_config as jparse
    from lr2ppo_torch.cli import _common as tcommon
    from lr2ppo_torch.config import parse_config as tparse

    src, merged = make_planted_letor_dirs(str(tmp_path), n_src=6, n_tgt=6,
                                          n_test=3, n_feat=8, seed=4)
    argv = ["--train_path", merged, "--dev_path", merged, "--train_path2",
            src, "--dev_path2", src, "--batch_size", "4", "--max_tags", "3",
            "--num_workers", "1", "--seed", "5"]
    batches = {}
    for name, common, parse in (("jax", jcommon, jparse),
                                ("torch", tcommon, tparse)):
        cfg = common.force_family(parse(argv), "tabular")
        if kind == "two_data" and name == "torch":
            cfg, train, evs = common.letor_two_data_loaders(cfg)
        elif kind == "two_data":
            q = [common.letor_queries(p) for p in (merged, src)]
            train = [jletor_loader(q_, cfg) for q_ in q]
            evs = [common.letor_eval_loader(cfg, jletor.LTRPointwiseDataset,
                                            path=p) for p in (merged, src)]
        else:
            made = getattr(common, f"letor_{kind}_loaders")(cfg)
            train = [made[0](1) if kind == "ppo" else made[0]]
            evs = [made[1]]
        out = []
        for loader in list(train) + list(evs):
            if hasattr(loader, "set_epoch"):     # EvalLoader has none
                loader.set_epoch(1)
            out += [{k: np.array(v) for k, v in b.items()} for b in loader]
        batches[name] = out
    assert len(batches["torch"]) == len(batches["jax"]) > 2
    for t, j in zip(batches["torch"], batches["jax"]):
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])

