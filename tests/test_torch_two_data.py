"""The tabular 2-data unification trainer and the projection exporter of the
port against the JAX package's, through both CLIs on the same two LETOR
domains of other raw widths (7 and 11 features, tests/fixtures.py:
make_letor_groups), the same flags and the same starting JAX checkpoint,
dropout off, float32; and the port's fit_two resume, which must end where
an uninterrupted run ends."""

import dataclasses
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_letor_groups, write_letor_h5
from lr2ppo_tpu.cli import pointwise_2data_infer_trad as jinfer
from lr2ppo_tpu.cli import pointwise_2data_trad as jtwo
from lr2ppo_tpu.config import ModelConfig as JModelConfig
from lr2ppo_tpu.data.letor import write_tsv
from lr2ppo_tpu.models.scorer import TwoDataScoreModel as JTwo
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_torch.cli import pointwise_2data_infer_trad as tinfer
from lr2ppo_torch.cli import pointwise_2data_trad as ttwo
from lr2ppo_torch.cli._common import force_family, letor_two_data_loaders
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.models.scorer import TwoDataScoreModel
from lr2ppo_torch.train import checkpoints as tck
from lr2ppo_torch.train.checkpoints import load_any, params_from_flax
from lr2ppo_torch.train.pointwise import TwoDataTrainer
from test_torch_stages import _assert_params_close

torch.set_num_threads(1)

D, HEADS, DIMS = 32, 4, (7, 11)
LR = 1e-3


def _domains(tmp_path):
    """Domain A: 8 training and 4 test queries of 7 features, labels 0-2;
    domain B: 12 and 4 of 11 features, labels 0-4; 20 documents each, in
    the reference's {train,test}.h5 layout."""
    dirs = []
    for i, (dim, n, classes) in enumerate(((7, 8, 3), (11, 12, 5))):
        d = str(tmp_path / f"domain{i}")
        write_letor_h5(os.path.join(d, "train.h5"), make_letor_groups(
            n, 20, dim, classes, seed=10 + i))
        write_letor_h5(os.path.join(d, "test.h5"), make_letor_groups(
            4, 20, dim, classes, seed=20 + i))
        dirs.append(d)
    return dirs


def _start(tmp_path):
    """The JAX package's seeded 2-data model with both projections, merged
    as its TwoDataTrainer merges them, as a pickle both load_any read."""
    jc = JModelConfig(feat_size=D, num_heads=HEADS, family="tabular",
                      trad_dims=list(DIMS))
    trees = [JTwo(jc).init(jax.random.PRNGKey(5),
                           jnp.zeros((2, 3, dim), jnp.float32))
             for dim in DIMS]
    merged = dict(trees[0]["params"])
    for k, v in trees[1]["params"].items():
        merged.setdefault(k, v)
    path = str(tmp_path / "start.ckpt")
    jck.save_checkpoint(path, jax.tree.map(np.asarray, {"params": merged}))
    return path


def _argv(tmp_path, extra=()):
    a, b = _domains(tmp_path)
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({"model": {"drop_p": 0.0,
                                              "forward_drop_p": 0.0}}))
    return ["--train_path", a, "--dev_path", a, "--train_path2", b,
            "--dev_path2", b, "--feat_size", str(D), "--num_heads",
            str(HEADS), "--batch_size", "4", "--epochs_num", "2",
            "--report_steps", "1", "--learning_rate", str(LR),
            "--loader", "thread", "--num_workers", "1", "--dp", "1",
            "--config_path", str(cfg_path), *extra]


def _log(path):
    """Per-step losses and the epochs' mean NDCG@full from a trainer log."""
    with open(path) as f:
        text = f.read()
    losses = [(int(s), float(v)) for s, v in
              re.findall(r"step (\d+) loss ([-+\d.e]+)", text)]
    evals = [float(v) for v in re.findall(r"mean NDCG@full ([\d.]+)", text)]
    return losses, evals


def test_pointwise_2data_trad_tracks_the_jax_trainer(tmp_path):
    """2 epochs of the round-robin A0 B0 A1 B1 B2 from the same JAX
    checkpoint, the dims read from the data. Per-step losses agree to 1e-4
    relative, the epochs' mean NDCG to 1e-3 (the JAX log prints 4
    decimals), the final parameters as in the multimodal stages; the best
    `.bin` loads strict into a TwoDataScoreModel of dims (7, 11)."""
    argv = _argv(tmp_path, ["--save_state_steps", "1",
                            "--pretrained_model_path", _start(tmp_path)])
    out = {}
    for name, main, kw in (("jax", jtwo.main, {}),
                           ("torch", ttwo.main, {"device": "cpu"})):
        log = str(tmp_path / f"{name}.log")
        model = str(tmp_path / f"{name}.bin")
        best = main(argv + ["--log_path", log, "--output_model_path", model],
                    **kw)
        if name == "jax":
            with open(model + ".state", "rb") as f:
                final = params_from_flax(pickle.load(f)["tree"]["params"])
        else:
            final = tck.load_state(model + ".state")["models"]["model"]
        out[name] = (best, *_log(log), final)
    (jbest, jloss, jevals, jfinal) = out["jax"]
    (tbest, tloss, tevals, tfinal) = out["torch"]
    assert [s for s, _ in tloss] == [s for s, _ in jloss] == list(
        range(1, 11))
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss],
                               rtol=1e-4, atol=1e-6)
    assert len(tevals) == len(jevals) == 2
    np.testing.assert_allclose(tevals, jevals, rtol=1e-3)
    assert abs(tbest - jbest) < 1e-3
    _assert_params_close(jfinal, tfinal, steps=10)
    cfg = dataclasses.replace(parse_config([]).model, feat_size=D,
                              num_heads=HEADS, family="tabular",
                              trad_dims=list(DIMS))
    TwoDataScoreModel(cfg).load_state_dict(
        load_any(str(tmp_path / "torch.bin")), strict=True)


@pytest.mark.parametrize("rows", [37, 4500])
def test_pointwise_2data_infer_trad_writes_the_jax_tsv(tmp_path, rows):
    """Both exporters read the same JAX 2-data checkpoint and project the
    same 7-wide tsv (4,500 rows: a full batch of 4,096 and a padded one):
    the label and qid columns are byte-equal, the 32 projected columns agree
    to float32 rounding (rtol 1e-5, atol 1e-6)."""
    rng = np.random.RandomState(rows)
    arr = np.concatenate([rng.randint(0, 3, (rows, 1)),
                          np.sort(rng.randint(0, 50, (rows, 1)), axis=0),
                          rng.randn(rows, 7)], axis=1).astype(np.float32)
    src = str(tmp_path / "in.tsv")
    write_tsv(arr, src)
    ckpt = _start(tmp_path)
    got = {}
    for name, main, kw in (("jax", jinfer.main, {}),
                           ("torch", tinfer.main, {"device": "cpu"})):
        out = str(tmp_path / f"{name}.tsv")
        main(["--pretrained_model_path", ckpt, "--feat_size", str(D),
              "--num_heads", str(HEADS), "--input_features_path", src,
              "--output_features_path", out], **kw)
        with open(out) as f:
            lines = f.read().splitlines()
        got[name] = ([ln.split("\t", 2)[:2] for ln in lines],
                     np.loadtxt(out, delimiter="\t", ndmin=2))
    assert got["torch"][1].shape == (rows, 2 + D)
    assert got["torch"][0] == got["jax"][0]
    np.testing.assert_allclose(got["torch"][1][:, 2:], got["jax"][1][:, 2:],
                               rtol=1e-5, atol=1e-6)


def _infer_rank(rank, world, url, argv, dp, tp):
    extra = ["--dp", str(dp), "--tp", str(tp), "--distributed", "true",
             "--coordinator", url, "--num_processes", str(world),
             "--process_id", str(rank)]
    i = argv.index("--output_features_path") + 1
    argv = argv[:i] + [argv[i] + f".rank{rank}"] + argv[i + 1:]
    tinfer.main(argv + extra, device="cpu")


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)], ids=["dp2", "tp2"])
def test_project_tsv_on_a_mesh_writes_world_1s_tsv(tmp_path, dp, tp):
    """The exporter as two gloo ranks: every rank projects every row, as
    every JAX process does, and rank 0 alone writes. At dp 2 the tsv is
    world 1's byte for byte; at tp 2 the projection's fc2 is row-split, so
    its float32 partial products are summed over tp in another order: the
    label and qid columns are byte-equal and the projection agrees to
    float32 rounding (rtol 1e-5, atol 1e-6)."""
    from test_torch_parallel import spawn

    rng = np.random.RandomState(5)
    rows = 300
    arr = np.concatenate([rng.randint(0, 3, (rows, 1)),
                          np.sort(rng.randint(0, 50, (rows, 1)), axis=0),
                          rng.randn(rows, 7)], axis=1).astype(np.float32)
    src = str(tmp_path / "in.tsv")
    write_tsv(arr, src)
    ckpt = _start(tmp_path)
    argv = ["--pretrained_model_path", ckpt, "--feat_size", str(D),
            "--num_heads", str(HEADS), "--input_features_path", src,
            "--output_features_path"]
    one = str(tmp_path / "one.tsv")
    tinfer.main(argv + [one], device="cpu")
    out = str(tmp_path / "mesh.tsv")
    spawn(_infer_rank, 2, tmp_path, argv + [out], dp, tp, timeout=120)
    assert not os.path.exists(out + ".rank1")
    with open(one) as f, open(out + ".rank0") as g:
        want, got = f.read(), g.read()
    if tp == 1:
        assert got == want
        return
    assert ([ln.split("\t", 2)[:2] for ln in got.splitlines()]
            == [ln.split("\t", 2)[:2] for ln in want.splitlines()])
    np.testing.assert_allclose(np.loadtxt(out + ".rank0", ndmin=2),
                               np.loadtxt(one, ndmin=2), rtol=1e-5,
                               atol=1e-6)


class Interrupted(Exception):
    pass


class Stop:
    """Wraps the round-robin's loaders: raises Interrupted when asked for
    a batch after `n` batches in all (over both loaders and every epoch),
    as a run killed between two steps."""

    def __init__(self, n):
        self.left = n

    def wrap(self, loader):
        stop = self

        class Wrapped:
            def __len__(self):
                return len(loader)

            def set_epoch(self, epoch):
                loader.set_epoch(epoch)

            def __iter__(self):
                for batch in loader:
                    if stop.left == 0:
                        raise Interrupted
                    if stop.left is not None:
                        stop.left -= 1
                    yield batch

        return Wrapped()


def _fit_two(tmp_path, argv, stop=None):
    cfg = force_family(parse_config(argv), "tabular")
    cfg, loaders, evs = letor_two_data_loaders(cfg)
    stop = Stop(stop)
    state, best = TwoDataTrainer(cfg, "cpu").fit_two(
        [stop.wrap(l) for l in loaders], evs)
    return state, best


@pytest.mark.parametrize("k", [3, 5], ids=["mid_epoch", "epoch_boundary"])
def test_fit_two_resume_equals_an_uninterrupted_run(tmp_path, k):
    """Hash dropout on, so the restored generator matters. A run killed
    after its step-k `.state` (step 3: A0 B0 A1 done, B1 next; step 5: the
    first epoch and its eval done) and resumed from it ends with the
    parameters, moments, counters and best of the run never killed: the
    resume replays the round-robin's draws without training."""
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({"model": {"hash_dropout": True}}))
    base = _argv(tmp_path, ["--save_state_steps", "1",
                            "--pretrained_model_path", _start(tmp_path)])
    base[base.index("--config_path") + 1] = str(cfg_path)
    whole = str(tmp_path / "whole.bin")
    _, best = _fit_two(tmp_path, base + ["--output_model_path", whole])
    cut = str(tmp_path / "cut.bin")
    with pytest.raises(Interrupted):
        _fit_two(tmp_path, base + ["--output_model_path", cut], stop=k)
    assert tck.load_state(cut + ".state")["step"] == k
    _, rbest = _fit_two(tmp_path, base + ["--output_model_path", cut,
                                          "--resume_path", cut + ".state"])
    assert rbest == best
    want, got = tck.load_state(whole + ".state"), tck.load_state(
        cut + ".state")
    assert got["step"] == want["step"] == 10 and got["best"] == want["best"]
    for part in ("models", "optims"):
        w, g = want[part]["model"], got[part]["model"]
        if part == "optims":
            assert g["count"] == w["count"]
            w, g = {**w["mu"], **{f"nu.{n}": v for n, v in w["nu"].items()}}, \
                {**g["mu"], **{f"nu.{n}": v for n, v in g["nu"].items()}}
        for name in w:
            assert torch.equal(g[name], w[name]), (part, name)
