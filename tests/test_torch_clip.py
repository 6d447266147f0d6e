"""Contrastive (clip) pretraining of a dual tower on the CPU: both CLIs at
--data_processor clip on the same PIL-written images, captions and starting
weights (the same per-step losses, accuracies and final weights); the port's
CLI at dp 2 (the similarity matrix gathered over the global batch, the
gradients at world 1's scale) and at tp 2 (the streams' transformer layers
split), two gloo ranks each, against the same run in one process; and an
LSTM tower with a 2-D weight of at least 1M elements refused at --tp 2 by
both packages. The ranks import no JAX."""

import json

import numpy as np
import pytest
import torch

from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint)
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.train.checkpoints import save_model
from test_torch_parallel import spawn

torch.set_num_threads(1)

TOKENS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>", "cap", "word"] + [
    str(i) for i in range(8)]
PAIRS, STEPS = 16, 2
# float32 sums in other orders over STEPS AdamW steps: each tensor within
# TOL of its largest magnitude, plus AdamW's amplification of a gradient's
# rounding where the gradient is near eps (tests/test_torch_encoders.py:
# 1e-3 of lr a step)
TOL = 1e-4
LR = 1e-2
STEP_ATOL = STEPS * 1e-3 * LR
# the key projection's bias: its gradient is 0 but for rounding (a softmax
# ignores a shift shared by every key), so Adam's steps on it are that
# rounding's sign (tests/test_torch_sp.py)
SHIFT_LEAF = "self_attn.linear_layers.1.bias"
TOWER = {
    "emb_size": 16, "hidden_size": 16, "feedforward_size": 32,
    "heads_num": 4, "layers_num": 2, "max_seq_length": 32, "dropout": 0.0,
    "encoder": "dual", "target": ["clr"], "projection": True,
    "feature_size": 8, "image_height": 16, "image_width": 16,
    "patch_size": 8,
    "stream_0": {"embedding": ["word", "pos"], "encoder": "transformer",
                 "mask": "causal", "pooling": "last", "hidden_size": 16},
    "stream_1": {"embedding": ["patch", "pos"], "encoder": "transformer",
                 "layernorm_positioning": "pre", "pooling": "first",
                 "hidden_size": 16},
}


def _files(d):
    """PAIRS PIL-written 16 x 16 images with captions, the vocabulary, the
    tower config and a seeded starting `.bin`; the CLI's arguments."""
    from PIL import Image

    rng = np.random.RandomState(0)
    rows = []
    for i in range(PAIRS):
        p = d / f"im{i}.png"
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(p)
        caption = " ".join(rng.choice(["cap", "word"] + [str(j) for j in
                                                        range(8)],
                                      int(rng.randint(1, 6))))
        rows.append(f"{caption}\t{p}")
    (d / "pairs.tsv").write_text("\n".join(rows) + "\n")
    (d / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    (d / "tower.json").write_text(json.dumps(TOWER))
    model = TowerModel(TowerConfig.from_json(str(d / "tower.json"),
                                             vocab_size=len(TOKENS)),
                       with_target=True)
    init_weights(model, torch.Generator().manual_seed(3))
    save_model(str(d / "init.bin"), model)
    return ["--corpus_path", str(d / "pairs.tsv"), "--tower_config",
            str(d / "tower.json"), "--data_processor", "clip",
            "--tokenizer", "space", "--vocab_path", str(d / "v.txt"),
            "--batch_size", "4", "--accumulation_steps", "2",
            "--seq_length", "8", "--total_steps", str(STEPS),
            "--report_steps", "1", "--learning_rate", str(LR),
            "--pretrained_model_path", str(d / "init.bin")]


def _out(path):
    return ["--output_model_path", path, "--log_path", path + ".log"]


def _records(out):
    with open(out + ".log.jsonl") as f:
        return [json.loads(line) for line in f]


def _held(rec, got, wrec, want, what):
    """Per-step losses and accuracies, and every final weight but the key
    biases', within TOL of the reference run's."""
    assert [r["step"] for r in rec] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in rec],
                               [r["loss"] for r in wrec], rtol=TOL)
    np.testing.assert_allclose([r["acc"] for r in rec],
                               [r["acc"] for r in wrec], atol=TOL)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if not k.endswith(SHIFT_LEAF):
            np.testing.assert_allclose(
                got[k].numpy(), w.numpy(), rtol=0,
                atol=STEP_ATOL + TOL * float(w.abs().max()),
                err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The port's CLI in one process: (argv, records, final weights)."""
    from lr2ppo_torch.cli import pretrain

    d = tmp_path_factory.mktemp("clip")
    argv = _files(d)
    out = str(d / "world1")
    pretrain.main(argv + _out(out), device="cpu")
    return d, argv, _records(out), load_tower_checkpoint(out)


def test_clip_cli_matches_the_jax_cli(world1):
    """The JAX CLI on the same files at --dp 1: the same per-step losses
    and accuracies, and the same final weights through the bridge; the
    towers, the projections and logit_scale moved."""
    from lr2ppo_tpu.cli import pretrain as jcli

    d, argv, rec, got = world1
    out = str(d / "jax")
    jcli.main(argv + _out(out) + ["--dp", "1"])
    _held(rec, got, _records(out), load_tower_checkpoint(out), "jax")
    start = load_tower_checkpoint(str(d / "init.bin"))
    for k in ("target.clr.logit_scale", "target.clr.encoder_1_projection",
              "encoder.encoder_0.transformer.1.feed_forward.linear_1.weight",
              "embedding_1.patch.projection.weight"):
        assert not torch.equal(got[k], start[k]), k


def _mesh_rank(rank, world, url, argv, outs):
    from lr2ppo_torch.cli import pretrain

    for name, extra in (("dp2", ["--dp", "2"]),
                        ("tp2", ["--tp", "2", "--dp", "1"])):
        pretrain.main(argv + extra + _out(outs[name]), device="cpu")
    return rank


@pytest.fixture(scope="module")
def mesh_runs(world1, tmp_path_factory):
    """dp 2 and tp 2 in one spawn of two ranks: {leg: (records, final
    weights)}."""
    d = tmp_path_factory.mktemp("clip_mesh")
    _, argv, _, _ = world1
    outs = {name: str(d / name) for name in ("dp2", "tp2")}
    spawn(_mesh_rank, 2, d, argv, outs, timeout=240)
    return {name: (_records(path), load_tower_checkpoint(path))
            for name, path in outs.items()}


@pytest.mark.parametrize("leg", ["dp2", "tp2"])
def test_clip_on_a_mesh_tracks_world_1(world1, mesh_runs, leg):
    """dp 2: each rank holds half of every micro-batch, and the clr target
    gathers both feature sets with their gradients, so the loss is the
    global matrix's and the dp-averaged gradients are world 1's (a 1/dp or
    dp x scale would move the weights by half or twice world 1's steps);
    tp 2: both streams' attention and FFN split over the two ranks."""
    _, _, wrec, want = world1
    rec, got = mesh_runs[leg]
    _held(rec, got, wrec, want, leg)


def _lstm_files(d):
    """An LSTM LM tower whose weight_ih_l0 is 2048 x 512 = 1,048,576
    elements, and a tiny corpus."""
    (d / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    (d / "c.txt").write_text("cap word 1 2 3 4 5 6 7\n" * 20)
    (d / "lstm.json").write_text(json.dumps({
        "emb_size": 512, "hidden_size": 512, "layers_num": 1,
        "dropout": 0.0, "embedding": ["word"], "encoder": "lstm",
        "remove_embedding_layernorm": True, "target": ["lm"]}))
    return ["--corpus_path", str(d / "c.txt"), "--tower_config",
            str(d / "lstm.json"), "--data_processor", "lm", "--tokenizer",
            "space", "--vocab_path", str(d / "v.txt"), "--batch_size", "4",
            "--seq_length", "8", "--total_steps", "1", "--tp", "2",
            "--dp", "1", "--output_model_path", str(d / "x")]


def _tp_refusal_rank(rank, world, url, argv):
    from lr2ppo_torch.cli import pretrain

    try:
        pretrain.main(argv, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def test_a_large_rnn_weight_is_refused_at_tp_2(tmp_path):
    """The tp rule table has no rule for a recurrent weight: at --tp 2 a
    2-D one of at least 1M elements raises in both packages, naming it."""
    from lr2ppo_tpu.cli import pretrain as jcli

    argv = _lstm_files(tmp_path)
    with pytest.raises(ValueError, match="weight_ih_l0"):
        jcli.main(argv)
    for msg in spawn(_tp_refusal_rank, 2, tmp_path, argv, timeout=120):
        assert msg is not None and "encoder.rnn.weight_ih_l0" in msg, msg
    # a gated CNN's kernels are 4-D: replicated by design, as JAX skips
    # its conv_* / gate_* kernels by name
    from lr2ppo_torch.parallel.mesh import assert_tp_coverage

    cnn = TowerModel(TowerConfig.from_dict({
        "emb_size": 512, "hidden_size": 512, "layers_num": 2,
        "kernel_size": 4, "encoder": "gatedcnn", "embedding": ["word"],
        "vocab_size": len(TOKENS), "target": ["lm"]}), device="meta")
    assert cnn.encoder.conv[0].weight.numel() >= 1_000_000
    assert_tp_coverage(list(cnn.named_parameters()), tp=2)
