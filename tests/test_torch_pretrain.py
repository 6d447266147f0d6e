"""Tower pretraining end to end on the CPU, the port against the JAX
package: both CLIs pretrain the same tiny MLM tower (2 layers of 16, 4
heads, a 13-entry space vocabulary) from the same `.bin`, 6 steps of 2
accumulated micro-batches at dropout 0, and give the same per-step losses
and accuracies and the same final weights, to 1e-4; a resume from the
step-3 `.state` (hash dropout on) equals the uninterrupted run bit for bit;
the checkpoints load strict into the port's trainer (the JAX `-best` too)
and into the extraction path; `python -m lr2ppo_torch.cli pretrain --device
cpu` runs; what stays refused raises as in JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lr2ppo_tpu.cli import pretrain as jcli
from lr2ppo_torch.cli import pretrain as tcli
from lr2ppo_torch.data.tokenizers import SpaceTokenizer, str2tokenizer
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint)
from lr2ppo_torch.towers.extract import TextFeatureExtractor
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.towers.torch_import import encoder_state
from lr2ppo_torch.train.checkpoints import save_model

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_special_ids():
    """Both CLIs set their processors' module-wide special ids from the
    tokenizer (lr2ppo_tpu/cli/pretrain.py, lr2ppo_torch/cli/pretrain.py);
    restore them after each test, so a later test in the same worker
    frames its instances with the defaults."""
    from lr2ppo_tpu.data import pretrain_processors as pp
    from lr2ppo_torch.data import pretrain_processors as tpp

    old = [(m, (m.CLS, m.PAD, m.SEP)) for m in (pp, tpp)]
    yield
    for m, ids in old:
        m.set_special_ids(*ids)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + list("abcdefgh")
TOWER = {"emb_size": 16, "hidden_size": 16, "feedforward_size": 32,
         "heads_num": 4, "layers_num": 2, "max_seq_length": 32,
         "dropout": 0.0, "embedding": ["word", "pos", "seg"],
         "encoder": "transformer", "mask": "fully_visible",
         "target": ["mlm"]}
STEPS = 6
# float32 on both sides, summed in other orders over 6 AdamW steps
TOL = 1e-4


def _files(tmp_path, **tower):
    """vocab, corpus (50 lines: 29 rows of 16, 4 steps an epoch) and
    tower config."""
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    rng = np.random.RandomState(0)
    (tmp_path / "c.txt").write_text("".join(
        " ".join(rng.choice(list("abcdefgh"), 8)) + "\n" for _ in range(50)))
    (tmp_path / "tower.json").write_text(json.dumps({**TOWER, **tower}))
    return {k: str(tmp_path / f) for k, f in
            (("vocab", "v.txt"), ("corpus", "c.txt"),
             ("tower", "tower.json"))}


def _argv(files, out, *extra):
    return ["--corpus_path", files["corpus"], "--tower_config",
            files["tower"], "--tokenizer", "space", "--vocab_path",
            files["vocab"], "--output_model_path", out, "--batch_size", "4",
            "--accumulation_steps", "2", "--seq_length", "16",
            "--total_steps", str(STEPS), "--report_steps", "1",
            "--learning_rate", "1e-2", "--log_path", out + ".log", *extra]


def _records(out):
    with open(out + ".log.jsonl") as f:
        return [json.loads(line) for line in f]


def _init_bin(files, path, seed=3):
    cfg = TowerConfig.from_json(files["tower"], vocab_size=len(TOKENS))
    model = TowerModel(cfg, with_target=True)
    init_weights(model, torch.Generator().manual_seed(seed))
    save_model(path, model)
    return cfg


def test_pretrain_matches_the_jax_trainer(tmp_path):
    files = _files(tmp_path)
    init = str(tmp_path / "init.bin")
    cfg = _init_bin(files, init)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jbest = jcli.main(_argv(files, jout, "--pretrained_model_path", init,
                            "--dp", "1"))
    tbest = tcli.main(_argv(files, tout, "--pretrained_model_path", init),
                      device="cpu")
    jrec, trec = _records(jout), _records(tout)
    assert [r["step"] for r in trec] == list(range(1, STEPS + 1))
    assert [r["step"] for r in jrec] == [r["step"] for r in trec]
    np.testing.assert_allclose([r["loss"] for r in trec],
                               [r["loss"] for r in jrec], rtol=TOL)
    np.testing.assert_allclose([r["acc"] for r in trec],
                               [r["acc"] for r in jrec], atol=TOL)
    assert all(r["tokens_s"] > 0 for r in trec)
    np.testing.assert_allclose(tbest, jbest, atol=TOL)
    # the final weights: the JAX pickle through the bridge
    want = load_tower_checkpoint(jout)
    got = load_tower_checkpoint(tout)
    assert got.keys() == want.keys()
    start = load_tower_checkpoint(init)
    for k, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=TOL * scale, err_msg=k)
    assert not torch.equal(got["target.mlm.linear_2.weight"],
                           start["target.mlm.linear_2.weight"])
    # the JAX -best and the port's -best load strict into the port's model
    for best in (jout + "-best", tout + "-best"):
        TowerModel(cfg, with_target=True).load_state_dict(
            load_tower_checkpoint(best), strict=True)
    # ... and start the port's trainer
    tcli.main(_argv(files, str(tmp_path / "again"), "--pretrained_model_path",
                    jout + "-best", "--total_steps", "1"), device="cpu")
    # the port's final checkpoint feeds the extraction path (encoder keys)
    text = TextFeatureExtractor(
        cfg, encoder_state(load_tower_checkpoint(tout)),
        SpaceTokenizer(files["vocab"]), seq_length=8, device="cpu")
    feats = text(["a b c", "h g"])
    assert feats.shape == (2, 8, 16) and np.isfinite(feats).all()


def test_resume_from_a_state_equals_the_uninterrupted_run(tmp_path):
    """Hash dropout on: the resumed run restores the model, the AdamW
    moments, the dropout generator and the data position (mid-epoch)."""
    files = _files(tmp_path, dropout=0.1)
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    tcli.main(_argv(files, whole, "--hash_dropout", "--save_checkpoint_steps",
                    "3"), device="cpu")
    assert os.path.exists(whole + "-3") and os.path.exists(whole + "-6")
    tcli.main(_argv(files, part, "--hash_dropout", "--resume_path",
                    whole + "-3"), device="cpu")
    a, b = load_tower_checkpoint(whole), load_tower_checkpoint(part)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ra = {r["step"]: (r["loss"], r["acc"]) for r in _records(whole)}
    rb = {r["step"]: (r["loss"], r["acc"]) for r in _records(part)}
    assert sorted(rb) == [4, 5, 6]
    assert all(rb[s] == ra[s] for s in rb)


def test_adafactor_and_remat_pretrain(tmp_path):
    """The trainer with Adafactor (no CLI flag, as in JAX: the optimizer
    config) and remat with hash dropout: finite losses, moved weights."""
    files = _files(tmp_path, dropout=0.1, remat=True)
    out = str(tmp_path / "ada")
    trainer, loader = tcli.build(tcli.parser().parse_args(
        _argv(files, out, "--hash_dropout")), "cpu")
    trainer.cfg.optim.optimizer = "adafactor"
    state, _ = trainer.fit(loader, 2)
    assert type(state.opt).__name__ == "Adafactor" and state.opt.count == 2
    assert np.isfinite([r["loss"] for r in _records(out)]).all()
    init = TowerModel(trainer.tower_cfg, with_target=True)
    init_weights(init, torch.Generator().manual_seed(trainer.cfg.seed))
    moved = load_tower_checkpoint(out)
    assert not torch.equal(moved["encoder.transformer.0.feed_forward."
                                 "linear_1.weight"],
                           init.state_dict()["encoder.transformer.0."
                                             "feed_forward.linear_1.weight"])


@pytest.mark.parametrize("extra,match", [
    # --pp and --sp run (tests/test_torch_pipeline.py, test_torch_sp.py);
    # what stays refused is outside their envelope, as in JAX
    (["--pp", "2", "--fsdp"], "zero1/fsdp"), (["--sp"], "--tp > 1"),
    # every processor runs (tests/test_torch_vision_speech.py); a vit
    # manifest's label must be an integer, and S2T's frames a multiple of 4
    # (its seg spans max_audio_frames // 4), as in JAX
    (["--data_processor", "vit", "--corpus_path", "{tmp}/labels.tsv"],
     "invalid literal for int"),
    (["--data_processor", "s2t", "--corpus_path", "{tmp}/speech.tsv",
      "--tower_config", "{tmp}/speech.json", "--max_audio_frames", "30",
      "--tgt_seq_length", "8"],
     "multiple of 4"),
    (["--jax_platform", "cpu"], "--device"),
], ids=["pp", "sp", "vit", "s2t", "jax_platform"])
def test_what_is_not_ported_raises(tmp_path, extra, match):
    import wave

    files = _files(tmp_path)
    (tmp_path / "labels.tsv").write_text(f"cat\t{tmp_path}/im.png\n")
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.sin(np.arange(4000) / 7.0) * 9000).astype(
            np.int16).tobytes())
    (tmp_path / "speech.tsv").write_text(f"a b\t{tmp_path}/a.wav\n")
    (tmp_path / "speech.json").write_text(json.dumps({
        **TOWER, "embedding": ["speech", "sinusoidalpos"],
        "tgt_embedding": ["word", "sinusoidalpos"], "decoder": "transformer",
        "target": ["lm"]}))
    extra = [a.format(tmp=tmp_path) for a in extra]
    with pytest.raises((NotImplementedError, SystemExit, ValueError),
                       match=match):
        tcli.main(_argv(files, str(tmp_path / "x"), *extra), device="cpu")
    # the image tokenizer is ported; like JAX's, it refuses text
    with pytest.raises(TypeError, match="tokenizes images"):
        str2tokenizer["image"](vqgan_config=dict(
            ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
            resolution=8, z_channels=8, n_embed=16, embed_dim=8),
            device="cpu").tokenize("a b")


@pytest.mark.parametrize("extra,match", [
    (["--dp", "2"], "needs 2 devices, have 1"),
    (["--tp", "2"], "needs 2 devices, have 1"),
    (["--zero1"], None), (["--fsdp"], None),
    (["--distributed"], "--num_processes"),
], ids=["dp", "tp", "zero1", "fsdp", "distributed"])
def test_mesh_flags_take_the_jax_meaning(tmp_path, extra, match):
    """In one process: a mesh larger than the world raises, as the JAX
    make_mesh asserts; zero1 and fsdp do nothing at dp 1; --distributed
    without a rank and a world raises. Multi-process runs are in
    tests/test_torch_parallel*.py."""
    files = _files(tmp_path)
    argv = _argv(files, str(tmp_path / "x"), "--total_steps", "1", *extra)
    if match is None:
        tcli.main(argv, device="cpu")
        assert np.isfinite([r["loss"] for r in
                            _records(str(tmp_path / "x"))]).all()
        return
    with pytest.raises(ValueError, match=match):
        tcli.main(argv, device="cpu")


def test_no_gpu_raises_rather_than_running_on_the_cpu(tmp_path):
    files = _files(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_argv(files, str(tmp_path / "x")))


def test_dispatcher_runs_pretrain_on_the_cpu(tmp_path):
    files = _files(tmp_path)
    out = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "lr2ppo_torch.cli", "pretrain",
         *_argv(files, out, "--total_steps", "2"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "tokens/s" in proc.stdout
    assert [r["step"] for r in _records(out)] == [1, 2]
    assert os.path.exists(out) and os.path.exists(out + "-best")
