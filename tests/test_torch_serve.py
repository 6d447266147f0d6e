"""lr2ppo_torch.cli.serve against lr2ppo_tpu.cli.serve on the same store,
checkpoint and flags: the same items, rankings, scores and NDCG, with int8
off and on. At feat 128 and 8 text tokens, 4 items x the 8-tag bucket give
256 text rows, so with the size gates zeroed the int8 run takes the fused
FFN in both packages (Pallas interpret in JAX, the plain version here)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_movienet
from lr2ppo_tpu.cli import serve as jserve
from lr2ppo_tpu.config import ModelConfig
from lr2ppo_tpu.models import ScoreModel as JScore
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_torch.cli import serve
from lr2ppo_torch.models import layers as tlayers
from lr2ppo_torch.ops import int8 as tint8

torch.set_num_threads(1)

FEAT, SEQ, IMGS, HEADS = 128, 8, 4, 4


def _argv(ckpt, jp, out, int8, item_dtype="float32"):
    return ["--pretrained_model_path", ckpt, "--test_path", jp,
            "--ranking_path", out, "--family", "multimodal",
            "--feat_size", str(FEAT), "--seq_length", str(SEQ),
            "--num_heads", str(HEADS), "--max_imgs", str(IMGS),
            "--mode", "reg", "--compute_dtype", "float32",
            "--batch_size", "4", "--dp", "1", "--item_dtype", item_dtype,
            "--int8", int8]


def _lines(path):
    with open(path) as f:
        return {ln["id"]: ln for ln in map(json.loads, f)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both services on one store and checkpoint: int8 false and true with
    float32 items, and int8 false with the loader's default bfloat16
    items."""
    tmp = tmp_path_factory.mktemp("torch_serve")
    jp, _ = make_movienet(tmp / "d", n_items=8, seq=SEQ, feat=FEAT,
                          n_imgs_range=(1, 4), seed=2)
    cfg = ModelConfig(feat_size=FEAT, seq_length=SEQ, max_imgs=IMGS,
                      visual_feat_dim=FEAT, num_heads=HEADS)
    text = jnp.zeros((1, 2, SEQ, FEAT))
    img = jnp.zeros((1, IMGS, FEAT))
    params = JScore(cfg, jnp.float32).init(jax.random.PRNGKey(7), text, img)
    ckpt = str(tmp / "best.ckpt")
    jck.save_checkpoint(ckpt, {"actor": params})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jint8, tint8):
            mp.setattr(mod, "INT8_MIN_KERNEL_ELEMENTS", 0)
            mp.setattr(mod, "INT8_DYNQUANT_MIN_FLOPS", 0)
            mp.setattr(mod, "INT8_DYNQUANT_MIN_WIDTH", 0)
        mp.setattr(jint8, "PALLAS_FUSED_FFN", True)   # 8 fake devices
        fused = []
        real = tlayers.int8_mlp
        mp.setattr(tlayers, "int8_mlp",
                   lambda *a, **kw: fused.append(1) or real(*a, **kw))
        for int8, items in (("false", "float32"), ("true", "float32"),
                            ("false", "bfloat16")):
            for name, main, kw in (("jax", jserve.main, {}),
                                   ("torch", serve.main, {"device": "cpu"})):
                fused.clear()
                path = str(tmp / f"{name}_{int8}_{items}.jsonl")
                res = main(_argv(ckpt, jp, path, int8, items), **kw)
                out[name, int8, items] = (res, _lines(path), len(fused))
    return jp, ckpt, out


def _assert_same_rankings(out, int8, items):
    """The same items, rankings, scores and NDCG. float32 scores agree to
    float32 summation order; with int8 on, tests/test_int8.py's tie-flip
    tolerance (an activation an ulp apart can round to the other int8
    step), and the orders and NDCG are compared where the scores stand
    further apart than the bound."""
    (jres, jl, _), (tres, tl, fused) = (out["jax", int8, items],
                                        out["torch", int8, items])
    assert jres["items"] == tres["items"] == len(jl) == 8
    assert jres["int8"] is tres["int8"] is (int8 == "true")
    # 2 batches; text_proj and the XiT FFN take the fused kernel's route
    assert fused == (4 if int8 == "true" else 0)
    assert set(tl) == set(jl)
    spread = max(np.abs(ln["pred_scores"]).max() for ln in jl.values())
    bound = 1e-5 * spread if int8 == "false" else 0.02 * spread
    diffs = []
    for iid, ref in jl.items():
        got = tl[iid]
        assert set(got) == set(ref)
        assert got["tags"] == ref["tags"]
        diffs += list(np.abs(np.subtract(got["pred_scores"],
                                         ref["pred_scores"])))
        s = np.asarray(ref["pred_scores"])
        if np.all(np.diff(s) < -2 * bound):         # separated scores
            assert got["pred_order"] == ref["pred_order"]
            assert got["tags_rearranged"] == ref["tags_rearranged"]
            np.testing.assert_allclose(got["ndcg"], ref["ndcg"], rtol=1e-6)
    diffs = np.asarray(diffs)
    assert (diffs <= 1e-5 * spread).mean() > 0.98
    assert diffs.max() <= bound


@pytest.mark.parametrize("int8", ["false", "true"])
def test_serve_matches_jax(runs, int8):
    _assert_same_rankings(runs[2], int8, "float32")


def test_serve_reads_bfloat16_items(runs):
    """The loader's default item dtype: ml_dtypes bfloat16 arrays reach the
    port as torch bfloat16 tensors, and the float32 model casts them up.
    int8 stays off here: bfloat16 inputs sit on round-ties of the first
    quantization, where XLA's CPU jit scale (amax * (1 / 127), see
    tests/test_torch_int8_mlp.py) flips them, and this test is about the
    items' path."""
    _assert_same_rankings(runs[2], "false", "bfloat16")


def test_serve_int8_flag_is_exact():
    assert serve.int8_flag([], False) is True
    assert serve.int8_flag(["--int8", "false"], False) is False
    assert serve.int8_flag(["--int8=false"], False) is False
    assert serve.int8_flag(["--int8_anything", "x"], False) is True


def test_serve_refuses_multi_gpu(runs, tmp_path):
    """In one process a mesh larger than the world raises, as the JAX
    make_mesh asserts; serving at dp and tp runs in
    tests/test_torch_serve_mesh.py."""
    jp, ckpt, _ = runs
    argv = _argv(ckpt, jp, str(tmp_path / "r.jsonl"), "false")
    argv[argv.index("--dp") + 1] = "2"
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        serve.main(argv, device="cpu")
