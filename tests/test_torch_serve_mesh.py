"""lr2ppo_torch.cli.serve on a mesh, on the CPU over gloo
(tests/test_torch_parallel.py:spawn): at dp 2 and tp 2 against the same
service in one process, on one store and checkpoint, with int8 on.

At feat 128 and 8 text tokens, 8 items x the 8-tag bucket are one batch of
512 text rows: at dp 2 a rank scores 256 of them, K1's least, so with the
int8 size gates zeroed both ranks take the fused FFN (text_proj and the XiT
FFN: 2 calls each); under tp the fused FFN never runs. dp 2 writes the
one-process file bit for bit (each rank scores its rows as one process
does); tp 2 sums the row-split products over tp in another order, so its
scores agree to TP_TOL of the spread and its orders and NDCG where the
scores stand further apart than that. Only rank 0 writes."""

import json

import numpy as np
import pytest
import torch

from fixtures import make_movienet
from test_torch_parallel import spawn

torch.set_num_threads(1)

FEAT, SEQ, IMGS, HEADS = 128, 8, 4, 4
# tp 2 against one process, int8: a float32 activation summed in another
# order can round to the other int8 step (tests/test_torch_serve.py's
# tie-flip bound)
TP_TOL = 0.02


def _argv(ckpt, jp, out):
    return ["--pretrained_model_path", ckpt, "--test_path", jp,
            "--ranking_path", out, "--family", "multimodal",
            "--feat_size", str(FEAT), "--seq_length", str(SEQ),
            "--num_heads", str(HEADS), "--max_imgs", str(IMGS),
            "--mode", "reg", "--compute_dtype", "float32",
            "--batch_size", "8", "--item_dtype", "float32", "--int8", "true"]


def _serve_rank(rank, world, url, argv, dp, tp):
    """One rank of the service (world 1: no process group), with the int8
    size gates zeroed; returns the result and the fused FFN's calls."""
    from lr2ppo_torch.cli import serve
    from lr2ppo_torch.models import layers as tlayers
    from lr2ppo_torch.ops import int8 as tint8

    tint8.INT8_MIN_KERNEL_ELEMENTS = 0
    tint8.INT8_DYNQUANT_MIN_FLOPS = 0
    tint8.INT8_DYNQUANT_MIN_WIDTH = 0
    fused, real = [], tlayers.int8_mlp
    tlayers.int8_mlp = lambda *a, **kw: fused.append(1) or real(*a, **kw)
    extra = ["--dp", str(dp), "--tp", str(tp)]
    if world > 1:
        extra += ["--distributed", "true", "--coordinator", url,
                  "--num_processes", str(world), "--process_id", str(rank)]
    res = serve.main(argv[:5] + [argv[5] + f".rank{rank}"] + argv[6:]
                     + extra, device="cpu")
    return res, len(fused)


def _lines(path):
    with open(path) as f:
        return {ln["id"]: ln for ln in map(json.loads, f)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from lr2ppo_torch.config import ModelConfig
    from lr2ppo_torch.models.scorer import ScoreModel
    from lr2ppo_torch.train.checkpoints import save_actor_critic

    tmp = tmp_path_factory.mktemp("serve_mesh")
    jp, _ = make_movienet(tmp / "d", n_items=8, seq=SEQ, feat=FEAT,
                          n_imgs_range=(1, 4), seed=2)
    cfg = ModelConfig(feat_size=FEAT, seq_length=SEQ, max_imgs=IMGS,
                      visual_feat_dim=FEAT, num_heads=HEADS)
    model = ScoreModel(cfg)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-0.2, 0.2, generator=gen)
    ckpt = str(tmp / "actor.bin")
    save_actor_critic(ckpt, model, model)
    out = {}
    for name, world, dp, tp in (("one", 1, 1, 1), ("dp2", 2, 2, 1),
                                ("tp2", 2, 1, 2)):
        d = tmp / name
        d.mkdir()
        path = str(d / "r.jsonl")
        ranks = spawn(_serve_rank, world, d, _argv(ckpt, jp, path), dp, tp,
                      join=world > 1, timeout=150)
        out[name] = (ranks, path)
    return out


def test_serve_at_dp2_writes_the_one_process_rankings(served):
    (one,), one_path = served["one"]
    ranks, path = served["dp2"]
    with open(one_path + ".rank0") as f, open(path + ".rank0") as g:
        assert g.read() == f.read()
    assert [r[0]["items"] for r in ranks] == [8, 8]
    # K1 on each rank's 256 rows: text_proj and the XiT FFN
    assert one[1] == 2 and [r[1] for r in ranks] == [2, 2]


def test_serve_at_tp2_matches_one_process(served):
    (one,), one_path = served["one"]
    ranks, path = served["tp2"]
    want, got = _lines(one_path + ".rank0"), _lines(path + ".rank0")
    assert set(got) == set(want) and len(got) == 8
    spread = max(np.abs(ln["pred_scores"]).max() for ln in want.values())
    bound = TP_TOL * spread
    for iid, ref in want.items():
        g = got[iid]
        assert g["tags"] == ref["tags"]
        by_tag = dict(zip(ref["pred_order"], ref["pred_scores"]))
        mine = dict(zip(g["pred_order"], g["pred_scores"]))
        assert max(abs(mine[t] - by_tag[t]) for t in by_tag) <= bound
        s = np.asarray(ref["pred_scores"])
        if np.all(np.diff(s) < -2 * bound):
            assert g["pred_order"] == ref["pred_order"]
            np.testing.assert_allclose(g["ndcg"], ref["ndcg"], rtol=1e-6)
    # no fused FFN under tp
    assert [r[1] for r in ranks] == [0, 0]


@pytest.mark.parametrize("name", ["dp2", "tp2"])
def test_only_rank0_writes_the_rankings(served, name):
    import os

    _ranks, path = served[name]
    assert os.path.exists(path + ".rank0")
    assert not os.path.exists(path + ".rank1")
