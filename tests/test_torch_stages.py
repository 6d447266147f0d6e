"""Stages 1 and 2 of the port and its ppo_eval against the JAX package's,
each through both CLIs on the same planted MovieNet data (tests/fixtures.py),
the same flags and the same starting JAX checkpoint, dropout off, float32:
per-step losses, evals and best scores, the final parameters (read from the
last `.state` of each), and the case dump of ppo_eval."""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_movienet
from lr2ppo_tpu.cli import pointwise as jpointwise
from lr2ppo_tpu.cli import ppo_eval as jppo_eval
from lr2ppo_tpu.cli import reward_pair_dataloader as jreward
from lr2ppo_tpu.config import ModelConfig as JModelConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_torch.cli import pointwise as tpointwise
from lr2ppo_torch.cli import ppo_eval as tppo_eval
from lr2ppo_torch.cli import reward_pair_dataloader as treward
from lr2ppo_torch.config import Config
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import ActorCritic, ScoreModel, SeqScoreModel
from lr2ppo_torch.train import checkpoints as tck
from lr2ppo_torch.train.checkpoints import load_any, params_from_flax

torch.set_num_threads(1)

D, HEADS, SEQ, IMGS, TAGS, BS = 32, 4, 8, 4, 4, 4
LR = 1e-3


def _jcfg(mode="reg"):
    return JModelConfig(feat_size=D, seq_length=SEQ, max_imgs=IMGS,
                        visual_feat_dim=D, num_heads=HEADS, mode=mode)


def _start(tmp_path, kind, mode="reg"):
    """The JAX package's seeded model as a pickle both load_any read."""
    rng = np.random.RandomState(0)
    text = jnp.asarray(rng.randn(2, TAGS, SEQ, D).astype(np.float32))
    img = jnp.asarray(rng.randn(2, IMGS, D).astype(np.float32))
    if kind == "score":
        params = JScore(_jcfg(mode)).init(jax.random.PRNGKey(1), text, img)
    else:
        params = JSeq(_jcfg()).init(jax.random.PRNGKey(2), text, img,
                                    jnp.zeros((2, 4), jnp.int32))
    path = str(tmp_path / f"start_{kind}.ckpt")
    jck.save_checkpoint(path, jax.tree.map(np.asarray, params))
    return path


def _argv(tmp_path, start, extra=()):
    data = make_movienet(str(tmp_path / "data"), n_items=6, seq=SEQ, feat=D,
                         seed=3)[0]
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({"model": {"drop_p": 0.0,
                                              "forward_drop_p": 0.0}}))
    return ["--train_path", data, "--dev_path", data, "--feat_size", str(D),
            "--seq_length", str(SEQ), "--num_heads", str(HEADS),
            "--max_imgs", str(IMGS), "--max_tags", str(TAGS),
            "--batch_size", str(BS), "--epochs_num", "2",
            "--report_steps", "1", "--save_state_steps", "1",
            "--learning_rate", str(LR), "--loader", "thread",
            "--num_workers", "1", "--dp", "1", "--item_dtype", "float32",
            "--config_path", str(cfg_path),
            "--pretrained_model_path", start, *extra]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_both(tmp_path, jmain, tmain, argv):
    """Both CLIs on `argv`; returns {name: (best, metric records, final
    params as a reference-keyed state_dict)}."""
    out = {}
    for name, main, kw in (("jax", jmain, {}),
                           ("torch", tmain, {"device": "cpu"})):
        log = str(tmp_path / f"{name}.log")
        model = str(tmp_path / f"{name}.bin")
        best = main(argv + ["--log_path", log, "--output_model_path", model],
                    **kw)
        if name == "jax":
            with open(model + ".state", "rb") as f:
                tree = pickle.load(f)["tree"]
            final = params_from_flax(tree["params"])
        else:
            final = tck.load_state(model + ".state")["models"]["model"]
        out[name] = (best, _records(log + ".jsonl"), final)
    return out


def _assert_params_close(ref: dict, got: dict, steps: int):
    """Adam without bias correction moves a parameter by about
    +-3.16 * lr * sign(g) in its first step whatever |g| is, so where a
    gradient is near 0 and its float32 rounding noise has another sign in
    the two frameworks the parameter can land ~6 * lr apart, and each
    later step can add as much (tests/test_torch_ppo.py); elsewhere they
    agree to float32 rounding. So every parameter lies within
    7 * lr * steps, and all but a small share within 1e-3 * lr."""
    assert set(ref) == set(got)
    far = total = 0
    for k, r in ref.items():
        d = np.abs(got[k].float().numpy() - r.float().numpy())
        assert float(d.max()) <= 7 * LR * steps, k
        far += int((d > 1e-3 * LR).sum())
        total += d.size
    assert far / total < 0.01, far / total


@pytest.mark.parametrize("mode", ["reg", "cls"])
def test_stage1_pointwise_tracks_the_jax_trainer(tmp_path, mode):
    """Stage 1 ('reg': SmoothL1 beta 0.3; 'cls': the 3-way NLL) from the
    same JAX checkpoint: 2 epochs of 2 steps, an eval after every step.
    Per-step losses agree to 1e-4 relative and the NDCG to 1e-3; the best
    `.bin` loads strict into a ScoreModel and into the JAX package's."""
    start = _start(tmp_path, "score", mode)
    argv = _argv(tmp_path, start, ["--mode", mode, "--labels_num", "3"])
    out = _run_both(tmp_path, jpointwise.main, tpointwise.main, argv)
    (jbest, jrecs, jfinal), (tbest, trecs, tfinal) = out["jax"], out["torch"]
    assert len(trecs) == len(jrecs) == 4
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tr["ndcg_full"], jr["ndcg_full"],
                                   rtol=1e-3)
    assert abs(tbest - jbest) < 1e-3
    _assert_params_close(jfinal, tfinal, steps=4)
    mcfg = dataclasses.replace(Config().model, feat_size=D, seq_length=SEQ,
                               max_imgs=IMGS, num_heads=HEADS, mode=mode)
    ScoreModel(mcfg).load_state_dict(load_any(str(tmp_path / "torch.bin")),
                                     strict=True)
    # the JAX package's stage 3 reads the port's stage-1 .bin as its actor
    jtree = jck.load_any(str(tmp_path / "torch.bin"))
    assert jax.tree.structure(jtree) == jax.tree.structure(
        jck.load_any(str(tmp_path / "jax.bin")))


def test_stage2_reward_tracks_the_jax_trainer(tmp_path):
    """Stage 2 from the same JAX checkpoint: 2 epochs of the 18 reward
    pairs at batch 4 (5 steps each, the last wrap-padded), an eval after
    every step. Per-step losses agree to 1e-4 relative; the pairwise
    accuracy and the best agree exactly (the eval pairs' scores are far
    apart compared with the frameworks' rounding); the best `.bin` loads
    strict into a SeqScoreModel and into the JAX package's."""
    start = _start(tmp_path, "seq")
    out = _run_both(tmp_path, jreward.main, treward.main,
                    _argv(tmp_path, start))
    (jbest, jrecs, jfinal), (tbest, trecs, tfinal) = out["jax"], out["torch"]
    assert len(trecs) == len(jrecs) == 10
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4,
                                   atol=1e-6)
        assert tr["acc"] == jr["acc"]
    assert tbest == jbest and 0.0 <= tbest <= 1.0
    _assert_params_close(jfinal, tfinal, steps=10)
    mcfg = dataclasses.replace(Config().model, feat_size=D, seq_length=SEQ,
                               max_imgs=IMGS, num_heads=HEADS)
    SeqScoreModel(mcfg).load_state_dict(
        load_any(str(tmp_path / "torch.bin")), strict=True)
    # the JAX package's stage 3 reads the port's stage-2 .bin
    jtree = jck.load_any(str(tmp_path / "torch.bin"))
    assert jax.tree.structure(jtree) == jax.tree.structure(
        jck.load_any(str(tmp_path / "jax.bin")))


def test_ppo_eval_writes_the_jax_cases(tmp_path):
    """Both ppo_eval CLIs read the same port-written ActorCritic `.bin` and
    write the same case dump: the same items, orders and golds, NDCG rows
    within 1e-5; the returned NDCG agrees."""
    mcfg = dataclasses.replace(Config().model, feat_size=D, seq_length=SEQ,
                               max_imgs=IMGS, num_heads=HEADS)
    ac = ActorCritic(mcfg)
    init_weights(ac, torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / "best.bin")
    tck.save_actor_critic(ckpt, ac.actor, ac.critic)
    data = make_movienet(str(tmp_path / "data"), n_items=7, seq=SEQ, feat=D,
                         max_tag_range=(3, 12), seed=5)[0]
    argv = ["--dev_path", data, "--feat_size", str(D), "--seq_length",
            str(SEQ), "--num_heads", str(HEADS), "--max_imgs", str(IMGS),
            "--batch_size", "2", "--dp", "1", "--item_dtype", "float32",
            "--pretrained_model_path", ckpt]
    cases, results = {}, {}
    for name, main, kw in (("jax", jppo_eval.main, {}),
                           ("torch", tppo_eval.main, {"device": "cpu"})):
        path = str(tmp_path / f"{name}_cases.json")
        results[name] = main(argv + ["--case_path", path], **kw)
        with open(path) as f:
            cases[name] = json.load(f)
    jc, tc = cases["jax"], cases["torch"]
    assert len(tc) == len(jc) == 7
    for j, t in zip(jc, tc):
        assert set(t) == set(j) == {"pred_order", "pred_scores", "gold",
                                    "gold_rearranged", "ndcg", "id", "tags",
                                    "tags_rearranged"}
        assert t["id"] == j["id"] and t["gold"] == j["gold"]
        assert t["tags"] == j["tags"]
        s = np.sort(np.asarray(j["pred_scores"]))
        if np.diff(s).min() > 1e-4:        # scores separated: same order
            assert t["pred_order"] == j["pred_order"]
            assert t["gold_rearranged"] == j["gold_rearranged"]
            assert t["tags_rearranged"] == j["tags_rearranged"]
        np.testing.assert_allclose(t["pred_scores"], j["pred_scores"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["ndcg"], j["ndcg"], atol=1e-5)
    for k, v in results["jax"].items():
        assert abs(results["torch"][k] - v) < 1e-5
