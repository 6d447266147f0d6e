"""Stages 1, 2 and 3 of the tabular (LETOR) recipe and its evaluator through
the port's CLIs against the JAX package's, on the same planted LETOR dirs
(tests/fixtures.py:make_planted_letor_dirs), the same flags and the same
starting JAX checkpoints, dropout off, float32: per-step losses, evals and
best scores, the final parameters, and the ppo_eval_trad case dump."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_planted_letor_dirs
from lr2ppo_tpu.cli import pointwise_trad as jpointwise
from lr2ppo_tpu.cli import ppo_eval_trad as jppo_eval
from lr2ppo_tpu.cli import ppo_trad as jppo
from lr2ppo_tpu.cli import reward_trad as jreward
from lr2ppo_tpu.config import ModelConfig as JModelConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_torch.cli import pointwise_trad as tpointwise
from lr2ppo_torch.cli import ppo_eval_trad as tppo_eval
from lr2ppo_torch.cli import ppo_trad as tppo
from lr2ppo_torch.cli import reward_trad as treward
from lr2ppo_torch.config import ModelConfig
from lr2ppo_torch.models.layers import init_weights
from lr2ppo_torch.models.scorer import ActorCritic, ScoreModel, SeqScoreModel
from lr2ppo_torch.train import checkpoints as tck
from lr2ppo_torch.train.checkpoints import load_any, params_from_flax
from test_torch_stages import _assert_params_close, _records

torch.set_num_threads(1)

D, HEADS = 32, 4
LR = 1e-3


def _mcfg():
    return dict(feat_size=D, num_heads=HEADS, family="tabular")


def _start(tmp_path, kind, seed):
    """The JAX package's seeded tabular model as a pickle both load_any
    read."""
    x = jnp.asarray(np.random.RandomState(0).randn(2, 4, D), jnp.float32)
    if kind == "score":
        params = JScore(JModelConfig(**_mcfg())).init(
            jax.random.PRNGKey(seed), x)
    else:
        params = JSeq(JModelConfig(**_mcfg())).init(
            jax.random.PRNGKey(seed), x, None, jnp.zeros((2, 4), jnp.int32))
    path = str(tmp_path / f"start_{kind}.ckpt")
    jck.save_checkpoint(path, jax.tree.map(np.asarray, params))
    return path


def _argv(tmp_path, extra=()):
    """16 training queries (8 noisy source, 8 target) and 4 test queries of
    20 documents, D wide; dropout off through a JSON config (there is no
    flag for the rates); 2 epochs."""
    merged = make_planted_letor_dirs(str(tmp_path / "data"), n_src=8,
                                     n_tgt=8, n_test=4, n_feat=D, seed=1)[1]
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({"model": {"drop_p": 0.0,
                                              "forward_drop_p": 0.0}}))
    return ["--train_path", merged, "--dev_path", merged, "--feat_size",
            str(D), "--num_heads", str(HEADS), "--epochs_num", "2",
            "--learning_rate", str(LR), "--critic_learning_rate", str(LR),
            "--loader", "thread", "--num_workers", "1", "--dp", "1",
            "--config_path", str(cfg_path), *extra]


def _run_both(tmp_path, jmain, tmain, argv, state_name="model"):
    """Both CLIs on `argv`; returns {name: (best, metric records, final
    params as reference-keyed state_dicts, or None without a .state)}."""
    out = {}
    for name, main, kw in (("jax", jmain, {}),
                           ("torch", tmain, {"device": "cpu"})):
        log = str(tmp_path / f"{name}.log")
        model = str(tmp_path / f"{name}.bin")
        best = main(argv + ["--log_path", log, "--output_model_path", model],
                    **kw)
        final = None
        if "--save_state_steps" in argv:
            if name == "jax":
                with open(model + ".state", "rb") as f:
                    final = params_from_flax(pickle.load(f)["tree"]["params"])
            else:
                final = tck.load_state(model + ".state")["models"][state_name]
        out[name] = (best, _records(log + ".jsonl"), final)
    return out


def test_stage1_pointwise_trad_tracks_the_jax_trainer(tmp_path):
    """Stage 1 ('reg', SmoothL1 beta 0.3) from the same JAX checkpoint: 2
    epochs of 4 steps of 4 queries, an eval on the test queries after every
    step. Per-step losses agree to 1e-4 relative and the NDCG to 1e-3; the
    final parameters as in the multimodal stages; the best `.bin` loads
    strict into the tabular ScoreModel and reads in the JAX package as the
    same tree."""
    argv = _argv(tmp_path, ["--batch_size", "4", "--report_steps", "1",
                            "--save_state_steps", "1",
                            "--pretrained_model_path",
                            _start(tmp_path, "score", 1)])
    out = _run_both(tmp_path, jpointwise.main, tpointwise.main, argv)
    (jbest, jrecs, jfinal), (tbest, trecs, tfinal) = out["jax"], out["torch"]
    assert len(trecs) == len(jrecs) == 8
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tr["ndcg_full"], jr["ndcg_full"],
                                   rtol=1e-3)
    assert abs(tbest - jbest) < 1e-3
    _assert_params_close(jfinal, tfinal, steps=8)
    ScoreModel(ModelConfig(**_mcfg())).load_state_dict(
        load_any(str(tmp_path / "torch.bin")), strict=True)
    assert jax.tree.structure(jck.load_any(str(tmp_path / "torch.bin"))) \
        == jax.tree.structure(jck.load_any(str(tmp_path / "jax.bin")))


def test_stage2_reward_trad_tracks_the_jax_trainer(tmp_path):
    """Stage 2 (margin 0.01, 5 classes) from the same JAX checkpoint: 2
    cross-class pairs a training query, 2 epochs at batch 8, an eval on
    the fixed 20 pairs a test query after every step. Per-step losses agree
    to 1e-4 relative, the pairwise accuracy and the best exactly; the best
    `.bin` loads strict into the tabular SeqScoreModel."""
    argv = _argv(tmp_path, ["--batch_size", "8", "--max_tags", "2",
                            "--report_steps", "1", "--save_state_steps", "1",
                            "--pretrained_model_path",
                            _start(tmp_path, "seq", 2)])
    out = _run_both(tmp_path, jreward.main, treward.main, argv)
    (jbest, jrecs, jfinal), (tbest, trecs, tfinal) = out["jax"], out["torch"]
    assert len(trecs) == len(jrecs) >= 6
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4,
                                   atol=1e-6)
        assert tr["acc"] == jr["acc"]
    assert tbest == jbest and 0.0 <= tbest <= 1.0
    _assert_params_close(jfinal, tfinal, steps=len(jrecs))
    SeqScoreModel(ModelConfig(**_mcfg())).load_state_dict(
        load_any(str(tmp_path / "torch.bin")), strict=True)


def test_stage3_ppo_trad_tracks_the_jax_trainer(tmp_path):
    """Stage 3 from the same JAX actor and stage-2 checkpoints: 2-document
    pairs, 2 a training query, batch 8, so 2 epochs of 2 sweeps of 2
    updates, an eval after each sweep. Per-sweep losses, rewards, values
    and NDCG agree to 1e-3 relative (as the multimodal fit in
    tests/test_torch_ppo.py, for the same first-step sign noise); the best
    `.bin` loads strict into the tabular ActorCritic."""
    argv = _argv(tmp_path, ["--batch_size", "8", "--max_tags", "2",
                            "--update_timesteps", "2",
                            "--pretrained_model_path",
                            _start(tmp_path, "score", 3),
                            "--reward_model_path",
                            _start(tmp_path, "seq", 4)])
    out = _run_both(tmp_path, jppo.main, tppo.main, argv)
    (jbest, jrecs, _), (tbest, trecs, _) = out["jax"], out["torch"]
    assert len(trecs) == len(jrecs) == 4
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        for k in ("policy_loss", "value_loss", "rewards", "value",
                  "ndcg_full"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)
    assert abs(tbest - jbest) < 1e-3
    ActorCritic(ModelConfig(**_mcfg())).load_state_dict(
        torch.load(str(tmp_path / "torch.bin")), strict=True)


def test_ppo_eval_trad_writes_the_jax_cases(tmp_path):
    """Both evaluators read the same port-written tabular ActorCritic `.bin`
    and write the same case dump: one case per test query, with its qid,
    the same orders and golds, scores within 1e-5; the NDCG agrees."""
    ac = ActorCritic(ModelConfig(**_mcfg()))
    init_weights(ac, torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / "best.bin")
    tck.save_actor_critic(ckpt, ac.actor, ac.critic)
    argv = _argv(tmp_path, ["--batch_size", "3",
                            "--pretrained_model_path", ckpt])
    cases, results = {}, {}
    for name, main, kw in (("jax", jppo_eval.main, {}),
                           ("torch", tppo_eval.main, {"device": "cpu"})):
        path = str(tmp_path / f"{name}_cases.json")
        results[name] = main(argv + ["--case_path", path], **kw)
        with open(path) as f:
            cases[name] = json.load(f)
    jc, tc = cases["jax"], cases["torch"]
    assert len(tc) == len(jc) == 4
    for j, t in zip(jc, tc):
        assert set(t) == set(j) == {"pred_order", "pred_scores", "gold",
                                    "gold_rearranged", "ndcg", "id"}
        assert t["id"] == j["id"] and t["gold"] == j["gold"]
        s = np.sort(np.asarray(j["pred_scores"]))
        if np.diff(s).min() > 1e-4:        # scores separated: same order
            assert t["pred_order"] == j["pred_order"]
            assert t["gold_rearranged"] == j["gold_rearranged"]
        np.testing.assert_allclose(t["pred_scores"], j["pred_scores"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["ndcg"], j["ndcg"], atol=1e-5)
    for k, v in results["jax"].items():
        assert abs(results["torch"][k] - v) < 1e-5


@pytest.mark.parametrize("name", ["pointwise_trad", "reward_trad",
                                  "ppo_trad", "ppo_eval_trad",
                                  "pointwise_2data_trad",
                                  "pointwise_2data_infer_trad"])
def test_tabular_clis_default_to_the_gpu(name):
    """Without a device argument each CLI asks for the GPU, and raises on a
    machine without one before it reads any data."""
    import importlib

    mod = importlib.import_module(f"lr2ppo_torch.cli.{name}")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--train_path", "/nonexistent", "--dev_path",
                  "/nonexistent", "--pretrained_model_path", "/nonexistent"])
