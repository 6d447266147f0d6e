"""Stages 1-3 and tower pretraining of the port on a mesh, on the CPU over
gloo (tests/test_torch_parallel.py:spawn), against the JAX package on one
device over the same global batches, and against the port in one process:

  * dp 2 of each stage's CLI on planted MovieNet data: against the JAX CLI
    with dropout off, at tests/test_torch_stages.py's and
    tests/test_torch_ppo.py's tolerances, and against the port at world 1
    with hash dropout on (the same masks), to a tighter bound;
  * one stage-3 rollout and update at dp 2 with hash dropout on the JAX
    package's seeds, against JAX on the whole batch;
  * tp 2 and dp 2 x tp 2 (4 processes) of the stage-3 trainer against
    world 1, as tests/test_tp_parity.py holds tp against dp;
  * tp 2 MLM pretraining, with the vocab-parallel log-softmax, against the
    JAX CLI.

The ranks import no JAX; the JAX sides run in the test's own process."""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from test_torch_parallel import spawn

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_special_ids():
    """The JAX pretrain CLI sets the processors' module-wide special ids
    (lr2ppo_tpu/cli/pretrain.py); restore them after each test."""
    from lr2ppo_tpu.data import pretrain_processors as pp

    old = (pp.CLS, pp.PAD, pp.SEP)
    yield
    pp.set_special_ids(*old)


D, HEADS, SEQ, IMGS, TAGS, BS = 32, 4, 8, 4, 4, 4
LR = 1e-3


def _cli_rank(rank, world, url, module, argv, dp, tp):
    """One rank of a port CLI under --distributed."""
    import importlib

    main = importlib.import_module(f"lr2ppo_torch.cli.{module}").main
    return main(argv + ["--dp", str(dp), "--tp", str(tp), "--distributed",
                        "true", "--coordinator", url, "--num_processes",
                        str(world), "--process_id", str(rank)],
                device="cpu")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _data_argv(tmp_path, dropout: bool):
    from fixtures import make_movienet

    data = make_movienet(str(tmp_path / "data"), n_items=6, seq=SEQ, feat=D,
                         seed=3)[0]
    model = ({"drop_p": 0.1, "forward_drop_p": 0.1, "hash_dropout": True}
             if dropout else {"drop_p": 0.0, "forward_drop_p": 0.0})
    cfg_path = tmp_path / f"model_{int(dropout)}.json"
    cfg_path.write_text(json.dumps({"model": model}))
    return ["--train_path", data, "--dev_path", data, "--feat_size", str(D),
            "--seq_length", str(SEQ), "--num_heads", str(HEADS),
            "--max_imgs", str(IMGS), "--max_tags", str(TAGS),
            "--epochs_num", "2", "--loader", "thread", "--num_workers", "1",
            "--item_dtype", "float32", "--config_path", str(cfg_path)]


def _start(tmp_path, kind):
    """The JAX package's seeded model as a pickle both packages read."""
    import jax
    import jax.numpy as jnp
    from lr2ppo_tpu.config import ModelConfig as JModelConfig
    from lr2ppo_tpu.models.scorer import ScoreModel as JScore
    from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
    from lr2ppo_tpu.train import checkpoints as jck

    mc = JModelConfig(feat_size=D, seq_length=SEQ, max_imgs=IMGS,
                      visual_feat_dim=D, num_heads=HEADS,
                      mode="cls" if kind == "score_cls" else "reg")
    rng = np.random.RandomState(0)
    text = jnp.asarray(rng.randn(2, TAGS, SEQ, D).astype(np.float32))
    img = jnp.asarray(rng.randn(2, IMGS, D).astype(np.float32))
    if kind.startswith("score"):
        params = JScore(mc).init(jax.random.PRNGKey(1), text, img)
    else:
        params = JSeq(mc).init(jax.random.PRNGKey(2), text, img,
                               jnp.zeros((2, 4), jnp.int32))
    path = str(tmp_path / f"start_{kind}.ckpt")
    jck.save_checkpoint(path, jax.tree.map(np.asarray, params))
    return path


def _final(path, jax_side):
    """A run's final parameters from its last `.state`."""
    from lr2ppo_torch.train import checkpoints as tck

    if jax_side:
        with open(path + ".state", "rb") as f:
            tree = pickle.load(f)["tree"]
        return tck.params_from_flax(tree["params"])
    return tck.load_state(path + ".state")["models"]["model"]


def _params_close(ref, got, steps, far_share, near):
    """Adam without bias correction moves a parameter by about
    +-3.16 * lr * sign(g) whatever |g| is, so where a gradient is near 0 its
    float32 rounding noise can flip the step (tests/test_torch_stages.py):
    every parameter lies within 7 * lr * steps, and all but `far_share`
    within `near`."""
    assert set(ref) == set(got)
    far = total = 0
    for k, r in ref.items():
        d = np.abs(got[k].float().numpy() - r.float().numpy())
        assert float(d.max()) <= 7 * LR * steps, k
        far += int((d > near).sum())
        total += d.size
    assert far / total <= far_share, far / total


STAGES = {
    # stage: (JAX CLI, port CLI module, start kind, extra flags, steps)
    "pointwise": ("lr2ppo_tpu.cli.pointwise", "pointwise", "score_cls",
                  ["--mode", "cls", "--labels_num", "3"], 4),
    "reward": ("lr2ppo_tpu.cli.reward_pair_dataloader",
               "reward_pair_dataloader", "seq", [], 10),
}


def _stage_argv(tmp_path, stage, dropout):
    _jmod, _tmod, kind, extra, _ = STAGES[stage]
    return _data_argv(tmp_path, dropout) + [
        "--batch_size", str(BS), "--report_steps", "1",
        "--save_state_steps", "1", "--learning_rate", str(LR),
        "--pretrained_model_path", _start(tmp_path, kind), *extra]


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_dp2_stage_tracks_the_jax_trainer(tmp_path, stage):
    """Dropout off, the JAX CLI on one device against the port's at dp 2
    over the same global batches of 4: per-step losses to 1e-4 relative,
    the evals and the best as tests/test_torch_stages.py holds world 1."""
    import importlib

    jmod, tmod, _kind, _extra, steps = STAGES[stage]
    argv = _stage_argv(tmp_path, stage, dropout=False)
    jout, tout = str(tmp_path / "jax.bin"), str(tmp_path / "dp2.bin")
    jbest = importlib.import_module(jmod).main(
        argv + ["--dp", "1", "--log_path", jout + ".log",
                "--output_model_path", jout])
    ranks = spawn(_cli_rank, 2, tmp_path, tmod,
                  argv + ["--log_path", tout + ".log",
                          "--output_model_path", tout], 2, 1, join=False)
    assert ranks[0] == ranks[1]
    jrecs, trecs = _records(jout + ".log.jsonl"), _records(
        tout + ".log.jsonl")
    assert len(trecs) == len(jrecs) == steps
    metric = "ndcg_full" if stage == "pointwise" else "acc"
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tr[metric], jr[metric], rtol=1e-3)
    assert abs(ranks[0] - jbest) < 1e-3
    _params_close(_final(jout, True), _final(tout, False), steps,
                  far_share=0.01, near=1e-3 * LR)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_dp2_stage_tracks_world_1_with_hash_dropout(tmp_path, stage):
    """Hash dropout on: every rank draws the seeds world 1 draws and hashes
    its rows' global positions, so dp 2 applies world 1's masks. Per-step
    losses agree to 1e-5 relative (float32 sums over other splits), and
    the parameters within the Adam sign-noise bound, all but 0.2% within
    1e-4 * lr."""
    from lr2ppo_torch.cli import pointwise, reward_pair_dataloader

    main = {"pointwise": pointwise.main,
            "reward": reward_pair_dataloader.main}[stage]
    _jmod, tmod, _kind, _extra, steps = STAGES[stage]
    argv = _stage_argv(tmp_path, stage, dropout=True)
    wout, tout = str(tmp_path / "w1.bin"), str(tmp_path / "dp2.bin")
    wbest = main(argv + ["--dp", "1", "--log_path", wout + ".log",
                         "--output_model_path", wout], device="cpu")
    ranks = spawn(_cli_rank, 2, tmp_path, tmod,
                  argv + ["--log_path", tout + ".log",
                          "--output_model_path", tout], 2, 1, join=False)
    wrecs, trecs = _records(wout + ".log.jsonl"), _records(
        tout + ".log.jsonl")
    assert len(trecs) == len(wrecs) == steps
    for wr, tr in zip(wrecs, trecs):
        np.testing.assert_allclose(tr["loss"], wr["loss"], rtol=1e-5,
                                   atol=1e-7)
    assert abs(ranks[0] - wbest) < 1e-5
    _params_close(_final(wout, False), _final(tout, False), steps,
                  far_share=0.002, near=1e-4 * LR)


def _ppo_argv(tmp_path, dropout):
    """tests/test_torch_ppo.py's tiny fit: 2 epochs of 3 rollouts of 4 items
    of 2 tags, so 3 sweeps of 2 updates."""
    argv = _data_argv(tmp_path, dropout)
    argv[argv.index("--max_tags") + 1] = "2"
    return argv + [
        "--batch_size", "4", "--update_timesteps", "2", "--learning_rate",
        str(LR), "--critic_learning_rate", str(LR),
        "--pretrained_model_path", _start(tmp_path, "score"),
        "--reward_model_path", _start(tmp_path, "seq")]


def test_dp2_stage3_fit_tracks_the_jax_trainer_and_world_1(tmp_path):
    """The stage-3 CLI at dp 2 (3 sweeps of 2 updates, an eval after each):
    dropout off against the JAX CLI to tests/test_torch_ppo.py's 1e-3; hash
    dropout on against the port at world 1 to 1e-5."""
    from lr2ppo_tpu.cli import ppo as jcli
    from lr2ppo_torch.cli import ppo as tcli

    keys = ("policy_loss", "value_loss", "rewards", "value", "ndcg_full")
    for dropout in (False, True):
        argv = _ppo_argv(tmp_path, dropout)
        ref = str(tmp_path / f"ref{int(dropout)}.bin")
        out = str(tmp_path / f"dp2_{int(dropout)}.bin")
        flags = argv + ["--dp", "1", "--log_path", ref + ".log",
                        "--output_model_path", ref]
        rbest = (tcli.main(flags, device="cpu") if dropout
                 else jcli.main(flags))
        ranks = spawn(_cli_rank, 2, tmp_path, "ppo",
                      argv + ["--log_path", out + ".log",
                              "--output_model_path", out], 2, 1,
                      join=False)
        rrecs, trecs = _records(ref + ".log.jsonl"), _records(
            out + ".log.jsonl")
        assert len(trecs) == len(rrecs) == 3
        tol = 1e-5 if dropout else 1e-3
        for rr, tr in zip(rrecs, trecs):
            for k in keys:
                np.testing.assert_allclose(tr[k], rr[k], rtol=tol,
                                           atol=tol * 1e-2, err_msg=k)
        assert abs(ranks[0] - rbest) < tol


# -- one stage-3 step at dp 2 against JAX, hash dropout on JAX's seeds ---------
B, T, SEQ3, D3 = 4, 2, 8, 16


def _ppo_step_rank(rank, world, url, sds, batch, seeds):
    from lr2ppo_torch.config import Config
    from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
    from lr2ppo_torch.ops import hash_dropout as thd
    from lr2ppo_torch.parallel import make_mesh, set_active
    from lr2ppo_torch.train import ppo as tppo
    from lr2ppo_torch.train.common import DeviceCtx, init_state

    seeds = list(seeds)
    thd.draw_seed = lambda gen: int(seeds.pop(0))
    cfg = _step_cfg(Config())
    mesh = make_mesh(2, 1)
    set_active(mesh)
    ctx = DeviceCtx("cpu", mesh=mesh)
    tm = cfg.model
    actor, critic = ScoreModel(tm), SeqScoreModel(tm)
    actor.load_state_dict(sds[0])
    critic.load_state_dict(sds[1])
    ctx.place(actor)
    ctx.place(critic)
    reward = tppo.frozen_copy(SeqScoreModel, tm, sds[2], torch.float32,
                              False, ctx)
    rows = slice(rank * B // 2, (rank + 1) * B // 2)
    text, img, state = (torch.from_numpy(a[rows]) for a in batch)
    out = tppo.make_rollout_step(tm.mode)(actor, critic, reward, text, img,
                                          state)
    sched = dict(schedule_wrap=lambda s: (lambda t: s(t // 1)))
    astate = init_state(actor, ctx.optimizer(cfg.optim, actor, 10, lr=LR,
                                             **sched))
    cstate = init_state(critic, ctx.optimizer(cfg.optim, critic, 10, lr=LR,
                                              **sched))
    metrics = tppo.make_update_step(cfg)(
        astate, cstate, torch.Generator().manual_seed(0), text, img, state,
        out[2], out[0], out[3], out[1])
    assert seeds == []
    return {"metrics": {k: float(ctx.mean(v)) for k, v in metrics.items()},
            "actor": ctx.full_state_dict(actor),
            "critic": ctx.full_state_dict(critic),
            "rollout": [v.float() for v in out]}


def _step_cfg(c):
    m = dataclasses.replace(c.model, feat_size=D3, seq_length=SEQ3,
                            max_imgs=IMGS, visual_feat_dim=D3, num_heads=2,
                            hash_dropout=True, drop_p=0.1,
                            forward_drop_p=0.1)
    p = dataclasses.replace(c.ppo, update_timesteps=1)
    o = dataclasses.replace(c.optim, learning_rate=LR,
                            critic_learning_rate=LR)
    return c.replace(model=m, ppo=p, optim=o)


def test_dp2_update_with_hash_dropout_matches_jax(tmp_path):
    """One rollout and one update, each rank on half of the batch with the
    9 dropout seeds JAX draws: the update's metrics and parameters match
    JAX's whole-batch step (tests/test_torch_ppo.py's bounds). The rank
    loss divides by the violating pairs of the whole batch."""
    import jax
    import jax.numpy as jnp
    from lr2ppo_tpu.config import Config as JConfig
    from lr2ppo_tpu.models.scorer import ScoreModel as JScore
    from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
    from lr2ppo_tpu.ops import pallas_dropout as jpd
    from lr2ppo_tpu.train import ppo as jppo
    from lr2ppo_tpu.train.common import init_state as jinit_state
    from lr2ppo_tpu.train.optim import build_optimizer as jbuild
    from lr2ppo_torch.train.checkpoints import params_from_flax

    jcfg = _step_cfg(JConfig())
    rng = np.random.RandomState(0)
    text = rng.randn(B, T, SEQ3, D3).astype(np.float32)
    img = rng.randn(B, IMGS, D3).astype(np.float32)
    state = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jt, ji, js = map(jnp.asarray, (text, img, state))
    mc = jcfg.model
    ka, kc, kr = jax.random.split(jax.random.PRNGKey(1), 3)
    idx4 = jnp.zeros((B, 4), jnp.int32)
    ap, cp, rp = (JScore(mc).init(ka, jt, ji), JSeq(mc).init(kc, jt, ji, idx4),
                  JSeq(mc).init(kr, jt, ji, idx4))
    sds = [params_from_flax(jax.tree.map(np.array, t)) for t in (ap, cp, rp)]
    seeds = [int(s) for s in np.random.RandomState(4).randint(
        -2**31, 2**31 - 1, size=9)]
    jseeds = list(seeds)
    real = jpd.seed_from_key
    jpd.seed_from_key = lambda key: jnp.int32(jseeds.pop(0))
    try:
        jout = jppo.make_rollout_step(JScore(mc), JSeq(mc), JSeq(mc),
                                      mc.mode)(ap, cp, rp, jt, ji, js)
        sched = dict(schedule_wrap=lambda s: (lambda t: s(t // 1)))
        atx = jbuild(jcfg.optim, 10, lr=LR, **sched)
        ctx_ = jbuild(jcfg.optim, 10, lr=LR, **sched)
        ja, jc, jm = jppo.make_update_step(JScore(mc), JSeq(mc), atx, ctx_,
                                           jcfg)(
            jinit_state(ap, atx), jinit_state(cp, ctx_),
            jax.random.PRNGKey(2), jt, ji, js, jout[2], jout[0], jout[3],
            jout[1])
    finally:
        jpd.seed_from_key = real
    assert jseeds == []
    ranks = spawn(_ppo_step_rank, 2, tmp_path, sds, (text, img, state),
                  seeds)
    for r in ranks:
        for k, v in jm.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    got = torch.cat([r["rollout"][0] for r in ranks]).numpy()
    np.testing.assert_allclose(got, np.asarray(jout[0]), rtol=1e-5,
                               atol=1e-6)
    far = total = 0
    for side, jstate in (("actor", ja), ("critic", jc)):
        want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
        for r in ranks:
            assert set(r[side]) == set(want)
            for k, w in want.items():
                d = np.abs(r[side][k].numpy() - w.numpy())
                assert float(d.max()) <= 7 * LR, (side, k)
                far += int((d > 1e-3 * LR).sum())
                total += d.size
    assert far / total < 1e-3, far / total


# -- tp 2 and dp 2 x tp 2 of the stage-3 trainer ------------------------------
def _ppo_fit(dp=1, tp=1):
    from test_torch_parallel import _DS, BS as PBS, TAGS as PTAGS, _pw_cfg
    from lr2ppo_torch.data import EvalLoader, Loader
    from lr2ppo_torch.train.ppo import PPOTrainer

    cfg = _pw_cfg(dp=dp, tp=tp)
    cfg.ppo.update_timesteps = 2
    cfg.data.max_tags = PTAGS
    tr = PPOTrainer(cfg, device="cpu")
    m = tr.ctx.mesh

    def make_train_loader(epoch):
        return Loader(_DS(), PBS, shuffle=True, seed=epoch, num_workers=1,
                      shard=(m.dp_rank, m.dp) if m.dp > 1 else None)

    ev = EvalLoader(_DS(), buckets=[PTAGS], batch_size=PBS)
    astate, cstate, best = tr.fit(make_train_loader, ev)
    return {"actor": tr.ctx.full_state_dict(astate.model),
            "critic": tr.ctx.full_state_dict(cstate.model), "best": best,
            "local": {k: tuple(p.shape) for k, p in
                      tr.ctx.named_parameters(astate.model).items()}}


def _ppo_fit_rank(rank, world, url, dp, tp):
    return _ppo_fit(dp, tp)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)], ids=["tp2", "dp2xtp2"])
def test_tp_stage3_matches_world_1(tmp_path, dp, tp):
    """The stage-3 trainer (hash dropout on, 2 sweeps of 2 updates) with
    the fusion MLPs and the XiT projections split over tp: every rank of a
    tp group holds the same replicated parameters, out_layer.fc1 holds
    half of its rows, and the full parameters match world 1 to float32
    reduction-order noise (tests/test_tp_parity.py's 2e-4 / 2e-5)."""
    world1 = _ppo_fit()
    ranks = spawn(_ppo_fit_rank, dp * tp, tmp_path, dp, tp, timeout=180)
    for r in ranks:
        assert r["local"]["out_layer.fc1.weight"][0] * tp == \
            world1["local"]["out_layer.fc1.weight"][0]
        assert abs(r["best"] - world1["best"]) < 1e-4
        for side in ("actor", "critic"):
            for k, w in world1[side].items():
                np.testing.assert_allclose(r[side][k].numpy(), w.numpy(),
                                           rtol=2e-4, atol=2e-5,
                                           err_msg=f"{side}.{k}")
    for k, v in ranks[0]["actor"].items():
        assert torch.equal(v, ranks[-1]["actor"][k]), k


# -- tp 2 MLM pretraining against the JAX CLI ---------------------------------
def _pretrain_rank(rank, world, url, argv):
    from lr2ppo_torch.cli import pretrain

    return pretrain.main(argv + ["--tp", "2", "--dp", "1", "--distributed",
                                 "--coordinator", url, "--num_processes",
                                 "2", "--process_id", str(rank)],
                         device="cpu")


def test_tp2_mlm_pretraining_matches_the_jax_cli(tmp_path):
    """tests/test_torch_pretrain.py's run (2 layers of 16, 4 heads, 6 steps
    of 2 accumulated micro-batches) at tp 2: attention heads, FFN and the
    MLM vocabulary head split, the log-softmax vocab-parallel. Per-step
    losses and accuracies and the final weights match the JAX CLI on one
    device to 1e-4."""
    from lr2ppo_tpu.cli import pretrain as jcli
    from test_torch_pretrain import STEPS, TOL, TOWER, _argv
    from test_torch_pretrain import _records as precords
    from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                     load_tower_checkpoint)
    from lr2ppo_torch.towers.model import init_weights
    from lr2ppo_torch.train.checkpoints import save_model

    # tests/test_torch_pretrain.py's files with a 14-entry vocabulary, which
    # splits in two
    tokens = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + list("abcdefghi")
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in tokens))
    rng = np.random.RandomState(0)
    (tmp_path / "c.txt").write_text("".join(
        " ".join(rng.choice(list("abcdefghi"), 8)) + "\n"
        for _ in range(50)))
    (tmp_path / "tower.json").write_text(json.dumps(TOWER))
    files = {k: str(tmp_path / f) for k, f in
             (("vocab", "v.txt"), ("corpus", "c.txt"),
              ("tower", "tower.json"))}
    init = str(tmp_path / "init.bin")
    model = TowerModel(TowerConfig.from_json(files["tower"],
                                             vocab_size=len(tokens)),
                       with_target=True)
    init_weights(model, torch.Generator().manual_seed(3))
    save_model(init, model)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "tp2")
    jcli.main(_argv(files, jout, "--pretrained_model_path", init,
                    "--dp", "1"))
    spawn(_pretrain_rank, 2, tmp_path,
          _argv(files, tout, "--pretrained_model_path", init), join=False)
    jrec, trec = precords(jout), precords(tout)
    assert [r["step"] for r in trec] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in trec],
                               [r["loss"] for r in jrec], rtol=TOL)
    np.testing.assert_allclose([r["acc"] for r in trec],
                               [r["acc"] for r in jrec], atol=TOL)
    want, got = load_tower_checkpoint(jout), load_tower_checkpoint(tout)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=TOL * float(w.abs().max()),
                                   err_msg=k)
