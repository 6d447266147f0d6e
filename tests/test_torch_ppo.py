"""The port's stage-3 trainer against the JAX package's (train/ppo.py): one
rollout and one update from the same weights and batch, with dropout off,
with hash dropout on shared seeds, and with the int8 rollout twin; then a
tiny fit through both CLIs on the same planted MovieNet data and the same
starting checkpoints, whose per-sweep losses must track."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_movienet
from lr2ppo_tpu.cli import ppo as jcli
from lr2ppo_tpu.config import Config as JConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.ops import pallas_dropout as jpd
from lr2ppo_tpu.ops.int8 import quantize_tree
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_tpu.train import ppo as jppo
from lr2ppo_tpu.train.common import init_state as jinit_state
from lr2ppo_tpu.train.optim import build_optimizer as jbuild
from lr2ppo_torch.cli import ppo as tcli
from lr2ppo_torch.config import Config
from lr2ppo_torch.models.scorer import ActorCritic, ScoreModel, SeqScoreModel
from lr2ppo_torch.ops import hash_dropout as thd
from lr2ppo_torch.ops import int8 as tint8
from lr2ppo_torch.ops import int8_mlp as tmlp
from lr2ppo_torch.train import ppo as tppo
from lr2ppo_torch.train.checkpoints import load_any, params_from_flax
from lr2ppo_torch.train.common import init_state
from lr2ppo_torch.train.optim import build_optimizer

torch.set_num_threads(1)

# feat 128 (the fused int8 FFN takes multiples of 128), 4 items x 2 tags x
# 32 text tokens = 256 text rows (its row gate), 4 image tokens
D, HEADS, SEQ, IMGS, B, T = 128, 4, 32, 4, 4, 2
LR = 1e-3


def _mcfg(**kw):
    return dict(feat_size=D, seq_length=SEQ, max_imgs=IMGS,
                visual_feat_dim=D, num_heads=HEADS, **kw)


def _configs(model_kw, ppo_kw=None):
    jc, tc = JConfig(), Config()
    out = []
    for c in (jc, tc):
        m = dataclasses.replace(c.model, **_mcfg(**model_kw))
        p = dataclasses.replace(c.ppo, update_timesteps=1, **(ppo_kw or {}))
        o = dataclasses.replace(c.optim, learning_rate=LR,
                                critic_learning_rate=LR)
        out.append(c.replace(model=m, ppo=p, optim=o))
    return out


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randn(B, T, SEQ, D).astype(np.float32)
    img = rng.randn(B, IMGS, D).astype(np.float32)
    state = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return text, img, state


def _flax_params(jcfg):
    text, img, state = map(jnp.asarray, _batch())
    idx4 = jnp.zeros((B, 4), jnp.int32)
    ka, kc, kr = jax.random.split(jax.random.PRNGKey(1), 3)
    mc = jcfg.model
    return (JScore(mc).init(ka, text, img),
            JSeq(mc).init(kc, text, img, idx4),
            JSeq(mc).init(kr, text, img, idx4))


def _np(t):
    return t.detach().float().cpu().numpy()


def _run_both(jcfg, tcfg):
    """One rollout and one update in each package from the same weights
    and batch; returns the JAX and port results side by side."""
    ap, cp, rp = _flax_params(jcfg)
    # host copies first: the JAX update donates its train states
    a_sd, c_sd, r_sd = (params_from_flax(jax.tree.map(np.array, t))
                        for t in (ap, cp, rp))
    text, img, state = _batch()
    jm = jcfg.model
    ri8 = tppo.rollout_int8_mode(jcfg.ppo.rollout_int8)
    int8_m = dataclasses.replace(jm, int8=True)
    j_ra = JScore(int8_m) if ri8 != "0" else JScore(jm)
    j_rw = JSeq(int8_m) if jcfg.ppo.reward_int8 else JSeq(jm)
    q = jax.tree.map(jnp.asarray, quantize_tree(ap, jnp.float32)) \
        if ri8 != "0" else ap
    rw = quantize_tree(rp, jnp.float32) if jcfg.ppo.reward_int8 else rp
    jroll = jppo.make_rollout_step(j_ra, JSeq(jm), j_rw, jm.mode)
    jout = jroll(q, cp, rw, jnp.asarray(text), jnp.asarray(img),
                 jnp.asarray(state))
    sched = dict(schedule_wrap=lambda s: (lambda t: s(t // 1)))
    atx = jbuild(jcfg.optim, 10, lr=LR, **sched)
    ctx = jbuild(jcfg.optim, 10, lr=LR, **sched)
    jupd = jppo.make_update_step(JScore(jm), JSeq(jm), atx, ctx, jcfg)
    jastate, jcstate, jmetrics = jupd(
        jinit_state(ap, atx), jinit_state(cp, ctx), jax.random.PRNGKey(2),
        jnp.asarray(text), jnp.asarray(img), jnp.asarray(state), *jout[2:3],
        jout[0], jout[3], jout[1])

    tm = tcfg.model
    actor, critic = ScoreModel(tm), SeqScoreModel(tm)
    actor.load_state_dict(a_sd)
    critic.load_state_dict(c_sd)
    reward = tppo.frozen_copy(SeqScoreModel, tm, r_sd, torch.float32,
                              tcfg.ppo.reward_int8)
    r_actor = (tppo.frozen_copy(ScoreModel, tm, actor.state_dict(),
                                torch.float32, True) if ri8 != "0" else actor)
    tt, ti, ts = map(torch.from_numpy, (text, img, state))
    tout = tppo.make_rollout_step(tm.mode)(r_actor, critic, reward, tt, ti,
                                           ts)
    mk = lambda m: build_optimizer(tcfg.optim, dict(m.named_parameters()),
                                   10, lr=LR, **sched)
    astate, cstate = init_state(actor, mk(actor)), init_state(critic,
                                                             mk(critic))
    tmetrics = tppo.make_update_step(tcfg)(
        astate, cstate, torch.Generator().manual_seed(0), tt, ti, ts,
        tout[2], tout[0], tout[3], tout[1])
    return {"rollout": ([np.asarray(v) for v in jout],
                        [_np(v) for v in tout]),
            "metrics": ({k: float(v) for k, v in jmetrics.items()},
                        {k: float(v) for k, v in tmetrics.items()}),
            "actor": (params_from_flax(jax.tree.map(np.asarray,
                                                    jastate.params)),
                      actor.state_dict()),
            "critic": (params_from_flax(jax.tree.map(np.asarray,
                                                     jcstate.params)),
                       critic.state_dict())}


def _assert_rollout_close(res, rtol=1e-5):
    (jscores, jvalue, jnext, jrew), (tscores, tvalue, tnext, trew) = \
        res["rollout"]
    np.testing.assert_array_equal(tnext, jnext)
    for got, ref in ((tscores, jscores), (tvalue, jvalue), (trew, jrew)):
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=rtol * float(np.abs(ref).max()))


def _assert_update_close(res):
    """Metrics within 1e-4 relative. Parameters: Adam's first step without
    bias correction is about +-3.16 * lr * sign(g) whatever |g| is, so where
    a gradient is near 0 and its float32 rounding noise has another sign in
    the two frameworks the parameters differ by up to ~7 * lr; elsewhere
    they agree to float32 rounding. So every parameter lies within 7 * lr,
    and all but a small share within 1e-3 * lr."""
    jm, tm = res["metrics"]
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    far = total = 0
    for side in ("actor", "critic"):
        ref, got = res[side]
        assert set(ref) == set(got)
        for k, r in ref.items():
            d = np.abs(got[k].numpy() - r.numpy())
            assert float(d.max()) <= 7 * LR, (side, k)
            far += int((d > 1e-3 * LR).sum())
            total += d.size
    assert far / total < 1e-3, far / total


def test_rollout_and_update_match_without_dropout():
    jcfg, tcfg = _configs(dict(drop_p=0.0, forward_drop_p=0.0))
    res = _run_both(jcfg, tcfg)
    _assert_rollout_close(res)
    _assert_update_close(res)


def test_rollout_and_update_match_with_hash_dropout(monkeypatch):
    """The 9 dropout sites of an update (3 actor, 6 critic) take the same
    seeds in call order in both packages."""
    seeds = np.random.RandomState(4).randint(-2**31, 2**31 - 1, size=9)
    jseeds, tseeds = list(seeds), list(seeds)
    monkeypatch.setattr(jpd, "seed_from_key",
                        lambda key: jnp.int32(jseeds.pop(0)))
    monkeypatch.setattr(thd, "draw_seed", lambda gen: int(tseeds.pop(0)))
    jcfg, tcfg = _configs(dict(hash_dropout=True, drop_p=0.1,
                               forward_drop_p=0.1))
    res = _run_both(jcfg, tcfg)
    assert jseeds == tseeds == []
    _assert_rollout_close(res)
    _assert_update_close(res)


@pytest.fixture
def force_int8(monkeypatch):
    """Zero the int8 size gates in both packages (as tests/test_int8.py
    does) and turn JAX's fused FFN on, which its 8 fake CPU devices would
    turn off, so these small models take the int8 routes."""
    for mod in (jint8, tint8):
        monkeypatch.setattr(mod, "INT8_MIN_KERNEL_ELEMENTS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_FLOPS", 0)
        monkeypatch.setattr(mod, "INT8_DYNQUANT_MIN_WIDTH", 0)
    monkeypatch.setattr(jint8, "PALLAS_FUSED_FFN", True)
    monkeypatch.setattr(tint8, "FUSED_FFN", True)


def test_rollout_with_the_int8_actor_twin_and_reward(force_int8,
                                                    monkeypatch):
    """--profile fast's rollout: int8 actor twin and int8 reward model,
    their text_proj and XiT FFN through the fused int8 FFN (4 launches of
    K1's plain version here). Scores within tests/test_int8.py's tie-flip
    tolerance; the update trains the float models and matches as above."""
    before = tmlp.int8_mlp.launches
    jcfg, tcfg = _configs(dict(drop_p=0.0, forward_drop_p=0.0),
                          dict(rollout_int8="actor", reward_int8=True))
    calls = []
    real = tmlp.int8_mlp_reference
    monkeypatch.setattr(tmlp, "int8_mlp_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res = _run_both(jcfg, tcfg)
    assert len(calls) == 4 and tmlp.int8_mlp.launches == before
    (jscores, jvalue, jnext, jrew), (tscores, tvalue, tnext, trew) = \
        res["rollout"]
    np.testing.assert_array_equal(tnext, jnext)
    np.testing.assert_allclose(tvalue, jvalue, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jvalue).max()))
    for got, ref in ((tscores, jscores), (trew, jrew)):
        spread = float(np.abs(ref).max()) + 1e-6
        assert float(np.abs(got - ref).max()) < 0.02 * spread
    _assert_update_close(res)


def _write_start(tmp_path, jcfg):
    """The JAX package's seeded actor and stage-2 model as pickles, which
    both packages' load_any read."""
    ap, cp, _ = _flax_params(jcfg)
    actor, reward = str(tmp_path / "actor.ckpt"), str(tmp_path / "rw.ckpt")
    jck.save_checkpoint(actor, jax.tree.map(np.asarray, ap))
    jck.save_checkpoint(reward, jax.tree.map(np.asarray, cp))
    return actor, reward


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _fit_argv(tmp_path):
    """Flags of a tiny fit on planted MovieNet data from the JAX package's
    seeded checkpoints, dropout off (through a JSON config: there is no
    flag for the rates), float32: 2 epochs of 3 rollouts, so 3 sweeps of
    2 updates, an eval after each."""
    data = make_movienet(str(tmp_path / "data"), n_items=6, seq=SEQ, feat=D,
                         seed=2)[0]
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({"model": {"drop_p": 0.0,
                                              "forward_drop_p": 0.0}}))
    jcfg, _ = _configs({})
    actor, reward = _write_start(tmp_path, jcfg)
    return ["--train_path", data, "--dev_path", data, "--feat_size", str(D),
            "--seq_length", str(SEQ), "--num_heads", str(HEADS),
            "--max_imgs", str(IMGS), "--batch_size", "4", "--max_tags", "2",
            "--update_timesteps", "2", "--epochs_num", "2",
            "--learning_rate", "1e-3", "--critic_learning_rate", "1e-3",
            "--loader", "thread", "--num_workers", "1", "--dp", "1",
            "--item_dtype", "float32", "--config_path", str(cfg_path),
            "--pretrained_model_path", actor, "--reward_model_path", reward]


@pytest.mark.parametrize("variant", [[], ["--use_gae", "true",
                                          "--surrogate_clip", "true"]],
                         ids=["faithful", "gae_surrogate"])
def test_tiny_fit_tracks_the_jax_trainer(tmp_path, variant):
    """Both CLIs on the same data, flags and starting checkpoints, with the
    reference's one-step advantage and with GAE plus the clipped
    surrogate. Per-sweep losses and NDCG agree to 1e-3 relative (the
    first-step sign noise above moves near-zero-gradient parameters by ~lr
    each step); the port's best checkpoint loads into ActorCritic with
    strict=True."""
    common = _fit_argv(tmp_path) + variant
    out = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("torch", tcli.main, {"device": "cpu"})):
        log = str(tmp_path / f"{name}.log")
        best = main(common + ["--log_path", log, "--output_model_path",
                              str(tmp_path / f"{name}.bin")], **kw)
        out[name] = (best, _metrics(log + ".jsonl"))
    (jbest, jrecs), (tbest, trecs) = out["jax"], out["torch"]
    assert len(trecs) == len(jrecs) == 3
    for jr, tr in zip(jrecs, trecs):
        assert jr["step"] == tr["step"]
        for k in ("policy_loss", "value_loss", "rewards", "value",
                  "ndcg_full"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)
    assert abs(tbest - jbest) < 1e-3
    sd = load_any(str(tmp_path / "torch.bin"), kind="actor_critic")
    ac = ActorCritic(dataclasses.replace(Config().model, **_mcfg()))
    ac.actor.load_state_dict(sd["actor"], strict=True)
    ac.critic.load_state_dict(sd["critic"], strict=True)
    ac.load_state_dict(torch.load(str(tmp_path / "torch.bin")), strict=True)


def test_host_resident_memories_give_the_same_fit(tmp_path):
    """A zero device-memory budget keeps the memory buffer's batches on the
    host (copied out of the loader's recycled buffers) and moves them per
    update: the same run, number for number."""
    common = _fit_argv(tmp_path) + ["--eval_steps", "3"]
    recs = []
    for budget in ("4.0", "0.0"):
        log = str(tmp_path / f"port{budget}.log")
        tcli.main(common + ["--device_memory_gb", budget, "--log_path", log,
                            "--output_model_path",
                            str(tmp_path / "best.bin")], device="cpu")
        with open(log) as f:
            assert f"{'device' if budget == '4.0' else 'host'}-resident" \
                in f.read()
        recs.append([{k: v for k, v in r.items() if k != "time"}
                     for r in _metrics(log + ".jsonl")])
    assert len(recs[0]) == 3 and recs[0] == recs[1]
