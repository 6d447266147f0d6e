"""The `.state` save and resume of the port's three trainers (stage 1
pointwise, stage 2 reward, stage 3 PPO) on the CPU: a fit interrupted after
its step-k save and resumed from it ends exactly where the uninterrupted fit
ends (parameters, Adam moments, counters, best), whether k falls mid-epoch
or on an epoch boundary, where only the restored dropout generator keeps the
stream aligned; a finished run resumed is a no-op; a JAX package `.state`
raises. Hash dropout is on, so the generator matters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_movienet
from lr2ppo_tpu.config import Config as JConfig
from lr2ppo_tpu.config import ModelConfig as JModelConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.train.common import init_state as jinit_state
from lr2ppo_tpu.train.common import save_train_state as jsave_train_state
from lr2ppo_tpu.train.optim import build_optimizer as jbuild
from lr2ppo_torch.cli import ppo_eval
from lr2ppo_torch.config import Config
from lr2ppo_torch.data import EvalLoader, Loader, MovieNetDataset
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.pointwise import PointwiseTrainer
from lr2ppo_torch.train.ppo import PPOTrainer
from lr2ppo_torch.train.reward import RewardTrainer

torch.set_num_threads(1)

D, HEADS, SEQ, IMGS = 32, 4, 4, 2


class Interrupted(Exception):
    pass


class StopAfter:
    """A loader that raises Interrupted when asked for batch n + 1 (counted
    over all epochs), as a run killed between two steps."""

    def __init__(self, loader, n=None):
        self.loader, self.left = loader, n

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def first_batch(self):
        return self.loader.first_batch()

    def __iter__(self):
        for batch in self.loader:
            if self.left == 0:
                raise Interrupted
            if self.left is not None:
                self.left -= 1
            yield batch


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("movienet")
    return make_movienet(str(root), n_items=10, seq=SEQ, feat=D, seed=6)


def _cfg(tmp_path, name, **kw):
    c = Config()
    model = dataclasses.replace(c.model, feat_size=D, seq_length=SEQ,
                                max_imgs=IMGS, num_heads=HEADS,
                                hash_dropout=True)
    optim = dataclasses.replace(c.optim, learning_rate=1e-3,
                                critic_learning_rate=1e-3)
    ppo = dataclasses.replace(c.ppo, update_timesteps=2, max_timesteps=1)
    return c.replace(model=model, optim=optim, ppo=ppo, epochs_num=2,
                     batch_size=4, report_steps=1, seed=3,
                     output_model_path=str(tmp_path / f"{name}.bin"), **kw)


def _snapshot(states):
    """Everything a resume must restore, per train state."""
    return {name: {"params": {k: v.clone() for k, v in
                              s.model.state_dict().items()},
                   "mu": {k: v.clone() for k, v in s.opt.mu.items()},
                   "nu": {k: v.clone() for k, v in s.opt.nu.items()},
                   "count": s.opt.count, "step": s.step}
            for name, s in states.items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name]["count"] == b[name]["count"]
        assert a[name]["step"] == b[name]["step"]
        for part in ("params", "mu", "nu"):
            assert a[name][part].keys() == b[name][part].keys()
            for k, v in a[name][part].items():
                assert torch.equal(v, b[name][part][k]), (name, part, k)


def _pointwise(tmp_path, data, name, stop=None, **kw):
    jp, hp = data
    cfg = _cfg(tmp_path, name, **kw)
    train = Loader(MovieNetDataset(jp, hp, "pointwise", max_tags=4,
                                   max_imgs=IMGS, seed=3), 4, seed=3,
                   num_workers=1)
    ev = EvalLoader(MovieNetDataset(jp, hp, "eval", max_imgs=IMGS),
                    [8], 4)
    state, best = PointwiseTrainer(cfg, "cpu").fit(StopAfter(train, stop),
                                                   ev)
    return {"model": state}, best


def _reward(tmp_path, data, name, stop=None, **kw):
    jp, hp = data
    cfg = _cfg(tmp_path, name, **kw)
    train = Loader(MovieNetDataset(jp, hp, "reward", max_imgs=IMGS, seed=3),
                   4, seed=3, num_workers=1)
    ev = Loader(MovieNetDataset(jp, hp, "reward_eval", max_tags=2,
                                max_imgs=IMGS, seed=3), 4, shuffle=False,
                num_workers=1)
    state, best = RewardTrainer(cfg, "cpu").fit(StopAfter(train, stop), ev)
    return {"model": state}, best


def _ppo(tmp_path, data, name, stop=None, **kw):
    jp, hp = data
    cfg = _cfg(tmp_path, name, **kw)
    train = StopAfter(Loader(MovieNetDataset(jp, hp, "ppo", max_tags=2,
                                             max_imgs=IMGS, seed=3),
                             5, seed=3, num_workers=1), stop)
    ev = EvalLoader(MovieNetDataset(jp, hp, "eval", max_imgs=IMGS), [8], 4)
    astate, cstate, best = PPOTrainer(cfg, "cpu").fit(lambda epoch: train,
                                                      ev)
    return {"actor": astate, "critic": cstate}, best


# (fit, batches per epoch, a save cadence, interrupt after batches k_mid
# and k_epoch): 10 items at batch 4 make 3 pointwise batches an epoch; 30
# reward pairs make 8; PPO draws 2 pairs an item, 4 batches of 5 an epoch,
# one sweep every 2 rollouts, so its saves fall after batches 2, 4 and 6
STAGES = {
    "pointwise": (_pointwise, 3, 1, 4, 3),
    "reward": (_reward, 8, 2, 6, 8),
    "ppo": (_ppo, 4, 1, 6, 4),
}


@pytest.mark.parametrize("where", ["mid_epoch", "epoch_boundary"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_resumed_fit_equals_the_uninterrupted_fit(tmp_path, data, stage,
                                                  where):
    fit, per_epoch, every, k_mid, k_epoch = STAGES[stage]
    k = k_mid if where == "mid_epoch" else k_epoch
    assert (k % per_epoch == 0) == (where == "epoch_boundary")
    full, full_best = fit(tmp_path, data, "full", save_state_steps=every)
    with pytest.raises(Interrupted):
        fit(tmp_path, data, "cut", stop=k, save_state_steps=every)
    state = str(tmp_path / "cut.bin.state")
    saved = checkpoints.load_state(state)
    # the interrupted run's last save holds the batches it saw
    consumed = (saved["time_ctr"] if stage == "ppo" else saved["step"])
    assert consumed == k
    resumed, best = fit(tmp_path, data, "cut", resume_path=state,
                        save_state_steps=every)
    _assert_same(_snapshot(full), _snapshot(resumed))
    assert best == full_best
    # the last .state of both runs is the same too
    end_full = checkpoints.load_state(str(tmp_path / "full.bin.state"))
    end_cut = checkpoints.load_state(state)
    for key in ("step", "best"):
        assert end_full[key] == end_cut[key]
    assert torch.equal(end_full["generator"], end_cut["generator"])


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_resuming_a_finished_run_is_a_noop(tmp_path, data, stage):
    fit, _, every, _, _ = STAGES[stage]
    full, full_best = fit(tmp_path, data, "full", save_state_steps=every)
    state = str(tmp_path / "full.bin.state")
    before = checkpoints.load_state(state)
    again, best = fit(tmp_path, data, "again", resume_path=state)
    _assert_same(_snapshot(full), _snapshot(again))
    assert best == full_best == before["best"]


def test_a_jax_state_raises(tmp_path, data):
    """The JAX package's pointwise `.state` (a pickle of its params and
    optax tree) is refused before any step, with a message that says so;
    so is the orbax directory of the JAX package's 'orbax' backend, by
    load_state and load_any, naming the JAX package."""
    mcfg = JModelConfig(feat_size=D, seq_length=SEQ, max_imgs=IMGS,
                        visual_feat_dim=D, num_heads=HEADS)
    rng = np.random.RandomState(0)
    params = JScore(mcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(rng.randn(2, 4, SEQ, D),
                                           jnp.float32),
        jnp.asarray(rng.randn(2, IMGS, D), jnp.float32))
    tx = jbuild(JConfig().optim, 10)
    path = str(tmp_path / "jax.state")
    jsave_train_state(path, jinit_state(params, tx), 3, 0.5)
    with pytest.raises(ValueError, match="JAX package .state"):
        _pointwise(tmp_path, data, "port", resume_path=path)
    orbax = str(tmp_path / "orbax.state")
    jsave_train_state(orbax, jinit_state(params, tx), 3, 0.5,
                      backend="orbax")
    for load in (checkpoints.load_state, checkpoints.load_any):
        with pytest.raises(ValueError, match="orbax.*JAX package"):
            load(orbax)
    with pytest.raises(ValueError, match="orbax.*JAX package"):
        _pointwise(tmp_path, data, "port", resume_path=orbax)


@pytest.mark.parametrize("backend", ["orbax", "orbax_async"])
@pytest.mark.parametrize("stage", ["pointwise", "ppo"])
def test_sharded_resume_equals_the_uninterrupted_fit(tmp_path, data, stage,
                                                     backend):
    """A fit cut mid-epoch after its save with a sharded backend, resumed
    from the directory, ends where the uninterrupted pickle fit ends; its
    best checkpoint, a directory too, reads as that fit's `.bin` (through
    ppo_eval for stage 3)."""
    fit, _, every, k, _ = STAGES[stage]
    full, full_best = fit(tmp_path, data, "full", save_state_steps=every)
    with pytest.raises(Interrupted):
        fit(tmp_path, data, "cut", stop=k, save_state_steps=every,
            ckpt_backend=backend)
    state = str(tmp_path / "cut.bin.state")
    resumed, best = fit(tmp_path, data, "cut", resume_path=state,
                        save_state_steps=every, ckpt_backend=backend)
    assert checkpoints.is_sharded(state)
    _assert_same(_snapshot(full), _snapshot(resumed))
    assert best == full_best
    kind = "actor_critic" if stage == "ppo" else "single"
    best_dir, best_bin = str(tmp_path / "cut.bin"), str(tmp_path / "full.bin")
    assert checkpoints.is_sharded(best_dir)
    got, want = (checkpoints.load_any(p, kind) for p in (best_dir, best_bin))
    if stage == "pointwise":
        got, want = {"model": got}, {"model": want}
    for side in want:
        assert got[side].keys() == want[side].keys()
        assert all(torch.equal(got[side][k], v)
                   for k, v in want[side].items())
    if stage == "ppo":
        jp, _ = data
        argv = ["--dev_path", jp, "--feat_size", str(D), "--seq_length",
                str(SEQ), "--num_heads", str(HEADS), "--max_imgs", str(IMGS),
                "--batch_size", "4", "--case_path",
                str(tmp_path / "cases.json")]
        assert (ppo_eval.main(argv + ["--pretrained_model_path", best_dir],
                              device="cpu")
                == ppo_eval.main(argv + ["--pretrained_model_path",
                                         best_bin], device="cpu"))
