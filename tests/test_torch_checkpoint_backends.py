"""The sharded checkpoint backends (`--ckpt_backend orbax|orbax_async`,
lr2ppo_torch/train/checkpoints.py) on the CPU, with no JAX in this module
(its functions run in spawned ranks):

  * 'orbax_async' returns once this rank's tensors are copied off the live
    ones: an in-place update made while the write is held back does not
    reach the directory; a failed background write raises at the next
    settle, and a save after it settles first, so it raises too;
  * a directory whose parts are missing, or that holds a tensor twice (two
    tp shards stored whole under one key), is refused;
  * over gloo (tests/test_torch_parallel.py:spawn): stage 1 at dp 2 with
    zero1, stage 3 at tp 2 and MLM pretraining at pp 2. In each, the ranks
    fit one leg with the pickle backend and one with a sharded one, then
    resume both at the same mesh: the resumes are bit-equal. Each rank's
    file holds only its part (no split tensor at full width, no replica
    twice: the files' tensor bytes are the pickle `.state`'s), and the
    sharded `.state` resumes at world 1 bit-equal to the pickle one."""

import json
import os
import threading

import pytest
import torch

from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.common import TrainState, save_train_state
from lr2ppo_torch.train.optim import AdamW
from test_torch_parallel import spawn

torch.set_num_threads(1)


def _state():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
    opt = AdamW(dict(model.named_parameters()), lambda t: 1e-2)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    return TrainState(model, opt, 1)


def _flat(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, node


def _assert_equal_trees(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def _held_save(monkeypatch):
    """torch.save in the background waits until `go` is set."""
    go = threading.Event()
    save = torch.save

    def held(*args, **kw):
        if threading.current_thread() is not threading.main_thread():
            assert go.wait(30)
        return save(*args, **kw)

    monkeypatch.setattr(torch, "save", held)
    return go


def test_async_save_holds_the_values_of_its_call(tmp_path, monkeypatch):
    state = _state()
    gen = torch.Generator().manual_seed(4)
    path = str(tmp_path / "a.state")
    save_train_state(path, {"model": state}, gen, 1, 0.5, None, "pickle")
    want = checkpoints.load_state(path)
    go = _held_save(monkeypatch)
    save_train_state(path, {"model": state}, gen, 1, 0.5, None,
                     "orbax_async")
    with torch.no_grad():          # the next update, in place
        for t in (*state.model.parameters(), *state.opt.mu.values(),
                  *state.opt.nu.values()):
            t.add_(1.0)
    gen.manual_seed(5)
    assert not checkpoints.is_sharded(path)   # the write is held back
    go.set()
    got = checkpoints.load_state(path)  # settles first
    assert checkpoints.is_sharded(path) and checkpoints._SAVES.thread is None
    _assert_equal_trees(got, want)
    model = torch.nn.Linear(2, 2)
    checkpoints.save_model(str(tmp_path / "m"), model, "orbax_async")
    with torch.no_grad():
        model.weight.mul_(2)
    sd = checkpoints.load_any(str(tmp_path / "m"))
    assert torch.equal(sd["weight"] * 2, model.weight)


def test_a_failed_async_write_raises_at_the_next_settle(tmp_path,
                                                         monkeypatch):
    def broken(*args, **kw):
        raise OSError("disk full")

    model = torch.nn.Linear(2, 2)
    monkeypatch.setattr(torch, "save", broken)
    checkpoints.save_model(str(tmp_path / "m"), model, "orbax_async")
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        checkpoints.wait_for_async_saves()
    checkpoints.wait_for_async_saves()          # reported once
    checkpoints.save_model(str(tmp_path / "m"), model, "orbax_async")
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        checkpoints.save_model(str(tmp_path / "m"), model, "orbax_async")
    monkeypatch.undo()
    checkpoints.save_model(str(tmp_path / "m"), model, "orbax_async")
    assert torch.equal(checkpoints.load_any(str(tmp_path / "m"))["bias"],
                       model.bias)


def _write_parts(path, files, kind="model"):
    """A sharded directory by hand: one rank file per entry of `files`,
    each a list of (key, tensor, splits)."""
    os.makedirs(os.path.join(path, "v1"))
    for r, entries in enumerate(files):
        torch.save({"format": checkpoints.SHARDED_FORMAT, "rank": r,
                    "tensors": [[[k], t, [list(s) for s in splits]]
                                for k, t, splits in entries],
                    "values": []},
                   os.path.join(path, "v1", f"rank_{r}.pt"))
    with open(os.path.join(path, checkpoints.MANIFEST), "w") as f:
        json.dump({"format": checkpoints.SHARDED_FORMAT, "kind": kind,
                   "version": 1, "world": len(files), "data": "v1",
                   "files": [f"rank_{r}.pt" for r in range(len(files))]}, f)


def test_the_reader_refuses_a_part_held_twice_or_missing(tmp_path):
    w = torch.arange(12.0).reshape(4, 3)
    _write_parts(str(tmp_path / "ok"), [[("w", w[:2], [(0, 0, 2)])],
                                        [("w", w[2:], [(0, 1, 2)])]])
    assert torch.equal(checkpoints.load_any(str(tmp_path / "ok"))["w"], w)
    # two tp shards stored whole under one key
    _write_parts(str(tmp_path / "twice"), [[("w", w[:2], [])],
                                           [("w", w[2:], [])]])
    with pytest.raises(ValueError, match="2 parts where one holds"):
        checkpoints.load_any(str(tmp_path / "twice"))
    _write_parts(str(tmp_path / "missing"), [[("w", w[:2], [(0, 0, 2)])]])
    with pytest.raises(ValueError, match=r"parts \[0\] of 2"):
        checkpoints.load_any(str(tmp_path / "missing"))


# -- over gloo -------------------------------------------------------------
def _tensor_bytes(node) -> int:
    return sum(v.numel() * v.element_size() for _, v in _flat(node)
               if isinstance(v, torch.Tensor))


def _check_rank_files(sharded: str, pickled: str, world: int,
                      min_split: int = 4):
    """Each rank's file holds parts, never a split tensor at full width
    (at least `min_split` of them split), and the files hold the pickle
    `.state`'s tensor bytes between them: each tensor once."""
    files = checkpoints.rank_files(sharded)
    assert len(files) == world
    whole = dict(_flat(checkpoints.load_state(sharded)))
    total, split = 0, 0
    for f in files:
        payload = torch.load(f, weights_only=True)
        for keys, t, splits in payload["tensors"]:
            total += t.numel() * t.element_size()
            if splits:
                split += 1
                assert t.shape != whole[tuple(keys)].shape, keys
        for keys, v in payload["values"]:
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
        if payload["rank"] != 0:
            assert payload["values"] == []
    assert split >= min_split
    assert total == _tensor_bytes(checkpoints.load_state(pickled))


def _leg_pointwise(tmp, backend, epochs, save=0, resume=""):
    """Stage 1 of tests/test_torch_parallel.py's _DS at this process's mesh
    (dp 2 with zero1 in the ranks); the full-width parameters and
    moments."""
    from lr2ppo_torch.data import EvalLoader, Loader
    from lr2ppo_torch.train.pointwise import PointwiseTrainer
    from test_torch_parallel import BS, TAGS, _DS, _pw_cfg

    world = torch.distributed.get_world_size() if \
        torch.distributed.is_initialized() else 1
    cfg = _pw_cfg(dp=world, zero1=world > 1, out=f"{tmp}/{backend}.bin",
                  save=save, epochs=epochs, resume=resume).replace(
        ckpt_backend=backend)
    tr = PointwiseTrainer(cfg, device="cpu")
    m = tr.ctx.mesh
    loader = Loader(_DS(), BS, shuffle=True, seed=5, num_workers=1,
                    shard=(m.dp_rank, m.dp) if m.dp > 1 else None)
    state, _ = tr.fit(loader, EvalLoader(_DS(), buckets=[TAGS],
                                         batch_size=BS))
    assert checkpoints._SAVES.thread is None          # fit returned settled
    return {"model": tr.ctx.full_state_dict(state.model),
            "moments": state.opt.state_dict()}


def _leg_ppo(tmp, backend, epochs, save=0, resume=""):
    """Stage 3 of _DS (2 updates a sweep) at this process's mesh (tp 2 in
    the ranks)."""
    from lr2ppo_torch.data import EvalLoader, Loader
    from lr2ppo_torch.train.ppo import PPOTrainer
    from test_torch_parallel import BS, TAGS, _DS, _pw_cfg

    world = torch.distributed.get_world_size() if \
        torch.distributed.is_initialized() else 1
    cfg = _pw_cfg(tp=world, out=f"{tmp}/{backend}.bin", save=save,
                  epochs=epochs, resume=resume).replace(ckpt_backend=backend)
    cfg.ppo.update_timesteps = 2
    cfg.data.max_tags = TAGS
    tr = PPOTrainer(cfg, device="cpu")

    def make_train_loader(epoch):
        return Loader(_DS(), BS, shuffle=True, seed=epoch, num_workers=1)

    astate, cstate, _ = tr.fit(make_train_loader,
                               EvalLoader(_DS(), buckets=[TAGS],
                                          batch_size=BS))
    assert checkpoints._SAVES.thread is None
    return {side: {"model": tr.ctx.full_state_dict(s.model),
                   "moments": s.opt.state_dict()}
            for side, s in (("actor", astate), ("critic", cstate))}


LEGS = {"dp2_zero1_stage1": (_leg_pointwise, "orbax"),
        "tp2_stage3": (_leg_ppo, "orbax_async")}


def _mesh_rank(rank, world, url, leg, tmp):
    """One epoch with its `.state` saved with each backend, then the second
    epoch resumed from each."""
    from lr2ppo_torch.parallel import mesh as pm

    pm.ZERO1_MIN_ELEMENTS = 16          # so these tiny layers shard
    fit, backend = LEGS[leg]
    for b in ("pickle", backend):
        fit(tmp, b, epochs=1, save=1)
    return {b: fit(tmp, b, epochs=2, resume=f"{tmp}/{b}.bin.state")
            for b in ("pickle", backend)}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_sharded_state_over_gloo(tmp_path, leg):
    fit, backend = LEGS[leg]
    ranks = spawn(_mesh_rank, 2, tmp_path, leg, str(tmp_path), timeout=180)
    for r in ranks:
        _assert_equal_trees(r[backend], r["pickle"])
    sharded = f"{tmp_path}/{backend}.bin.state"
    _check_rank_files(sharded, f"{tmp_path}/pickle.bin.state", 2)
    # the best checkpoint, read whole, is the pickle backend's `.bin`
    kind = "actor_critic" if fit is _leg_ppo else "single"
    _assert_equal_trees(
        checkpoints.load_any(f"{tmp_path}/{backend}.bin", kind),
        checkpoints.load_any(f"{tmp_path}/pickle.bin", kind))
    # both `.state`s resume at world 1, to the same bits
    one = {b: fit(str(tmp_path / "w1"), b, epochs=2,
                  resume=f"{tmp_path}/{b}.bin.state")
           for b in ("pickle", backend)}
    _assert_equal_trees(one[backend], one["pickle"])


# -- pp 2 MLM pretraining --------------------------------------------------
@pytest.fixture
def _restore_special_ids():
    """The pretraining CLI sets the processors' module-wide frame ids from
    the tokenizer; put them back for the next test in this worker."""
    from lr2ppo_torch.data import pretrain_processors as tpp

    old = (tpp.CLS, tpp.PAD, tpp.SEP)
    yield
    tpp.set_special_ids(*old)


def _pp_argv(tmp_path, backend, pp=True):
    from test_torch_pipeline import _argv

    return _argv(tmp_path) + (["--pp", "2"] if pp else []) + [
        "--ckpt_backend", backend, "--save_checkpoint_steps", "2",
        "--output_model_path", str(tmp_path / backend), "--log_path",
        str(tmp_path / f"{backend}.log")]


def _pp_rank(rank, world, url, tmp_path):
    """4 steps at pp 2 with each backend (a `.state` after steps 2 and 4),
    then steps 3 and 4 again from each one's step-2 `.state`."""
    from test_torch_pipeline import _cli_rank

    for b in ("pickle", "orbax"):
        argv = _pp_argv(tmp_path, b)
        _cli_rank(rank, world, url, argv)
        _cli_rank(rank, world, url, [
            a.replace(str(tmp_path / b), str(tmp_path / f"{b}_resumed"))
            for a in argv] + ["--resume_path", str(tmp_path / f"{b}-2")])


def test_sharded_state_at_pp2(tmp_path, _restore_special_ids):
    from test_torch_pipeline import _cli_rank

    spawn(_pp_rank, 2, tmp_path, tmp_path, timeout=180)
    for name in ("", "_resumed", "-best"):
        _assert_equal_trees(checkpoints.load_any(f"{tmp_path}/orbax{name}"),
                            checkpoints.load_any(f"{tmp_path}/pickle{name}"))
    _assert_equal_trees(checkpoints.load_any(f"{tmp_path}/orbax_resumed"),
                        checkpoints.load_any(f"{tmp_path}/orbax"))
    # each stage wrote its own keys of the `.state`
    _check_rank_files(f"{tmp_path}/orbax-2", f"{tmp_path}/pickle-2", 2,
                      min_split=0)
    stages = [{tuple(k) for k, _, _ in torch.load(f, weights_only=True)[
        "tensors"]} for f in checkpoints.rank_files(f"{tmp_path}/orbax-2")]
    assert stages[0] and stages[1] and not stages[0] & stages[1]
    # the sharded `.state` resumes in one process as the pickle one does
    for b in ("pickle", "orbax"):
        _cli_rank(0, 1, None, [
            a.replace(str(tmp_path / b), str(tmp_path / f"{b}_w1"))
            for a in _pp_argv(tmp_path, b, pp=False)] + [
            "--resume_path", str(tmp_path / f"{b}-2")])
    _assert_equal_trees(checkpoints.load_any(f"{tmp_path}/orbax_w1"),
                        checkpoints.load_any(f"{tmp_path}/pickle_w1"))
