"""The port's spans and counters (lr2ppo_torch/utils/guards.py: span, count,
counters): nothing is built while no profiler records; under torch.profiler
the trainers' Chrome traces hold every span, nested as the work is; the
host-to-device counts are the bytes handed to DeviceCtx; and --profile_dir
writes stage 3's and pretraining's window on rank 0 only."""

import json
import os

import numpy as np
import pytest
import torch

from lr2ppo_torch.utils import counters, count, guards, span
from test_torch_parallel import (BS, TAGS, _DS, _pretrain_files, _pw_cfg,
                                 spawn)

torch.set_num_threads(1)

PPO_SPANS = {"data.wait", "data.put", "ppo.step", "ppo.requantize",
             "ppo.rollout", "ppo.sweep", "ppo.update", "ppo.fetch",
             "ppo.eval", "ppo.save", "optim.step"}
PRETRAIN_SPANS = {"data.wait", "data.put", "pretrain.step",
                  "pretrain.update", "pretrain.report", "pretrain.save",
                  "optim.step"}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(path):
    """{name without the prefix: [(thread, start, end)]} of a Chrome trace's
    lr2ppo spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("lr2ppo."):
            out.setdefault(name[len("lr2ppo."):], []).append(
                (e["tid"], e["ts"], e["ts"] + e["dur"]))
    return out


def _traced(tmp_path, fn):
    with _profile() as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return _spans(path)


def _inside(inner, outer):
    """Every span of `inner` lies inside a span of `outer` on its thread."""
    return all(any(t == u and s >= a and e <= b for u, a, b in outer)
               for t, s, e in inner)


@pytest.fixture
def _restore_special_ids():
    """The pretraining CLI sets the processors' module-wide frame ids from
    the tokenizer; put them back for the next test in this worker."""
    from lr2ppo_torch.data import pretrain_processors as tpp

    old = (tpp.CLS, tpp.PAD, tpp.SEP)
    yield
    tpp.set_special_ids(*old)


def _ppo_cfg(tmp_path, **kw):
    cfg = _pw_cfg(out=str(tmp_path / "ppo.bin"), save=1, **kw)
    cfg.ppo.update_timesteps = 2
    cfg.ppo.rollout_int8 = "actor"
    cfg.data.max_tags = TAGS
    return cfg


def _ppo_fit(cfg):
    from lr2ppo_torch.data import EvalLoader, Loader
    from lr2ppo_torch.train.ppo import PPOTrainer

    tr = PPOTrainer(cfg, device="cpu")
    m = tr.ctx.mesh

    def make_train_loader(epoch):
        return Loader(_DS(), BS, shuffle=True, seed=epoch, num_workers=1,
                      shard=(m.dp_rank, m.dp) if m.dp > 1 else None)

    tr.fit(make_train_loader, EvalLoader(_DS(), buckets=[TAGS],
                                         batch_size=BS))
    return tr


def test_spans_and_counts_are_free_while_nothing_records(monkeypatch):
    """No profiler: span hands out one shared object and never builds a
    record_function; count leaves the counters as they were."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = counters()
    with span("ppo.step"), span("data.put"):
        count("h2d.bytes", 123)
    assert span("ppo.step") is span("data.put") is guards._NO_SPAN
    assert not guards.recording() and counters() == before


def test_a_span_is_a_range_of_the_recording_profiler(tmp_path):
    before = counters().get("test.count", 0)

    def work():
        assert guards.recording()
        with span("outer"):
            with span("inner"):
                count("test.count", 5)

    spans = _traced(tmp_path, work)
    assert _inside(spans["inner"], spans["outer"])
    assert counters()["test.count"] == before + 5


def test_ppo_fit_trace_holds_every_span(tmp_path):
    """Stage 3 (2 epochs of 2 batches, a sweep every 2 rollouts, the int8
    actor twin, a .state every sweep, an eval after each) under the
    profiler: every span of the trainer, the data path and AdamW, each
    update inside its sweep inside its batch, on one thread."""
    spans = _traced(tmp_path, lambda: _ppo_fit(_ppo_cfg(tmp_path)))
    assert PPO_SPANS <= set(spans), PPO_SPANS - set(spans)
    assert len(spans["ppo.update"]) == 2 * len(spans["ppo.sweep"]) == 4
    assert len(spans["ppo.step"]) == len(spans["ppo.rollout"]) == 4
    assert _inside(spans["ppo.update"], spans["ppo.sweep"])
    assert _inside(spans["ppo.sweep"], spans["ppo.step"])
    assert _inside(spans["ppo.rollout"], spans["ppo.step"])
    assert _inside(spans["ppo.fetch"], spans["ppo.sweep"])
    assert len({t for t, _, _ in spans["ppo.step"]}) == 1
    # the waits for a batch lie between the batches, not inside them
    assert not _inside(spans["data.wait"], spans["ppo.step"])


def test_pretrain_fit_trace_holds_every_span(tmp_path, _restore_special_ids):
    """MLM pretraining through the CLI (2 steps, a report and a .state
    each, the final model) under the profiler."""
    from lr2ppo_torch.cli import pretrain

    argv = _pretrain_files(tmp_path) + [
        "--output_model_path", str(tmp_path / "mlm"),
        "--save_checkpoint_steps", "1"]
    spans = _traced(tmp_path, lambda: pretrain.main(argv))
    assert PRETRAIN_SPANS <= set(spans), PRETRAIN_SPANS - set(spans)
    assert len(spans["pretrain.step"]) == len(spans["pretrain.update"]) == 2
    assert len(spans["pretrain.save"]) == 3
    assert _inside(spans["pretrain.update"], spans["pretrain.step"])
    assert _inside(spans["pretrain.report"], spans["pretrain.step"])
    assert _inside(spans["optim.step"], spans["pretrain.update"])


def test_h2d_counts_are_the_bytes_handed_to_put():
    """h2d.bytes and h2d.pageable_bytes grow by the nbytes of every array
    put (a numpy array's memory is pageable), only while recording."""
    from lr2ppo_torch.train.common import DeviceCtx

    ctx = DeviceCtx("cpu")
    batch = {"text": np.ones((4, 2, 3, 8), np.float32),
             "tgts": np.zeros((4, 2), np.int64)}
    state = np.zeros((4, 2), np.int32)
    want = sum(a.nbytes for a in batch.values()) + state.nbytes
    before = counters()
    with _profile():
        ctx.put(batch)
        ctx.put_array(state)
    ctx.put(batch)
    got = counters()
    for k in ("h2d.bytes", "h2d.pageable_bytes"):
        assert got[k] - before.get(k, 0) == want, k


def test_process_loader_waits_are_spans(tmp_path):
    from lr2ppo_torch.data.pipeline import ProcessLoader

    pl = ProcessLoader(_DS(), 4, shuffle=False, num_workers=1)
    try:
        assert len(list(pl)) == 4          # the pool starts unprofiled
        spans = _traced(tmp_path, lambda: [b for b in pl])
    finally:
        pl.close()
    assert len(spans["data.wait"]) == 4


class _PairDS(_DS):
    """_DS's items with a chosen and a rejected order of their tags."""

    def get(self, i):
        return dict(super().get(i), chosen_index=np.arange(TAGS),
                    reject_index=np.arange(TAGS)[::-1].copy())


def _window_rank(rank, world, url, kind, tmp):
    out = f"{tmp}/rank{rank}"
    if kind == "ppo":
        cfg = _ppo_cfg(tmp, dp=2, epochs=11).replace(profile_dir=out)
        return _ppo_fit(cfg).trace_path
    if kind == "reward":
        from lr2ppo_torch.data import Loader
        from lr2ppo_torch.train.reward import RewardTrainer

        tr = RewardTrainer(_pw_cfg(dp=2, epochs=11).replace(
            profile_dir=out, report_steps=100), device="cpu")
        tr.fit(Loader(_PairDS(), BS, seed=5, num_workers=1,
                      shard=(tr.ctx.mesh.dp_rank, 2)),
               Loader(_PairDS(), BS, shuffle=False, num_workers=1))
        return tr.trace_path
    from lr2ppo_torch.cli import pretrain

    trainer, loader = pretrain.build(pretrain.parser().parse_args(
        _pretrain_files(tmp) + [
            "--total_steps", "11", "--report_steps", "5",
            "--output_model_path", "", "--profile_dir", out, "--dp", "2",
            "--distributed", "--coordinator", url, "--num_processes", "2",
            "--process_id", str(rank)]), "cpu")
    trainer.fit(loader, 11)
    return trainer.trace_path


@pytest.mark.parametrize("kind,step", [("reward", "data.put"),
                                       ("ppo", "ppo.step"),
                                       ("pretrain", "pretrain.step")])
def test_profile_dir_traces_the_window_on_rank_0(tmp_path, kind, step):
    """--profile_dir at dp 2: rank 0 writes the window of steps (stage 2,
    pretraining) or sweeps (stage 3) 10 to 20, holding the trainer's spans
    and the gradients' all-reduce; rank 1 writes nothing. (The pretraining
    CLI joins its group itself; the ranks' processes are fresh, so its
    frame ids need no restoring.)"""
    paths = spawn(_window_rank, 2, tmp_path, kind, tmp_path,
                  join=kind != "pretrain", timeout=150)
    assert paths[0] == str(tmp_path / "rank0" / "trace_steps_10-20.json")
    spans = _spans(paths[0])
    assert {step, "optim.step", "optim.allreduce"} <= set(spans)
    assert paths[1] is None and not os.path.exists(tmp_path / "rank1")
