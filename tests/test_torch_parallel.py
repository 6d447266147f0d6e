"""The port's multi-GPU layer on the CPU (lr2ppo_torch/parallel/): the tp
rule table against the JAX package's, hash dropout's global-index form
against JAX's mask of the whole array, the mesh and zero rules, and, in
ranks spawned over gloo with a file:// store, the tp collectives, the
global loss denominators, zero1, fsdp, the `.state` across world sizes,
ppo_eval's NDCG at dp 2 and a two-process `--distributed` launch.

`spawn` is the harness the other tests/test_torch_parallel*.py files use:
each case runs its ranks in fresh processes (one thread each), fails
rather than hangs past its time limit, and imports no JAX in the ranks.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
import traceback
import uuid

import numpy as np
import pytest
import torch

from lr2ppo_torch.parallel import mesh as pm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the harness ----------------------------------------------------------
def _rank_main(fn, rank, world, url, out, join, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        if join:
            dist.init_process_group("gloo", init_method=url, rank=rank,
                                    world_size=world)
        torch.save({"ok": fn(rank, world, url, *args)}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args, join=True, timeout=120):
    """fn(rank, world, url, *args) in `world` spawned processes; with
    `join` each first joins a gloo group at the file:// store `url`.
    Returns the ranks' results in rank order; a rank that raises, dies or
    outlives `timeout` seconds fails the test."""
    ctx = mp.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    url = f"file://{tmp_path}/pg_{tag}"
    outs = [str(tmp_path / f"rank{r}_{tag}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, url, outs[r], join, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        pytest.fail(f"ranks {hung} still running after {timeout} s")
    results = []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            pytest.fail(f"rank {r} died (exit code {procs[r].exitcode})")
        payload = torch.load(out, weights_only=False)
        if "error" in payload:
            pytest.fail(f"rank {r} raised:\n{payload['error']}")
        results.append(payload["ok"])
    return results


# -- the rule table -------------------------------------------------------
FEAT, SEQ, IMGS, TAGS, BS = 8, 3, 2, 2, 8


def _jax_tp_dims(torch_sd, to_flax):
    """{torch key: the torch dim JAX's _spec_for splits over tp}: every
    tensor is filled with its index, carried through the JAX package's
    torch -> flax bridge, and read back at its flax path."""
    import jax
    from lr2ppo_tpu.parallel.mesh import _spec_for

    keys = sorted(torch_sd)
    marked = {k: np.full(tuple(torch_sd[k].shape), i, np.float32)
              for i, k in enumerate(keys)}
    tree = to_flax(marked)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = keys[int(np.asarray(leaf).reshape(-1)[0])]
        spec = tuple(_spec_for(path))
        split = [i for i, a in enumerate(spec) if a == "tp"]
        if not split:
            out[key] = None
        elif leaf.ndim == 2:
            # flax kernels are (in, out), torch weights (out, in)
            out[key] = 1 - split[0]
        else:
            out[key] = split[0]
    return out


def test_rule_table_matches_jax_spec_for_on_the_scorers():
    import dataclasses

    from lr2ppo_tpu.train.checkpoints import torch_to_flax
    from lr2ppo_torch.config import Config
    from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel

    mcfg = dataclasses.replace(Config().model, feat_size=FEAT,
                               seq_length=SEQ, max_imgs=IMGS, num_heads=2)
    for cls in (ScoreModel, SeqScoreModel):
        sd = {k: v for k, v in cls(mcfg).state_dict().items()}
        want = _jax_tp_dims(sd, torch_to_flax)
        assert set(want) == set(sd)
        got = {k: pm.tp_dim(k) for k in sd}
        assert got == want
        assert sum(d is not None for d in got.values()) >= 12


def test_rule_table_matches_jax_spec_for_on_the_towers():
    """Every tower parameter splits as JAX's table says, but one: the MLM
    head's vocabulary projection `target.mlm.linear_2`, which JAX's
    ('linear_2', 'kernel') suffix rule (meant for the FFN) splits by rows;
    the port splits it over the vocabulary, so the loss is vocab-parallel
    and the logits are never all-reduced."""
    from lr2ppo_tpu.towers import torch_tower_to_flax
    from lr2ppo_torch.towers import TowerConfig, TowerModel

    for targets in (["mlm"], ["lm"], ["cls"]):
        cfg = TowerConfig(emb_size=16, hidden_size=16, feedforward_size=32,
                          heads_num=4, layers_num=2, max_seq_length=32,
                          vocab_size=40, target=targets)
        sd = TowerModel(cfg, with_target=True).state_dict()
        want = _jax_tp_dims(sd, torch_tower_to_flax)
        got = {k: pm.tp_dim(k) for k in sd}
        if "mlm" in targets:
            assert want.pop("target.mlm.linear_2.weight") == 1
            assert want.pop("target.mlm.linear_2.bias") is None
            assert got.pop("target.mlm.linear_2.weight") == 0
            assert got.pop("target.mlm.linear_2.bias") == 0
        assert got == want, targets


def test_coverage_refuses_a_large_parameter_the_table_misses():
    big = [("encoder.mystery.weight", torch.empty(2000, 600)),
           ("embedding.word.embedding.weight", torch.empty(2000, 600)),
           ("out_layer.fc1.weight", torch.empty(2000, 600))]
    pm.assert_tp_coverage(big[1:], tp=2)
    pm.assert_tp_coverage(big, tp=1)
    with pytest.raises(ValueError, match="encoder.mystery.weight"):
        pm.assert_tp_coverage(big, tp=2)


def test_zero_dim_is_jax_zero_spec():
    """The dp axis of a zero1 moment / fsdp parameter: the largest dim,
    other than the tp-split one, that dp divides (torch (out, in) layout
    against JAX's (in, out))."""
    from lr2ppo_tpu.parallel.mesh import _zero_spec

    class K:
        def __init__(self, key):
            self.key = key

    class JMesh:                    # _zero_spec reads the axis sizes only
        shape = {"dp": 2, "tp": 2}

    jmesh = JMesh()
    cases = [("out_layer.fc1.weight", (3072, 1024)),
             ("out_layer.fc2.weight", (768, 3072)),
             ("xit.0.0.0.fn.1.queries.weight", (768, 768)),
             ("head.weight", (1, 768)), ("pos_emb.weight", (50, 768)),
             ("xit.1.0.weight", (768,)), ("text_proj.fc1.bias", (3072,)),
             ("odd.weight", (333, 999))]
    for key, shape in cases:
        path = [K(p) for p in key.split(".")[:-1]] + [
            K("kernel" if len(shape) == 2 else "bias")]
        jshape = shape[::-1] if len(shape) == 2 else shape
        spec = tuple(_zero_spec(path, np.empty(jshape, np.int8), jmesh))
        want = spec.index("dp") if "dp" in spec else None
        if want is not None and len(shape) == 2:
            want = 1 - want
        assert pm.zero_dim(shape, 2, pm.tp_dim(key)) == want, key


def test_make_mesh_in_one_process():
    assert pm.make_mesh(-1, 1).world == 1
    for dp, tp in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match=f"needs {dp * tp} devices, "
                                             "have 1"):
            pm.make_mesh(dp, tp)
    m = pm.Mesh(dp=2, tp=2, rank=3)
    assert (m.dp_rank, m.tp_rank, m.world) == (1, 1, 4)


# -- hash dropout's global-index form --------------------------------------
def _jax_mask_apply(x, seed, rate):
    import jax.numpy as jnp
    from lr2ppo_tpu.ops import hash_dropout as jhd

    return np.asarray(jhd._apply(jnp.asarray(x), jnp.int32(seed), rate))


SHARDS = {
    # name: (global shape, (slicer of the local part), place of that part)
    "dp_shard": ((4, 3, 5), (slice(2, 4),), (6, 0, 5, 5)),
    "tp_columns": ((4, 3, 8), (slice(None), slice(None), slice(4, 8)),
                   (0, 4, 8, 4)),
    "dp_and_tp": ((4, 3, 8), (slice(2, 4), slice(None), slice(0, 4)),
                  (6, 0, 8, 4)),
    "heads": ((2, 4, 3, 3), (slice(None), slice(2, 4)), (0, 18, 36, 18)),
    "odd_width": ((6, 7), (slice(3, 6), slice(2, 7)), (3, 2, 7, 5)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shard", sorted(SHARDS))
def test_place_is_the_jax_mask_of_the_whole_array(shard, dtype):
    """A shard at (row0, col0, width) draws, bit for bit, the slice of the
    mask JAX's _apply draws over the whole array, forward and backward."""
    import jax.numpy as jnp
    from lr2ppo_torch.ops import hash_dropout as thd

    shape, idx, place = SHARDS[shard]
    rng = np.random.RandomState(1)
    full = rng.randn(*shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    xf = torch.from_numpy(full).to(tdt)
    want = _jax_mask_apply(np.asarray(jnp.asarray(full, getattr(jnp,
                                                                dtype))),
                           -77, 0.3)
    local = xf[idx].contiguous().requires_grad_(True)
    got = thd.hash_dropout(local, -77, 0.3, place)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32)[idx])
    g = torch.ones_like(local)
    got.backward(g)
    ones = _jax_mask_apply(np.ones(shape, np.float32), -77, 0.3)[idx]
    np.testing.assert_array_equal(local.grad.float().numpy() != 0,
                                  ones != 0)


def test_whole_tensor_place_is_the_local_form():
    from lr2ppo_torch.ops import hash_dropout as thd

    x = torch.randn(5, 7)
    assert torch.equal(thd.hash_dropout(x, 9, 0.2, (0, 0, 7, 7)),
                       thd.hash_dropout_reference(x, 9, 0.2))
    with pytest.raises(ValueError, match="do not tile"):
        thd.hash_dropout(x, 9, 0.2, (0, 0, 7, 6))


def test_shard_place_reassembles_the_global_mask():
    """Each rank of a dp 2 x tp 2 mesh takes its place from the active
    mesh: the column-split hidden (tp_from=-1) and the replicated branch
    (tp_from=None), whose tp ranks draw one mask."""
    from lr2ppo_torch.ops import hash_dropout as thd

    rng = np.random.RandomState(2)
    full = torch.from_numpy(rng.randn(4, 3, 8).astype(np.float32))
    want = thd.hash_dropout_reference(full, 5, 0.5)
    try:
        for rank in range(4):
            pm.set_active(pm.Mesh(dp=2, tp=2, rank=rank))
            d, t = rank // 2, rank % 2
            rows = slice(2 * d, 2 * d + 2)
            cols = slice(4 * t, 4 * t + 4)
            hidden = full[rows, :, cols].contiguous()
            got = thd.hash_dropout(hidden, 5, 0.5,
                                   thd.shard_place(hidden, -1))
            assert torch.equal(got, want[rows, :, cols])
            branch = full[rows].contiguous()
            got = thd.hash_dropout(branch, 5, 0.5, thd.shard_place(branch))
            assert torch.equal(got, want[rows])
    finally:
        pm.set_active(None)
    assert thd.shard_place(full) is None


def test_philox_offsets_tile_the_stream():
    """K3's counter starts at the shard's offset: dp shards concatenate to
    the whole array's mask; tp column shards draw disjoint counters."""
    from lr2ppo_torch.ops import dropout as td
    from lr2ppo_torch.ops import hash_dropout as thd

    x = torch.ones(4, 16)
    whole = td.philox_dropout_reference(x, 11, 0.5)
    parts = [td.philox_dropout_reference(x[2 * r: 2 * r + 2], 11, 0.5,
                                         offset=32 * r) for r in range(2)]
    assert torch.equal(torch.cat(parts), whole)
    offs = {thd.place_offset(x[:2, :8], (row0, col0, 16, 8))
            for row0 in (0, 2) for col0 in (0, 8)}
    assert offs == {0, 16, 32, 48}
    with pytest.raises(ValueError, match="multiple of 4"):
        td.philox_dropout_reference(x, 11, 0.5, offset=2)


def test_fused_ffn_gate_is_off_under_tp(monkeypatch):
    """Under dp alone K1 runs on each rank (the gate reads the rank's own
    rows); a tp-split fc1/fc2 pair never takes it."""
    from lr2ppo_torch.models.layers import Linear, fused_int8_ffn_ok
    from lr2ppo_torch.ops import int8 as tint8

    for name in ("INT8_MIN_KERNEL_ELEMENTS", "INT8_DYNQUANT_MIN_FLOPS"):
        monkeypatch.setattr(tint8, name, 0)
    fc1, fc2 = Linear(128, 512, int8=True), Linear(512, 128, int8=True)
    assert fused_int8_ffn_ok(fc1, fc2, (256, 128))
    fc1.tp_dim, fc2.tp_dim = 0, 1
    assert not fused_int8_ffn_ok(fc1, fc2, (256, 128))


# -- collectives, in ranks ------------------------------------------------
def _collectives(rank, world, url):
    """tp 2 and dp 2 meshes over one world of 2: what each rank computes
    against what one process computes over the whole."""
    import torch.nn.functional as F

    from lr2ppo_torch.ops import int8 as tint8
    from lr2ppo_torch.ops.losses import rank_hinge_loss
    from lr2ppo_torch.parallel import tp as ptp
    from lr2ppo_torch.towers.targets import MlmTarget
    from lr2ppo_torch.towers import TowerConfig
    from lr2ppo_torch.towers.model import init_weights

    out = {}
    gen = torch.Generator().manual_seed(0)
    tpm = pm.make_mesh(1, 2)
    pm.set_active(tpm)
    # vocab-parallel log-softmax, pick and argmax
    z = torch.randn(3, 5, 10, generator=gen)
    z[0, 0, 3] = z[0, 0, 7] = 50.0                 # a tie across ranks
    tgt = torch.randint(0, 10, (3, 5), generator=gen)
    part = z[..., 5 * rank: 5 * rank + 5]
    lz = ptp.vocab_parallel_log_softmax_parts(part, tpm)
    nll = lz[..., 0] - ptp.vocab_parallel_pick(part, tgt, tpm)
    want = -torch.gather(F.log_softmax(z, -1), -1, tgt[..., None])[..., 0]
    out["nll_err"] = float((nll - want).abs().max())
    out["argmax_equal"] = bool(torch.equal(
        ptp.vocab_parallel_argmax(part, tpm), z.argmax(-1)))
    # a row-split int8 product quantizes each row over the whole row
    x = torch.randn(6, 8, generator=gen)
    w = torch.randn(4, 8, generator=gen)
    q, s = tint8.quantize_weight(w)
    monkey = (tint8.INT8_DYNQUANT_MIN_FLOPS, tint8.INT8_DYNQUANT_MIN_WIDTH)
    tint8.INT8_DYNQUANT_MIN_FLOPS = tint8.INT8_DYNQUANT_MIN_WIDTH = 0
    qpart = q[:, 4 * rank: 4 * rank + 4]
    y = tint8.int8_linear(x[:, 4 * rank: 4 * rank + 4], qpart, s,
                          torch.float32, shape=(4, 8), mesh=tpm)
    full = tint8.int8_linear(x, q, s, torch.float32)
    tint8.INT8_DYNQUANT_MIN_FLOPS, tint8.INT8_DYNQUANT_MIN_WIDTH = monkey
    out["int8_row_err"] = float((y - full).abs().max()
                                / full.abs().max())
    # the MLM head split over tp against the whole head, loss and grads
    cfg = TowerConfig(hidden_size=8, emb_size=8, vocab_size=12)
    whole = MlmTarget(cfg)
    init_weights(whole, torch.Generator().manual_seed(3))
    split = MlmTarget(cfg)
    split.load_state_dict(whole.state_dict())
    split.linear_1.split_tp(0, tpm)
    split.linear_2.split_tp(0, tpm)
    h = torch.randn(2, 4, 8, generator=gen)
    t = torch.randint(0, 12, (2, 4), generator=gen)
    t[0, :2] = 0
    lw, cw, dw = whole(h, t, None)
    ls, cs, ds = split(h, t, None)
    lw.backward()
    ls.backward()
    out["mlm_loss"] = (float(lw), float(ls))
    out["mlm_counts"] = (float(cw), float(cs), float(dw), float(ds))
    g_w = whole.linear_2.weight.grad[6 * rank: 6 * rank + 6]
    out["mlm_grad_err"] = float((split.linear_2.weight.grad - g_w).abs()
                                .max())
    g_w1 = whole.linear_1.weight.grad[4 * rank: 4 * rank + 4]
    out["mlm_grad1_err"] = float((split.linear_1.weight.grad - g_w1).abs()
                                 .max())
    # dp 2: the violating-pair count and the masked count are global
    dpm = pm.make_mesh(2, 1)
    pm.set_active(dpm)
    scores = torch.randn(4, 3, generator=gen, requires_grad=True)
    idx = torch.tensor([[0, 1, 2], [2, 1, 0], [1, 0, 2], [0, 2, 1]])
    pm.set_active(None)
    ref = rank_hinge_loss(scores, idx, 0.5)
    (gref,) = torch.autograd.grad(ref, scores)
    pm.set_active(dpm)
    local = scores.detach()[2 * rank: 2 * rank + 2].requires_grad_(True)
    loss = rank_hinge_loss(local, idx[2 * rank: 2 * rank + 2], 0.5)
    loss.backward()
    g = local.grad.clone()
    import torch.distributed as dist

    # the trainers average gradients over dp; a rank's rows get only its
    # own summand, so the average of [g0, 0] and [0, g1] is half of each
    out["hinge"] = (float(loss), float(ref))
    out["hinge_grad_err"] = float((g / 2 - gref[2 * rank: 2 * rank + 2])
                                  .abs().max())
    whole_m = MlmTarget(cfg)
    whole_m.load_state_dict(whole.state_dict())
    hl = h.repeat(2, 1, 1)[2 * rank: 2 * rank + 2]
    tl = t.repeat(2, 1).clone()
    tl[3, :] = 0                                    # rank 1 masks more
    pm.set_active(None)
    lref2, cref2, dref2 = whole_m(h.repeat(2, 1, 1), tl, None)
    pm.set_active(dpm)
    l2, c2, d2 = whole_m(hl, tl[2 * rank: 2 * rank + 2], None)
    out["masked"] = (float(l2), float(lref2), float(d2), float(dref2),
                     float(c2), float(cref2))
    dist.barrier()
    pm.set_active(None)
    return out


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return spawn(_collectives, 2, tmp_path_factory.mktemp("coll"))


def test_vocab_parallel_log_softmax_matches_the_whole(collectives):
    for r in collectives:
        assert r["nll_err"] < 1e-5
        assert r["argmax_equal"]


def test_row_split_int8_takes_the_row_amax_over_tp(collectives):
    for r in collectives:
        assert r["int8_row_err"] < 1e-5


def test_mlm_head_split_over_tp_matches_the_whole_head(collectives):
    for r in collectives:
        lw, ls = r["mlm_loss"]
        assert abs(lw - ls) < 1e-5
        cw, cs, dw, ds = r["mlm_counts"]
        assert cw == cs and dw == ds
        assert r["mlm_grad_err"] < 1e-6 and r["mlm_grad1_err"] < 1e-6


def test_loss_denominators_are_global_under_dp(collectives):
    """rank_hinge_loss divides by the violating pairs of the whole batch,
    the masked NLL by the masked positions of the whole batch: each rank's
    value is the whole batch's, and the dp-averaged gradient its
    gradient."""
    for r in collectives:
        loss, ref = r["hinge"]
        assert abs(loss - ref) < 1e-6
        assert r["hinge_grad_err"] < 1e-6
        l2, lref2, d2, dref2, c2, cref2 = r["masked"]
        assert abs(l2 - lref2) < 1e-5 and d2 == dref2 and c2 == cref2


# -- the stage-1 trainer at dp 2: zero1, fsdp and the .state ---------------
N = 16


class _DS:
    """tests/test_tp_parity.py's items: 16 of 2 tags, 3 text tokens and 2
    image tokens of width 8."""

    def __init__(self):
        rng = np.random.RandomState(7)
        self.items = [
            dict(text=rng.randn(TAGS, SEQ, FEAT).astype(np.float32),
                 img=rng.randn(IMGS, FEAT).astype(np.float32),
                 tgts=rng.randint(0, 3, (TAGS,)).astype(np.float32))
            for _ in range(N)]

    def set_epoch(self, e):
        pass

    def __len__(self):
        return N

    def get(self, i):
        return self.items[i]


def _pw_cfg(dp=1, tp=1, zero1=False, fsdp=False, out="", resume="",
            save=0, epochs=2):
    from lr2ppo_torch.config import Config, ModelConfig

    mcfg = ModelConfig(family="multimodal", feat_size=FEAT, seq_length=SEQ,
                       max_imgs=IMGS, num_heads=2, mode="reg", drop_p=0.1,
                       forward_drop_p=0.1, hash_dropout=True)
    cfg = Config(model=mcfg).replace(
        epochs_num=epochs, batch_size=BS, report_steps=1,
        output_model_path=out, seed=3, save_state_steps=save,
        resume_path=resume)
    cfg.mesh.dp, cfg.mesh.tp = dp, tp
    cfg.mesh.zero1, cfg.mesh.fsdp = zero1, fsdp
    return cfg


def _fit_pointwise(**kw):
    """One stage-1 fit of _DS (2 steps an epoch, hash dropout at 0.1, an
    eval after every step) on this process's mesh; returns the full-width
    parameters, the best NDCG, and the local shapes of the parameters and
    of the AdamW moments."""
    from lr2ppo_torch.data import EvalLoader, Loader
    from lr2ppo_torch.train.pointwise import PointwiseTrainer

    tr = PointwiseTrainer(_pw_cfg(**kw), device="cpu")
    m = tr.ctx.mesh
    loader = Loader(_DS(), BS, shuffle=True, seed=5, num_workers=1,
                    shard=(m.dp_rank, m.dp) if m.dp > 1 else None)
    ev = EvalLoader(_DS(), buckets=[TAGS], batch_size=BS)
    state, best = tr.fit(loader, ev)
    inner = getattr(state.opt, "inner", state.opt)
    return {"full": {k: v.detach().clone() for k, v in
                     tr.ctx.full_state_dict(state.model).items()},
            "best": best,
            "local": {k: tuple(p.shape) for k, p in
                      tr.ctx.named_parameters(state.model).items()},
            "moments": {k: tuple(v.shape) for k, v in inner.mu.items()}}


def _dp2_fits(rank, world, url, tmp, w1_state):
    pm.ZERO1_MIN_ELEMENTS = 16          # so these tiny layers shard
    return {"plain": _fit_pointwise(dp=2),
            "zero1": _fit_pointwise(dp=2, zero1=True),
            "fsdp": _fit_pointwise(dp=2, fsdp=True),
            "save": _fit_pointwise(dp=2, zero1=True, epochs=1, save=1,
                                   out=f"{tmp}/dp2.bin"),
            "resumed": _fit_pointwise(dp=2, zero1=True, resume=w1_state,
                                      out=f"{tmp}/dp2_resumed.bin")}


@pytest.fixture(scope="module")
def dp2_fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp2")
    world1 = _fit_pointwise()
    _fit_pointwise(epochs=1, save=1, out=f"{tmp}/w1.bin")
    ranks = spawn(_dp2_fits, 2, tmp, str(tmp), f"{tmp}/w1.bin.state")
    from_dp2 = _fit_pointwise(resume=f"{tmp}/dp2.bin.state",
                              out=f"{tmp}/w1_resumed.bin")
    return {"world1": world1, "ranks": ranks, "from_dp2": from_dp2,
            "tmp": tmp}


def _close(a: dict, b: dict, atol: float) -> float:
    assert a.keys() == b.keys()
    worst = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    assert worst <= atol, worst
    return worst


def test_dp2_pointwise_tracks_world_1(dp2_fits):
    """dp 2 with hash dropout at 0.1 against the same run in one process:
    the ranks hold equal parameters, and they agree with world 1 to 1e-5
    (float32 sums over other batch splits; the masks are the same)."""
    r0, r1 = dp2_fits["ranks"]
    for k, v in r0["plain"]["full"].items():
        assert torch.equal(v, r1["plain"]["full"][k]), k
    _close(r0["plain"]["full"], dp2_fits["world1"]["full"], 1e-5)
    assert abs(r0["plain"]["best"] - dp2_fits["world1"]["best"]) < 1e-6


def test_zero1_is_bit_equal_to_plain_dp(dp2_fits):
    """Each rank updates its half of every large AdamW moment from the same
    averaged gradient and all-gathers its half of the parameter: the
    result is plain dp's, bit for bit."""
    for r in dp2_fits["ranks"]:
        plain, zero = r["plain"], r["zero1"]
        for k, v in plain["full"].items():
            assert torch.equal(zero["full"][k], v), k
        assert zero["best"] == plain["best"]
        halved = 0
        for k, shape in zero["moments"].items():
            full = plain["moments"][k]
            assert math_prod(shape) in (math_prod(full),
                                        math_prod(full) // 2), k
            halved += math_prod(shape) == math_prod(full) // 2
        assert halved >= 10
        assert r["zero1"]["local"] == r["plain"]["local"]


def math_prod(shape):
    return int(np.prod(shape)) if shape else 1


def test_fsdp_stores_half_of_each_large_parameter(dp2_fits):
    """fsdp at dp 2: each rank stores half of every large parameter (and
    of its moments), reads it whole through an all-gather, and trains to
    within 1e-6 of plain dp."""
    for r in dp2_fits["ranks"]:
        plain, fsdp = r["plain"], r["fsdp"]
        halved = [k for k, s in fsdp["local"].items()
                  if math_prod(s) == math_prod(plain["local"][k]) // 2]
        assert len(halved) >= 10
        assert "out_layer.fc1.weight" in halved
        for k in halved:
            assert fsdp["moments"][k] == fsdp["local"][k]
        _close(fsdp["full"], plain["full"], 1e-6)


def test_state_written_at_dp2_with_zero1_resumes_at_world_1(dp2_fits):
    """The dp 2 zero1 `.state` holds full tensors (the moments gathered);
    one process resumes it for the second epoch and ends within 1e-5 of
    the uninterrupted dp 2 run."""
    from lr2ppo_torch.train.checkpoints import load_state

    payload = load_state(f"{dp2_fits['tmp']}/dp2.bin.state")
    plain = dp2_fits["ranks"][0]["plain"]
    mu = payload["optims"]["model"]["mu"]
    for k, shape in plain["moments"].items():
        assert tuple(mu[k].shape) == shape, k
    assert payload["step"] == 2
    _close(dp2_fits["from_dp2"]["full"], plain["full"], 1e-5)


def test_state_written_at_world_1_resumes_at_dp2_with_zero1(dp2_fits):
    for r in dp2_fits["ranks"]:
        _close(r["resumed"]["full"], dp2_fits["world1"]["full"], 1e-5)


# -- ppo_eval at dp 2 ---------------------------------------------------------
def _ppo_eval_rank(rank, world, url, argv):
    from lr2ppo_torch.cli import ppo_eval

    dist_argv = ["--dp", "2", "--distributed", "true", "--coordinator", url,
                 "--num_processes", "2", "--process_id", str(rank)]
    return ppo_eval.main(argv + dist_argv + [
        "--case_path", argv[-1] + f".rank{rank}.json"], device="cpu")


def test_ppo_eval_ndcg_at_dp2_equals_world_1(tmp_path):
    """Each rank scores its rows of each eval batch (7 items at batch 3, so
    padded rows too); the rows are all-gathered and the NDCG is world 1's,
    number for number; rank 0 writes the case dump, the same cases."""
    import dataclasses

    from fixtures import make_movienet
    from lr2ppo_torch.cli import ppo_eval
    from lr2ppo_torch.config import Config
    from lr2ppo_torch.models.layers import init_weights
    from lr2ppo_torch.models.scorer import ActorCritic
    from lr2ppo_torch.train import checkpoints as tck

    d, heads, seq, imgs = 16, 2, 4, 2
    mcfg = dataclasses.replace(Config().model, feat_size=d, seq_length=seq,
                               max_imgs=imgs, num_heads=heads)
    ac = ActorCritic(mcfg)
    init_weights(ac, torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / "best.bin")
    tck.save_actor_critic(ckpt, ac.actor, ac.critic)
    data = make_movienet(str(tmp_path / "data"), n_items=7, seq=seq,
                         feat=d, max_tag_range=(3, 9), seed=5)[0]
    argv = ["--dev_path", data, "--feat_size", str(d), "--seq_length",
            str(seq), "--num_heads", str(heads), "--max_imgs", str(imgs),
            "--batch_size", "3", "--item_dtype", "float32",
            "--pretrained_model_path", ckpt]
    world1 = ppo_eval.main(argv + ["--dp", "1", "--case_path",
                                   str(tmp_path / "w1.json")], device="cpu")
    ranks = spawn(_ppo_eval_rank, 2, tmp_path, argv, join=False)
    for r in ranks:
        assert r == world1
    with open(tmp_path / "w1.json") as f:
        want = json.load(f)
    with open(ckpt + ".rank0.json") as f:
        assert json.load(f) == want
    assert not os.path.exists(ckpt + ".rank1.json")


# -- launching a CLI ------------------------------------------------------
def _pretrain_files(tmp_path):
    tokens = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + list("abcdefgh")
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in tokens))
    rng = np.random.RandomState(0)
    (tmp_path / "c.txt").write_text("".join(
        " ".join(rng.choice(list("abcdefgh"), 8)) + "\n" for _ in range(40)))
    (tmp_path / "tower.json").write_text(json.dumps({
        "emb_size": 16, "hidden_size": 16, "feedforward_size": 32,
        "heads_num": 4, "layers_num": 1, "max_seq_length": 32,
        "dropout": 0.1, "embedding": ["word", "pos", "seg"],
        "encoder": "transformer", "mask": "fully_visible",
        "target": ["mlm"]}))
    return ["--corpus_path", str(tmp_path / "c.txt"), "--tower_config",
            str(tmp_path / "tower.json"), "--tokenizer", "space",
            "--vocab_path", str(tmp_path / "v.txt"), "--batch_size", "4",
            "--seq_length", "16", "--total_steps", "2", "--report_steps",
            "1", "--hash_dropout", "--device", "cpu"]


def _launch(cmds, tmp_path, timeout=150):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def test_two_process_distributed_cli_launch(tmp_path):
    """The same `python -m lr2ppo_torch.cli pretrain` command once per
    process with --distributed --coordinator --num_processes --process_id
    trains as one dp 2 run; only rank 0 writes its log and checkpoints."""
    base = _pretrain_files(tmp_path)
    url = f"file://{tmp_path}/pg_cli"
    outs = [str(tmp_path / f"cli_{i}") for i in range(2)]
    cmds = [[sys.executable, "-m", "lr2ppo_torch.cli", "pretrain", *base,
             "--dp", "2", "--distributed", "--coordinator", url,
             "--num_processes", "2", "--process_id", str(i),
             "--output_model_path", outs[i], "--log_path", outs[i] + ".log"]
            for i in range(2)]
    procs, logs = _launch(cmds, tmp_path)
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i}:\n{log[-3000:]}"
    assert "tokens/s" in logs[0] and "tokens/s" not in logs[1]
    assert os.path.exists(outs[0]) and os.path.exists(outs[0] + "-best")
    assert not os.path.exists(outs[1]) and not os.path.exists(
        outs[1] + ".log.jsonl")
    with open(outs[0] + ".log.jsonl") as f:
        assert [json.loads(x)["step"] for x in f] == [1, 2]


def test_torchrun_launch_of_the_dispatcher(tmp_path):
    """`torchrun --standalone --nproc_per_node 2 -m lr2ppo_torch.cli
    pretrain ...`: the ranks read RANK, WORLD_SIZE and the rendezvous from
    the environment torchrun sets (a free port it picks)."""
    base = _pretrain_files(tmp_path)
    out = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "lr2ppo_torch.cli", "pretrain",
           *base, "--output_model_path", out, "--log_path", out + ".log"]
    (proc,), (log,) = _launch([cmd], tmp_path)
    assert proc.returncode == 0, log[-3000:]
    with open(out + ".log.jsonl") as f:
        assert [json.loads(x)["step"] for x in f] == [1, 2]


def test_dryrun_runs_dp_and_tp_on_the_cpu():
    """lr2ppo_torch.parallel.dryrun at world 2: one LR2PPO step at dp 2 and
    at tp 2, each in two gloo processes, against one process."""
    from lr2ppo_torch.parallel.dryrun import dryrun

    recs = dryrun(2, "cpu", timeout=150)
    assert [(r["dp"], r["tp"]) for r in recs] == [(2, 1), (1, 2)]
    for r in recs:
        assert r["updates"] == 1 and r["worst_over_tolerance"] <= 1.0
        assert r["best"] == [r["reference_best"]] * 2


@pytest.mark.parametrize("chunks", [1, 2])
def test_sharded_loader_hands_each_rank_its_rows(chunks):
    """Loader(shard=(rank, 2)): each rank's batch is its contiguous half of
    the global batch (per accumulation chunk), in the whole loader's order,
    the padded last batch too."""
    from lr2ppo_torch.data import Loader

    class Items:
        def __len__(self):
            return 21

        def get(self, i):
            return {"x": np.asarray([i], np.int64)}

    whole = [b["x"][:, 0].copy() for b in Loader(Items(), 8, seed=3,
                                                  num_workers=1)]
    parts = [[b["x"][:, 0].copy() for b in
              Loader(Items(), 8, seed=3, num_workers=1, shard=(r, 2),
                     shard_chunks=chunks)] for r in range(2)]
    assert len(parts[0]) == len(parts[1]) == len(whole) == 3
    for i, w in enumerate(whole):
        w = w.reshape(chunks, 2, -1)
        got = np.stack([parts[r][i].reshape(chunks, -1) for r in range(2)],
                       axis=1)
        np.testing.assert_array_equal(got, w)
