"""Sequence parallelism (`--sp`) and Adafactor under tp and fsdp, on the CPU
over gloo (tests/test_torch_parallel.py:spawn):

  * the tower's loss and every gradient at tp 2 with --sp equal tp 2
    without it bit for bit (post-LN, and pre-LN under remat), and match the
    JAX package's sp program (tests/test_sp.py's check: dp 4 x tp 2 on its 8
    host devices) to the tower tolerance of tests/test_torch_pretrain_model.py;
  * the pretraining CLI at tp 2 with and without --sp, hash dropout at 0.1:
    the same losses and the same trained bits (the residual sites draw the
    global mask at the sequence shard's place);
  * hash dropout at the sp place: each tp rank's tokens draw the slice of
    JAX's mask over the whole (B, S, H) array;
  * Adafactor at tp 2 and at fsdp 2 (dp 2) against one process, 3 steps.

The tower is 4 layers of 16, 2 heads, vocabulary 32 (tests/test_sp.py's
widths); the ranks import no JAX."""

import json

import numpy as np
import pytest
import torch

from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint)
from lr2ppo_torch.towers.torch_import import tower_params_from_flax
from test_torch_parallel import spawn

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _restore_special_ids():
    """The CLI sets the port's processors' module-wide frame ids from the
    tokenizer (this file's vocabulary puts <pad> first): put them back when
    the module is done, so a later file in the same worker frames its
    instances with the defaults."""
    from lr2ppo_torch.data import pretrain_processors as tpp

    old = (tpp.CLS, tpp.PAD, tpp.SEP)
    yield
    tpp.set_special_ids(*old)

L, B, S, V = 4, 8, 16, 32
RAW = dict(emb_size=16, hidden_size=16, feedforward_size=32, heads_num=2,
           layers_num=L, max_seq_length=S, dropout=0.0, vocab_size=V,
           embedding=["word", "pos"], encoder="transformer",
           mask="fully_visible", target=["mlm"])
VARIANTS = {"post": {}, "pre_remat": {"layernorm_positioning": "pre",
                                      "remat": True}}
# the port against JAX: float32 sums in other orders (tests/
# test_torch_pretrain_model.py)
RTOL = 1e-5
# Adafactor at tp 2 and fsdp 2 against one process after 3 steps, each
# tensor within ADA_TOL of its largest magnitude
ADA_TOL = 1e-4
# the key projection's bias: its gradient is 0 but for rounding (a softmax
# ignores a shift shared by every key), and Adafactor scales that noise to
# full-size steps, so it is left out of the Adafactor comparison
SHIFT_LEAF = "self_attn.linear_layers.1.bias"


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(5, V, (B, S)).astype(np.int32)
    tgt = np.where(src % 7 == 0, src, 0).astype(np.int32)
    seg = np.ones((B, S), np.int32)
    return src, tgt, seg


def _grads_rank(rank, world, url, state, batch):
    """{(variant, sp): (loss, full-width gradients)} at tp 2."""
    from lr2ppo_torch.parallel import mesh as pm
    from lr2ppo_torch.train.common import DeviceCtx

    mesh = pm.make_mesh(1, 2)
    pm.set_active(mesh)
    ctx = DeviceCtx("cpu", mesh=mesh)
    out = {}
    for name, kw in VARIANTS.items():
        for sp in (False, True):
            cfg = TowerConfig.from_dict({**RAW, **kw, "seq_parallel": sp})
            model = TowerModel(cfg, with_target=True)
            # the pre-LN stack's final norm keeps its ones and zeros
            model.load_state_dict({**model.state_dict(), **state},
                                  strict=True)
            ctx.place(model)
            loss = model(*(torch.from_numpy(a) for a in batch),
                         deterministic=False, generator=torch.Generator())[0]
            loss.backward()
            grads = {k: p.grad for k, p in model.named_parameters()}
            saved = {k: p.detach().clone() for k, p in
                     model.named_parameters()}
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(grads[k])
            full = {k: v.numpy().copy()
                    for k, v in ctx.full_state_dict(model).items()}
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(saved[k])
            out[name, sp] = (float(loss.detach()), full)
    return out


@pytest.fixture(scope="module")
def tower_grads(tmp_path_factory):
    import jax

    from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig
    from lr2ppo_tpu.towers.model import TowerModel as JTowerModel

    src, tgt, seg = _batch()
    model = JTowerModel(JTowerConfig.from_dict(RAW))
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(0), src, tgt, seg))
    state = tower_params_from_flax(params)
    got = spawn(_grads_rank, 2, tmp_path_factory.mktemp("sp_grads"), state,
                (src, tgt, seg))
    return params, got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sp_gradients_equal_tp_bit_for_bit(tower_grads, variant):
    _params, ranks = tower_grads
    for got in ranks:
        (l_tp, g_tp), (l_sp, g_sp) = got[variant, False], got[variant, True]
        assert l_sp == l_tp
        assert g_sp.keys() == g_tp.keys()
        for k in g_tp:
            np.testing.assert_array_equal(g_sp[k], g_tp[k], err_msg=k)
    # every tp rank holds the same whole gradients
    for k in ranks[0][variant, True][1]:
        np.testing.assert_array_equal(ranks[0][variant, True][1][k],
                                      ranks[1][variant, True][1][k])


def test_sp_matches_the_jax_sp_program(tower_grads):
    """tests/test_sp.py's check, carried across: JAX's sp tower at dp 4 x
    tp 2 against the port's at tp 2, loss and every gradient."""
    import jax
    import jax.numpy as jnp

    from lr2ppo_tpu.parallel.mesh import make_mesh, shard_params
    from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig
    from lr2ppo_tpu.towers.model import TowerModel as JTowerModel

    params, ranks = tower_grads
    src, tgt, seg = _batch()
    mesh = make_mesh(dp=4, tp=2)
    model = JTowerModel(JTowerConfig.from_dict({**RAW,
                                                "seq_parallel": True}))
    placed = shard_params(jax.tree.map(jnp.asarray, params), mesh)

    def loss(p):
        return model.apply(p, src, tgt, seg, deterministic=True)[0]

    with jax.set_mesh(mesh):
        jl, jg = jax.jit(jax.value_and_grad(loss))(placed)
    want = tower_params_from_flax(jax.tree.map(np.asarray,
                                               jax.device_get(jg)))
    l_sp, g_sp = ranks[0]["post", True]
    np.testing.assert_allclose(l_sp, float(jl), rtol=RTOL)
    assert g_sp.keys() == want.keys()
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in g_sp.items():
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_sp_place_is_a_slice_of_the_whole_mask(dtype):
    """A tp rank's S/tp tokens of (B, S, H) at dp 2 x tp 2: the place
    shard_place gives the sp sites (dims 1.. split over tp) draws the
    tokens' slice of JAX's whole-array mask, forward and backward."""
    import jax.numpy as jnp

    from lr2ppo_torch.ops import hash_dropout as thd
    from lr2ppo_torch.parallel import mesh as pm
    from test_torch_parallel import _jax_mask_apply

    rng = np.random.RandomState(3)
    full = rng.randn(4, S, 24).astype(np.float32)
    want = _jax_mask_apply(np.asarray(jnp.asarray(full, getattr(jnp,
                                                                dtype))),
                           1234, 0.1)
    ones = _jax_mask_apply(np.ones(full.shape, np.float32), 1234, 0.1)
    xf = torch.from_numpy(full).to(getattr(torch, dtype))
    try:
        for rank in range(4):
            pm.set_active(pm.Mesh(dp=2, tp=2, rank=rank))
            d, t = rank // 2, rank % 2
            idx = (slice(2 * d, 2 * d + 2),
                   slice(t * S // 2, (t + 1) * S // 2))
            local = xf[idx].contiguous().requires_grad_(True)
            place = thd.shard_place(local, 1)
            assert place == (2 * d, t * (S // 2) * 24, S * 24, S // 2 * 24)
            got = thd.hash_dropout(local, 1234, 0.1, place)
            np.testing.assert_array_equal(got.detach().float().numpy(),
                                          np.asarray(want, np.float32)[idx])
            got.backward(torch.ones_like(local))
            np.testing.assert_array_equal(local.grad.float().numpy() != 0,
                                          ones[idx] != 0)
    finally:
        pm.set_active(None)


# -- a sequence that tp does not divide ------------------------------------
S6, TP4 = 6, 4
RAW6 = {**RAW, "heads_num": 4, "max_seq_length": S6, "layers_num": 2}


def _batch6():
    rng = np.random.default_rng(3)
    src = rng.integers(5, V, (4, S6)).astype(np.int32)
    tgt = np.where(src % 3 == 0, src, 0).astype(np.int32)
    seg = np.ones((4, S6), np.int32)
    seg[0, -2:] = 0
    return src, tgt, seg


def _uneven_rank(rank, world, url, state, batch):
    """{(sp, dropout): (loss, full-width gradients)} at tp 4, S = 6: each
    --sp rank holds ceil(6 / 4) = 2 tokens, the last none."""
    from lr2ppo_torch.parallel import mesh as pm
    from lr2ppo_torch.parallel.tp import seq_chunk
    from lr2ppo_torch.train.common import DeviceCtx

    mesh = pm.make_mesh(1, TP4)
    pm.set_active(mesh)
    ctx = DeviceCtx("cpu", mesh=mesh)
    out = {"chunk": seq_chunk(S6, TP4)}
    for sp in (False, True):
        for rate in (0.0, 0.1):
            cfg = TowerConfig.from_dict({**RAW6, "seq_parallel": sp,
                                         "dropout": rate,
                                         "hash_dropout": True})
            model = TowerModel(cfg, with_target=True)
            model.load_state_dict({**model.state_dict(), **state},
                                  strict=True)
            ctx.place(model)
            loss = model(*(torch.from_numpy(a) for a in batch),
                         deterministic=rate == 0.0,
                         generator=torch.Generator().manual_seed(5))[0]
            loss.backward()
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(grads[k])
            out[sp, rate] = (float(loss.detach()), {
                k: v.numpy().copy()
                for k, v in ctx.full_state_dict(model).items()})
    return out


def test_sp_at_an_uneven_sequence_matches_jax_and_tp(tmp_path):
    """S = 6 at tp 4, which JAX's sp program runs (its sharding constraint
    splits the sequence unevenly). The port's --sp shards it as XLA does,
    ceil(S / tp) tokens a rank and the last rank none, padded with zero
    tokens that no sum sees: the loss and every gradient match JAX's sp
    program at RTOL of each leaf's scale, and with hash dropout at 0.1
    --sp has the tp run's bits (the residual sites draw the global mask at
    the shard's place)."""
    import jax
    import jax.numpy as jnp

    from lr2ppo_tpu.parallel.mesh import make_mesh, shard_params
    from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig
    from lr2ppo_tpu.towers.model import TowerModel as JTowerModel

    src, tgt, seg = _batch6()
    model = JTowerModel(JTowerConfig.from_dict(RAW6))
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(1), src, tgt, seg))
    mesh = make_mesh(dp=1, tp=TP4)
    sp_model = JTowerModel(JTowerConfig.from_dict({**RAW6,
                                                   "seq_parallel": True}))
    placed = shard_params(jax.tree.map(jnp.asarray, params), mesh)

    def loss(p):
        return sp_model.apply(p, src, tgt, seg, deterministic=True)[0]

    with jax.set_mesh(mesh):
        jl, jg = jax.jit(jax.value_and_grad(loss))(placed)
    want = tower_params_from_flax(jax.tree.map(np.asarray,
                                               jax.device_get(jg)))
    ranks = spawn(_uneven_rank, TP4, tmp_path, tower_params_from_flax(params),
                  (src, tgt, seg), timeout=150)
    assert ranks[0]["chunk"] == 2
    top = max(float(w.abs().max()) for w in want.values())
    for got in ranks:
        l_sp, g_sp = got[True, 0.0]
        np.testing.assert_allclose(l_sp, float(jl), rtol=RTOL)
        assert g_sp.keys() == want.keys()
        for k, g in g_sp.items():
            w = want[k].numpy()
            scale = max(float(np.abs(w).max()), 1e-2 * top)
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                       err_msg=k)
        (l_tp, g_tp), (l_sd, g_sd) = got[False, 0.1], got[True, 0.1]
        assert l_sd == l_tp and l_sd != got[False, 0.0][0]
        for k in g_tp:
            np.testing.assert_array_equal(g_sd[k], g_tp[k], err_msg=k)


# -- the CLI ----------------------------------------------------------------
TOKENS = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + [
    f"w{i}" for i in range(V - 5)]


def _cli_rank(rank, world, url, argv):
    from lr2ppo_torch.cli import pretrain

    return pretrain.main(argv + [
        "--distributed", "true", "--coordinator", url, "--num_processes",
        str(world), "--process_id", str(rank)], device="cpu")


def _files(d, **tower):
    (d / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    rng = np.random.RandomState(0)
    (d / "c.txt").write_text("".join(
        " ".join(rng.choice(TOKENS[5:], 12)) + "\n" for _ in range(60)))
    (d / "tower.json").write_text(json.dumps({**RAW, **tower}))
    return ["--corpus_path", str(d / "c.txt"), "--tower_config",
            str(d / "tower.json"), "--tokenizer", "space", "--vocab_path",
            str(d / "v.txt"), "--batch_size", "8", "--accumulation_steps",
            "2", "--seq_length", str(S), "--total_steps", "3",
            "--report_steps", "1", "--learning_rate", "1e-2",
            "--output_model_path", str(d / "m"), "--log_path",
            str(d / "m.log")]


def test_sp_cli_trains_to_the_tp_bits_with_hash_dropout(tmp_path):
    out = {}
    for name, extra in (("tp2", []), ("sp2", ["--sp"])):
        d = tmp_path / name
        d.mkdir()
        argv = _files(d, dropout=0.1) + ["--tp", "2", "--hash_dropout",
                                         *extra]
        spawn(_cli_rank, 2, d, argv, timeout=150)
        with open(d / "m.log.jsonl") as f:
            recs = [json.loads(x) for x in f]
        out[name] = (recs, load_tower_checkpoint(str(d / "m")))
    (r_tp, p_tp), (r_sp, p_sp) = out["tp2"], out["sp2"]
    assert [r["loss"] for r in r_sp] == [r["loss"] for r in r_tp]
    assert [r["acc"] for r in r_sp] == [r["acc"] for r in r_tp]
    assert p_sp.keys() == p_tp.keys()
    assert all(torch.equal(p_sp[k], p_tp[k]) for k in p_tp)


# -- Adafactor under tp and fsdp -------------------------------------------
def _ada_rank(rank, world, url, argv, extra):
    from lr2ppo_torch.cli import pretrain

    if world > 1:
        extra = extra + ["--distributed", "true", "--coordinator", url,
                         "--num_processes", str(world), "--process_id",
                         str(rank)]
    trainer, loader = pretrain.build(pretrain.parser().parse_args(
        argv + extra), "cpu")
    trainer.cfg.optim.optimizer = "adafactor"
    state, _ = trainer.fit(loader, 3)
    params = trainer.ctx.full_state_dict(state.model)
    stats = state.opt.state_dict()
    splits = getattr(state.opt.inner, "splits", {}) if world > 1 else {}
    return ({k: v.numpy() for k, v in params.items()},
            {t: {k: v.numpy() for k, v in stats[t].items()}
             for t in ("v_row", "v_col", "v")}, sorted(splits))


@pytest.fixture(scope="module")
def adafactor_fits(tmp_path_factory):
    # at width 256 the large tensors pass fsdp's 2^16-element floor
    out = {}
    for name, world, extra in (("one", 1, []), ("tp2", 2, ["--tp", "2"]),
                               ("fsdp2", 2, ["--dp", "2", "--fsdp"])):
        d = tmp_path_factory.mktemp(f"ada_{name}")
        argv = _files(d, emb_size=256, hidden_size=256,
                      feedforward_size=512, heads_num=4, layers_num=2)
        out[name] = spawn(_ada_rank, world, d, argv, extra,
                          join=world > 1, timeout=150)[0]
    return out


@pytest.mark.parametrize("leg", ["tp2", "fsdp2"])
def test_adafactor_split_matches_one_process(adafactor_fits, leg):
    ref_p, ref_s, _ = adafactor_fits["one"]
    got_p, got_s, split = adafactor_fits[leg]
    # the split parameters: every large product's weight under tp; under
    # fsdp every tensor of 2^16 elements or more
    assert len(split) >= (16 if leg == "tp2" else 6), split
    assert got_p.keys() == ref_p.keys()
    for k, w in ref_p.items():
        if not k.endswith(SHIFT_LEAF):
            np.testing.assert_allclose(
                got_p[k], w, rtol=0, atol=ADA_TOL * np.abs(w).max(),
                err_msg=k)
    for t, table in ref_s.items():
        # the statistics gathered whole: the one-process shapes
        assert got_s[t].keys() == table.keys()
        for k, w in table.items():
            assert got_s[t][k].shape == w.shape, (t, k)
            if not k.endswith(SHIFT_LEAF):
                np.testing.assert_allclose(
                    got_s[t][k], w, rtol=0,
                    atol=ADA_TOL * np.abs(w).max(), err_msg=f"{t} {k}")
