"""K2 under tp (ops/int8_matmul.py:int8_matmul_tp) and the tp 2 gaps of both
packages, on the CPU.

* The tp entry's plain pair (the exact int32 product, then the epilogue) is
  K2's plain version, bit for bit.
* With NARROW_SITES on, a row-split narrow site at tp 2 over gloo sums
  exact int32 parts over tp: its bits are K2's at world 1 and JAX's
  `int8_matmul` on the global arrays (the Pallas kernel in interpret mode,
  PALLAS_NARROW_SITES set here), which XLA computes unpartitioned because a
  pallas_call has no partitioning rule.
* Both packages at tp 2 against their own world 1, on the same weights and
  items in bfloat16: the served scores (each package's serve CLI, int8 on)
  and one stage-3 rollout and update (`param_gap` of every trained leaf).
  The port's gap stays within twice JAX's. The served gap is the route in
  both packages (world 1 fuses the int8 FFN, tp never does), not the
  row-split sums.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_movienet
from lr2ppo_tpu.ops import int8 as jint8
from lr2ppo_tpu.ops.int8 import quantize_kernel
from lr2ppo_torch.ops import int8 as tint8
from lr2ppo_torch.ops import int8_matmul as tk2
from lr2ppo_torch.ops.int8 import quantize_rows, quantize_weight
from test_torch_parallel import spawn

torch.set_num_threads(1)

GATES = ("INT8_MIN_KERNEL_ELEMENTS", "INT8_DYNQUANT_MIN_FLOPS",
         "INT8_DYNQUANT_MIN_WIDTH")
# the size gates a narrow site keeps: its width stays under
# INT8_DYNQUANT_MIN_WIDTH
NARROW_GATES = GATES[:2]
# the port's tp 2 gap may be this many times JAX's
GAP_RATIO = 2.0


def _xw(seed, rows, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, k).astype(np.float32),
            (rng.randn(n, k) * 0.05).astype(np.float32))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [(512, 128, 128), (700, 384, 256)])
def test_plain_tp_pair_is_k2s_plain_version(rows, k, n, in_dtype, out_dtype):
    """int8_dot_s32 then s32_epilogue on a CPU tensor (their plain
    versions) give int8_matmul_reference's bits: the same integer sums and
    the same (acc * sx) * sw rounded once."""
    x, w = _xw(rows + k, rows, k, n)
    xt = torch.from_numpy(x).to(in_dtype)
    q, s = quantize_weight(torch.from_numpy(w))
    xq, xs = quantize_rows(xt.float())
    acc = tk2.int8_dot_s32(xq, q)
    assert acc.dtype == torch.int32 and acc.shape == (rows, n)
    assert torch.equal(acc.double(), xq.double() @ q.double().t())
    y = tk2.s32_epilogue(acc, xs, s, out_dtype)
    assert torch.equal(y, tk2.int8_matmul_reference(xt, q, s, out_dtype))


def test_tp_pair_checks_its_operands():
    q = torch.zeros(128, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported"):
        tk2.int8_dot_s32(torch.zeros(511, 128, dtype=torch.int8), q)
    with pytest.raises(ValueError, match="int8"):
        tk2.int8_dot_s32(torch.zeros(512, 128), q)
    acc = torch.zeros(4, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="N % 4"):
        tk2.s32_epilogue(acc, torch.ones(4, 1), torch.ones(6))


# -- K2 at tp 2 over gloo --------------------------------------------------
ROWS, K, N = 512, 256, 128


def _k2_rank(rank, world, url, x, q, s, dtypes):
    """The row-split site on this rank's half of K, in each (in, out)
    dtype pair, through int8_linear and through a row-split int8 Linear;
    returns the outputs and the routes taken."""
    from lr2ppo_torch.models.layers import Linear
    from lr2ppo_torch.parallel import make_mesh, set_active
    from lr2ppo_torch.parallel.tp import tp_max

    for g in NARROW_GATES:
        setattr(tint8, g, 0)
    tint8.NARROW_SITES = True
    taken, real = [], tk2.int8_matmul_tp
    tk2.int8_matmul_tp = lambda *a, **kw: taken.append(1) or real(*a, **kw)
    mesh = make_mesh(1, 2)
    set_active(mesh)
    half = slice(rank * K // 2, (rank + 1) * K // 2)
    out = {}
    for idt, odt in dtypes:
        xt = torch.from_numpy(x).to(idt)
        out[(idt, odt)] = tint8.int8_linear(
            xt[:, half], q[:, half].contiguous(), s, odt, shape=(N, K),
            mesh=mesh)
    # the row scales rounded as XLA's CPU jit rounds JAX's (a reciprocal
    # multiply), which the Pallas kernel in interpret mode runs under
    recip = torch.tensor(np.float32(1.0) / np.float32(127.0))

    def quantize_rows_jit(xf, mesh):
        amax = tp_max(xf.abs().amax(dim=-1, keepdim=True), mesh)
        scale = torch.clamp_min(amax, 1e-8) * recip
        return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale

    plain = tk2.quantize_rows
    tk2.quantize_rows = quantize_rows_jit
    for idt, odt in dtypes:
        xt = torch.from_numpy(x).to(idt)
        out[("jit", idt, odt)] = tint8.int8_linear(
            xt[:, half], q[:, half].contiguous(), s, odt, shape=(N, K),
            mesh=mesh)
    tk2.quantize_rows = plain
    lin = Linear(K, N, bias=False, dtype=torch.bfloat16, int8=True)
    lin.load_state_dict({"weight": q, "weight_scale": s})
    lin.split_tp(1, mesh)
    with torch.no_grad():
        out["linear"] = lin(torch.from_numpy(x)[:, half])
    return {"y": out, "routes": len(taken)}


DTYPE_PAIRS = [(torch.float32, torch.float32),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16)]


def test_k2_at_tp2_is_k2_at_world_1_and_jax_global(tmp_path, monkeypatch):
    """Each tp rank quantizes its half of every row with the row's amax
    over tp, takes the int32 product of its half of K and sums the parts
    over tp: both ranks hold K2's world-1 result bit for bit, in every
    dtype pair. Against JAX's global int8_matmul (the Pallas kernel in
    interpret mode) the one difference is the row scale, which XLA's CPU
    jit rounds as amax * (1 / 127) (tests/test_torch_int8_matmul.py:
    test_bf16_gap_is_the_jit_reciprocal_scale): with the ranks' scales
    rounded so, the tp 2 route is JAX's result bit for bit."""
    x, w = _xw(3, ROWS, K, N)
    q, s = quantize_weight(torch.from_numpy(w))
    ranks = spawn(_k2_rank, 2, tmp_path, x, q, s, DTYPE_PAIRS)
    for g in NARROW_GATES:
        monkeypatch.setattr(jint8, g, 0)
    monkeypatch.setattr(jint8, "PALLAS_NARROW_SITES", True)
    jq, js = quantize_kernel(jnp.asarray(w.T))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for idt, odt in DTYPE_PAIRS:
        world1 = tk2.int8_matmul(torch.from_numpy(x).to(idt), q, s, odt)
        jy = np.asarray(jint8.int8_matmul(
            jnp.asarray(x).astype(jdt[idt]), jq, js, jdt[odt]), np.float32)
        for r in ranks:
            assert torch.equal(r["y"][(idt, odt)], world1), (idt, odt)
            np.testing.assert_array_equal(
                r["y"][("jit", idt, odt)].float().numpy(), jy)
    want = tk2.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), q, s,
                           torch.bfloat16)
    assert [r["routes"] for r in ranks] == [2 * len(DTYPE_PAIRS) + 1] * 2
    for r in ranks:
        assert torch.equal(r["y"]["linear"], want)


def test_a_shard_the_kernel_refuses_takes_the_dequant_route(monkeypatch):
    """K = 128 passes K2's gate globally, but its halves (64) do not: the
    row split then takes the dequant route, as JAX does for a global shape
    its gate refuses (the whole product summed over tp)."""
    from lr2ppo_torch.parallel.mesh import Mesh

    for g in NARROW_GATES:
        monkeypatch.setattr(tint8, g, 0)
    monkeypatch.setattr(tint8, "NARROW_SITES", True)
    called = []
    monkeypatch.setattr(tk2, "int8_matmul_tp",
                        lambda *a, **kw: called.append(1))
    monkeypatch.setattr("lr2ppo_torch.parallel.tp.reduce_from_tp",
                        lambda y, mesh: 2 * y)
    x, w = _xw(5, ROWS, 128, N)
    q, s = quantize_weight(torch.from_numpy(w))
    mesh = Mesh(tp=2)
    y = tint8.int8_linear(torch.from_numpy(x[:, :64]), q[:, :64], s,
                          torch.float32, shape=(N, 128), mesh=mesh)
    deq = (q[:, :64].float() * s[:, None]) @ torch.from_numpy(x[:, :64]).t()
    assert called == []
    torch.testing.assert_close(y, 2 * deq.t(), rtol=0, atol=0)


# -- C1: the tp 2 gaps of both packages ------------------------------------
FEAT, SEQ, IMGS, HEADS = 128, 8, 4, 4


def _serve_argv(ckpt, jp, out, tp):
    return ["--pretrained_model_path", ckpt, "--test_path", jp,
            "--ranking_path", out, "--family", "multimodal",
            "--feat_size", str(FEAT), "--seq_length", str(SEQ),
            "--num_heads", str(HEADS), "--max_imgs", str(IMGS),
            "--mode", "reg", "--compute_dtype", "bfloat16",
            "--batch_size", "8", "--item_dtype", "float32", "--int8", "true",
            "--dp", "1", "--tp", str(tp)]


def _port_serve_rank(rank, world, url, argv):
    from lr2ppo_torch.cli import serve

    for g in GATES:
        setattr(tint8, g, 0)
    extra = []
    if world > 1:
        extra = ["--distributed", "true", "--coordinator", url,
                 "--num_processes", str(world), "--process_id", str(rank)]
    serve.main(argv + extra, device="cpu")


def _scores(path):
    """{(item, tag): score} of a ranking file."""
    out = {}
    with open(path) as f:
        for ln in map(json.loads, f):
            for t, v in zip(ln["pred_order"], ln["pred_scores"]):
                out[(ln["id"], t)] = v
    return out


def _gap(got, want):
    """max |got - want| over the scores, over the spread of want's."""
    keys = sorted(want)
    assert sorted(got) == keys
    a = np.array([got[k] for k in keys])
    b = np.array([want[k] for k in keys])
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def c1_served(tmp_path_factory):
    """Both serve CLIs at tp 1 and tp 2 on one checkpoint and store, int8
    on with the size gates zeroed (every fusion Linear quantized; the
    row-split fc2 sites, narrow, take the dequant + bfloat16 route in both
    packages). Returns the gaps of tp 2 against tp 1, by package."""
    from lr2ppo_tpu.cli import serve as jserve
    from lr2ppo_torch.config import ModelConfig
    from lr2ppo_torch.models.scorer import ScoreModel
    from lr2ppo_torch.train.checkpoints import save_actor_critic

    tmp = tmp_path_factory.mktemp("c1_serve")
    jp, _ = make_movienet(tmp / "d", n_items=16, seq=SEQ, feat=FEAT,
                          n_imgs_range=(1, 4), seed=4)
    cfg = ModelConfig(feat_size=FEAT, seq_length=SEQ, max_imgs=IMGS,
                      visual_feat_dim=FEAT, num_heads=HEADS)
    model = ScoreModel(cfg)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-0.2, 0.2, generator=gen)
    ckpt = str(tmp / "actor.bin")
    save_actor_critic(ckpt, model, model)
    paths = {}
    saved = {g: getattr(jint8, g) for g in GATES}
    try:
        for g in GATES:
            setattr(jint8, g, 0)
        for tp in (1, 2):
            # world 1 is a one-device process, where JAX fuses the int8
            # FFN (K1; this process has eight host devices); a
            # multi-device program never does (ops/int8.py:
            # fused_ffn_enabled), nor does the port under tp
            jint8.PALLAS_FUSED_FFN = tp == 1
            paths[("jax", tp)] = str(tmp / f"jax_tp{tp}.jsonl")
            jserve.main(_serve_argv(ckpt, jp, paths[("jax", tp)], tp))
    finally:
        jint8.PALLAS_FUSED_FFN = None
        for g, v in saved.items():
            setattr(jint8, g, v)
    for tp in (1, 2):
        d = tmp / f"port_tp{tp}"
        d.mkdir()
        paths[("port", tp)] = str(d / "r.jsonl")
        spawn(_port_serve_rank, tp, d,
              _serve_argv(ckpt, jp, paths[("port", tp)], tp),
              join=tp > 1, timeout=150)
    s = {k: _scores(p) for k, p in paths.items()}
    return {"jax": _gap(s[("jax", 2)], s[("jax", 1)]),
            "port": _gap(s[("port", 2)], s[("port", 1)]),
            "across": _gap(s[("port", 1)], s[("jax", 1)])}


def test_served_scores_at_tp2_gap_like_jax(c1_served):
    """Served scores at tp 2 against world 1, as a share of the spread: the
    port's gap within GAP_RATIO of JAX's. Both gaps are the route, not the
    sums: world 1 fuses the int8 FFN (K1 quantizes the GELU hidden to int8)
    and tp 2 takes the unfused dequant route; with the fused FFN off at
    world 1 too, both packages serve tp 2 the world-1 scores exactly at
    this width."""
    g = c1_served
    print("C1 served gaps", g)
    assert g["jax"] > 0 and g["port"] > 0
    assert g["port"] <= GAP_RATIO * g["jax"], g


# one stage-3 rollout and update in bfloat16, dropout off
B, T, SEQ3, D3, IMGS3 = 8, 2, 8, 64, 2
LR = 1e-3
# leaves whose exact gradient is 0 (a softmax ignores a shift of its
# inputs): their steps are rounding noise in both packages, read not held
SHIFT_LEAVES = ("keys.bias", "head.bias", "out_layer.fc2.bias")


def _step_cfg(c):
    m = dataclasses.replace(c.model, feat_size=D3, seq_length=SEQ3,
                            max_imgs=IMGS3, visual_feat_dim=D3, num_heads=2,
                            drop_p=0.0, forward_drop_p=0.0)
    p = dataclasses.replace(c.ppo, update_timesteps=1)
    o = dataclasses.replace(c.optim, learning_rate=LR,
                            critic_learning_rate=LR, scheduler="constant")
    return c.replace(model=m, ppo=p, optim=o)


def _param_gap(got, want, init):
    """{leaf: (||got - want||, ||want - init||)} over the trained leaves."""
    out = {}
    for k, w in want.items():
        moved = float(np.linalg.norm(w - init[k]))
        if moved > 0 and not k.endswith(SHIFT_LEAVES):
            out[k] = (float(np.linalg.norm(got[k] - w)), moved)
    return out


def _port_step_rank(rank, world, url, sds, batch):
    from lr2ppo_torch.config import Config
    from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
    from lr2ppo_torch.parallel import make_mesh, set_active
    from lr2ppo_torch.train import ppo as tppo
    from lr2ppo_torch.train.common import DeviceCtx, init_state

    cfg = _step_cfg(Config())
    mesh = make_mesh(1, world)
    set_active(mesh)
    ctx = DeviceCtx("cpu", mesh=mesh)
    tm, dt = cfg.model, torch.bfloat16
    actor, critic = ScoreModel(tm, dt), SeqScoreModel(tm, dt)
    actor.load_state_dict(sds[0])
    critic.load_state_dict(sds[1])
    ctx.place(actor)
    ctx.place(critic)
    reward = tppo.frozen_copy(SeqScoreModel, tm, sds[2], dt, False, ctx)
    text, img, state = (torch.from_numpy(a) for a in batch)
    out = tppo.make_rollout_step(tm.mode)(actor, critic, reward, text, img,
                                          state)
    astate = init_state(actor, ctx.optimizer(cfg.optim, actor, 10, lr=LR))
    cstate = init_state(critic, ctx.optimizer(cfg.optim, critic, 10, lr=LR))
    tppo.make_update_step(cfg)(
        astate, cstate, torch.Generator().manual_seed(0), text, img, state,
        out[2], out[0], out[3], out[1])
    return {side: {k: v.float().numpy() for k, v in
                   ctx.full_state_dict(m).items()}
            for side, m in (("actor", actor), ("critic", critic))}


def _jax_step(params, batch, tp):
    """JAX's rollout and update in bfloat16 on a 1 x tp mesh of host
    devices (tp 1: one device): the parameters placed by the tp rules."""
    from lr2ppo_tpu.config import Config as JConfig
    from lr2ppo_tpu.models.scorer import ScoreModel as JScore
    from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
    from lr2ppo_tpu.train import ppo as jppo
    from lr2ppo_tpu.train.common import DeviceCtx as JCtx
    from lr2ppo_tpu.train.common import init_state as jinit_state
    from lr2ppo_tpu.train.optim import build_optimizer as jbuild
    from lr2ppo_torch.train.checkpoints import params_from_flax

    jcfg = _step_cfg(JConfig())
    mc, dt = jcfg.model, jnp.bfloat16
    ctx = JCtx(1, tp, enabled=tp > 1)
    # the update donates its states: give each run its own copies
    ap, cp, rp = (ctx.place_params(jax.tree.map(jnp.array, p))
                  for p in params)
    jt, ji, js = map(jnp.asarray, batch)
    out = jppo.make_rollout_step(JScore(mc, dt), JSeq(mc, dt), JSeq(mc, dt),
                                 mc.mode)(ap, cp, rp, jt, ji, js)
    atx = jbuild(jcfg.optim, 10, lr=LR)
    ctx_ = jbuild(jcfg.optim, 10, lr=LR)
    ja, jc, _ = jppo.make_update_step(JScore(mc, dt), JSeq(mc, dt), atx,
                                      ctx_, jcfg)(
        jinit_state(ap, atx), jinit_state(cp, ctx_), jax.random.PRNGKey(2),
        jt, ji, js, out[2], out[0], out[3], out[1])
    return {side: {k: v.float().numpy() for k, v in params_from_flax(
        jax.tree.map(np.array, st.params)).items()}
        for side, st in (("actor", ja), ("critic", jc))}


@pytest.fixture(scope="module")
def c1_stage3(tmp_path_factory):
    from lr2ppo_tpu.config import Config as JConfig
    from lr2ppo_tpu.models.scorer import ScoreModel as JScore
    from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
    from lr2ppo_torch.train.checkpoints import params_from_flax

    tmp = tmp_path_factory.mktemp("c1_stage3")
    mc = _step_cfg(JConfig()).model
    rng = np.random.RandomState(0)
    text = rng.randn(B, T, SEQ3, D3).astype(np.float32)
    img = rng.randn(B, IMGS3, D3).astype(np.float32)
    state = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jt, ji = jnp.asarray(text), jnp.asarray(img)
    ka, kc, kr = jax.random.split(jax.random.PRNGKey(1), 3)
    idx4 = jnp.zeros((B, 4), jnp.int32)
    params = (JScore(mc).init(ka, jt, ji), JSeq(mc).init(kc, jt, ji, idx4),
              JSeq(mc).init(kr, jt, ji, idx4))
    sds = [params_from_flax(jax.tree.map(np.array, t)) for t in params]
    # copies: the spawn moves sds's storage to shared memory, and a view
    # of the old storage would read freed memory
    init = {side: {k: v.float().numpy().copy() for k, v in sd.items()}
            for side, sd in (("actor", sds[0]), ("critic", sds[1]))}
    batch = (text, img, state)
    j1, j2 = _jax_step(params, batch, 1), _jax_step(params, batch, 2)
    p1 = spawn(_port_step_rank, 1, tmp, sds, batch, join=False)[0]
    p2 = spawn(_port_step_rank, 2, tmp, sds, batch, timeout=180)
    gaps = {}
    for side in ("actor", "critic"):
        for name, got, want in (("jax", j2, j1), ("port", p2[0], p1),
                                ("across", p1, j1)):
            gaps[(name, side)] = _param_gap(got[side], want[side],
                                            init[side])
    for k, v in p2[0]["actor"].items():
        assert np.array_equal(v, p2[1]["actor"][k]), k
    return gaps


def test_stage3_update_at_tp2_gaps_like_jax(c1_stage3):
    """One rollout and one update in bfloat16 at tp 2 against world 1, in
    each package, on each model: the port's param_gap, ||p - p_ref|| /
    ||p_ref - p_init||, within GAP_RATIO of JAX's over all the trained
    leaves at once and at the widest leaf (PR 9's reading)."""
    for side in ("actor", "critic"):
        whole, widest = {}, {}
        for name in ("jax", "port", "across"):
            parts = c1_stage3[(name, side)].values()
            whole[name] = (np.sqrt(sum(a * a for a, _ in parts))
                           / np.sqrt(sum(b * b for _, b in parts)))
            widest[name] = max(a / b for a, b in parts)
        print(f"C1 stage-3 {side}: param_gap whole / widest leaf: "
              + ", ".join(f"{n} {whole[n]:.4g} / {widest[n]:.4g}"
                          for n in whole))
        assert whole["jax"] > 0 and whole["port"] > 0
        assert whole["port"] <= GAP_RATIO * whole["jax"], (side, whole)
        assert widest["port"] <= GAP_RATIO * widest["jax"], (side, widest)
