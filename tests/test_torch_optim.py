"""The port's AdamW and schedules against the JAX package's optax chain
(lr2ppo_tpu/train/optim.py:build_optimizer): an N-step parameter trajectory
from the same parameters and gradients, for all 8 schedules, float32 and
bfloat16 moments, with and without the global-norm clip, ticked once per
2 steps as the PPO trainer ticks them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lr2ppo_tpu.config import OptimConfig
from lr2ppo_tpu.train.optim import build_optimizer as jbuild
from lr2ppo_torch.config import OptimConfig as TOptimConfig
from lr2ppo_torch.train import optim as topt

torch.set_num_threads(1)

SCHEDULES = ["linear", "cosine", "constant", "constant_with_warmup",
             "inverse_sqrt", "polynomial", "cosine_with_restarts",
             "tri_stage"]
SHAPES = {"fc.weight": (5, 4), "fc.bias": (5,), "ln.weight": (4,)}
STEPS, TRAIN_STEPS, LR = 7, 8, 1e-2


def _flax(tree):
    """torch names -> a flax-style tree whose leaf names carry the decay
    mask the same way ('bias' is exempt; kernel and scale decay)."""
    return {"fc": {"kernel": tree["fc.weight"], "bias": tree["fc.bias"]},
            "ln": {"scale": tree["ln.weight"]}}


def _inputs():
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for t in range(STEPS):
        g = {k: (rng.randn(*s) * 10.0 ** rng.randint(-3, 2)).astype(
            np.float32) for k, s in SHAPES.items()}
        g["fc.weight"][0, :2] = [0.0, 1e-7]      # zero and tiny entries
        grads.append(g)
    return params, grads


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("moments", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_adamw_trajectory_matches_optax(schedule, moments, clip):
    """Tolerance: float32 moments agree to float32 rounding (1e-6 absolute,
    a few ulps of parameters of order 1; measured 1.2e-7). bfloat16 moments round to 8 bits of mantissa, and a value
    the two frameworks compute one float32 ulp apart can round to the
    neighbouring bfloat16: that moves m or v by 2^-8 relative, and a step
    by up to ~0.4% of lr; over the trajectory the bound is 0.02 * lr."""
    params, grads = _inputs()
    kw = dict(scheduler=schedule, warmup=0.3, grad_clip=clip,
              moment_dtype=moments, learning_rate=LR)
    jcfg = dataclasses.replace(OptimConfig(), **kw)
    tcfg = dataclasses.replace(TOptimConfig(), **kw)

    def wrap(s):
        return lambda t: s(t // 2)

    tx = jbuild(jcfg, TRAIN_STEPS, schedule_wrap=wrap)
    jp = jax.tree.map(jnp.asarray, _flax(params))
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = topt.build_optimizer(tcfg, tp, TRAIN_STEPS, schedule_wrap=wrap)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, _flax(g)), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        opt.zero_grad()
    assert opt.count == STEPS
    ref = {"fc.weight": jp["fc"]["kernel"], "fc.bias": jp["fc"]["bias"],
           "ln.weight": jp["ln"]["scale"]}
    # the worst case, a sign flip of a near-zero gradient's first
    # step (+-3.16 lr each way, ~7 lr), does not arise: both sides get
    # the same gradients; the bounds below hold with room
    tol = 1e-6 if moments is None else 0.02 * LR
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)
    moved = max(float((p.detach() - torch.from_numpy(params[k])).abs().max())
                for k, p in tp.items())
    assert moved > LR        # the parameters did move


def test_first_step_without_bias_correction():
    """correct_bias=False: the first step is lr * m/(sqrt(v)+eps) with
    m = 0.1 g, v = 0.001 g^2, about 3.16 * lr * sign(g), and the decay
    skips the bias."""
    p = {"w.weight": torch.nn.Parameter(torch.zeros(3)),
         "w.bias": torch.nn.Parameter(torch.ones(3))}
    opt = topt.AdamW(p, lambda t: 0.1, weight_decay=0.5)
    p["w.weight"].grad = torch.tensor([2.0, -3.0, 0.0])
    p["w.bias"].grad = torch.tensor([1.0, 1.0, 1.0])
    opt.step()
    step = 0.1 * 0.1 / (0.001 ** 0.5)      # lr * 3.16
    np.testing.assert_allclose(p["w.weight"].detach().numpy(),
                               [-step, step, 0.0], rtol=1e-4)
    np.testing.assert_allclose(p["w.bias"].detach().numpy(),
                               1.0 - step, rtol=1e-4)
    assert topt.decays("xit.1.0.weight") and topt.decays("pos_emb.weight")
    assert not topt.decays("head.bias")


def test_adafactor_and_unknown_schedules_raise():
    """--optimizer adafactor builds the port's Adafactor (held against
    optax in tests/test_torch_pretrain_optim.py); an unknown schedule
    raises."""
    p = {"w.weight": torch.nn.Parameter(torch.zeros(2))}
    opt = topt.build_optimizer(dataclasses.replace(TOptimConfig(),
                                                   optimizer="adafactor"),
                               p, 4)
    assert isinstance(opt, topt.Adafactor)
    with pytest.raises(ValueError, match="scheduler"):
        topt.make_schedule("wavy", 1.0, 4, 0.1)


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_state_dict_round_trip_continues_the_trajectory(moments):
    """AdamW.state_dict() into a fresh optimizer (the .state resume): the
    moments keep their dtype, and the next steps equal the uninterrupted
    optimizer's bit for bit."""
    params, grads = _inputs()
    cfg = dataclasses.replace(TOptimConfig(), learning_rate=LR,
                              scheduler="linear", moment_dtype=moments)

    def make(values):
        named = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                 for k, v in values.items()}
        return named, topt.build_optimizer(cfg, named, TRAIN_STEPS)

    def step(named, opt, g):
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        opt.zero_grad()

    named, opt = make(params)
    for g in grads[:3]:
        step(named, opt, g)
    saved = {k: v.clone() for k, v in opt.state_dict()["mu"].items()}
    state = opt.state_dict()
    named2, opt2 = make({k: p.detach().numpy() for k, p in named.items()})
    opt2.load_state_dict(state)
    assert opt2.count == 3
    for k, v in opt2.mu.items():
        assert v.dtype == saved[k].dtype and torch.equal(v, saved[k])
    for g in grads[3:]:
        step(named, opt, g)
        step(named2, opt2, g)
    for k in named:
        assert torch.equal(named[k], named2[k])


def test_load_state_dict_refuses_other_parameters():
    params, _ = _inputs()
    named = {k: torch.nn.Parameter(torch.from_numpy(v))
             for k, v in params.items()}
    opt = topt.build_optimizer(TOptimConfig(), named, TRAIN_STEPS)
    state = opt.state_dict()
    other = {k: v for k, v in state["mu"].items() if k != "fc.bias"}
    with pytest.raises(KeyError, match="fc.bias"):
        opt.load_state_dict({**state, "mu": other})
    wrong = {**state["nu"], "fc.bias": torch.zeros(3)}
    with pytest.raises(ValueError, match="fc.bias"):
        opt.load_state_dict({**state, "nu": wrong})


def test_cpu_tensors_take_the_plain_version_and_are_counted():
    """On the CPU every tensor takes the plain version (no launch): while a
    profiler records, `optim.plain_tensors` counts each tensor a step and
    `optim.kernel_tensors` none; the parameters equal adamw_reference's,
    one tensor without a gradient among them."""
    from lr2ppo_torch.ops import adamw as ops
    from lr2ppo_torch.utils import counters

    params, grads = _inputs()
    named = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params.items()}
    plain = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in plain.items()}
    opt = topt.AdamW(named, lambda t: LR, grad_clip=0.5)
    launches = ops.adamw.launches
    for g in grads[:3]:
        for k, p in named.items():
            p.grad = None if k == "ln.weight" else torch.from_numpy(g[k])
        seen = counters()
        with torch.profiler.profile():
            opt.step()
        got = counters()
        assert got["optim.plain_tensors"] - seen.get(
            "optim.plain_tensors", 0) == len(named)
        assert got.get("optim.kernel_tensors", 0) == seen.get(
            "optim.kernel_tensors", 0)
        norm = torch.sqrt(sum(torch.sum(torch.square(torch.from_numpy(
            g[k]))) for k in ("fc.weight", "fc.bias")))
        for k, p in plain.items():
            ops.adamw_reference(p, None if k == "ln.weight"
                                else torch.from_numpy(g[k]), *moments[k], LR,
                                0.9, 0.999, 1e-6,
                                0.0 if k == "fc.bias" else 0.01, 1.0, norm,
                                0.5)
    assert ops.adamw.launches == launches
    for k, p in named.items():
        assert torch.equal(p.detach(), plain[k]), k
        assert torch.equal(opt.mu[k], moments[k][0]), k


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel: where the
    kernel's library cannot be loaded, step raises, and the plain version
    is never called (here on the meta device, as this machine may have no
    card)."""
    from lr2ppo_torch.kernels import build
    from lr2ppo_torch.ops import adamw as ops

    def no_library(entry):
        raise RuntimeError(f"no library for {entry}")

    def plain(*a, **k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(build, "function", no_library)
    monkeypatch.setattr(ops, "adamw_reference", plain)
    p = {"w.weight": torch.nn.Parameter(torch.zeros(4, 3, device="meta"))}
    p["w.weight"].grad = torch.ones(4, 3, device="meta")
    opt = topt.AdamW(p, lambda t: LR)
    with pytest.raises(RuntimeError, match="lr2ppo_adamw"):
        opt.step()


def _strided(shape, view):
    return view(torch.zeros(shape))


@pytest.mark.parametrize("shape,view,want", [
    ((5, 4), lambda t: t, (1, 20, 20)),
    ((), lambda t: t, (1, 1, 1)),
    ((1, 7, 1), lambda t: t, (1, 7, 7)),
    # zero1 slices (mesh.shard_slice): along dim 1 rows of the slice's
    # width at the parameter's row stride, along dim 0 one row
    ((48, 1000), lambda t: t.narrow(1, 250, 250), (48, 250, 1000)),
    ((4, 64, 24), lambda t: t.narrow(1, 16, 16), (4, 384, 1536)),
    ((40, 36), lambda t: t.narrow(0, 10, 10), (1, 360, 360)),
    ((4099,), lambda t: t[3:], (1, 4096, 4096)),
], ids=["contiguous", "scalar", "unit_dims", "zero1_dim1", "zero1_3d",
        "zero1_dim0", "offset_view"])
def test_plane_lays_out_the_kernels_rows(shape, view, want):
    """ops/adamw.py:plane, the layout the kernel takes: each tensor as rows
    of contiguous values with its own row stride. A view and the
    contiguous moments of its shape share rows and columns and keep their
    own strides."""
    from lr2ppo_torch.ops.adamw import plane

    p = _strided(shape, view)
    m = torch.zeros_like(p, memory_format=torch.contiguous_format)
    rows, cols, strides = plane(p, p, m, m)
    assert (rows, cols, strides[0]) == want
    if rows > 1:
        assert strides[2] == strides[3] == cols


@pytest.mark.parametrize("shape,view", [
    ((6, 6), lambda t: t.t()), ((6, 6), lambda t: t[:, ::2]),
    ((4, 6, 6), lambda t: t[:, :3, :3])],
    ids=["transposed", "strided_columns", "two_row_strides"])
def test_plane_refuses_what_the_kernel_does_not_take(shape, view):
    from lr2ppo_torch.ops.adamw import plane

    p = _strided(shape, view)
    with pytest.raises(ValueError, match="layout"):
        plane(p, torch.zeros_like(p, memory_format=torch.contiguous_format))
