"""The pretraining path's small pieces against the JAX package, on the CPU:
the port's Adafactor against optax.adafactor (the JAX package's
--optimizer adafactor) over 5 steps, factored and unfactored parameters;
packed-bits fast dropout (its keep share, scale, saved tensors and
backward, and JAX's quantized keep share); and hash dropout's input contract
after its wrapper was trimmed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lr2ppo_tpu.config import OptimConfig
from lr2ppo_tpu.ops.fast_dropout import packed_dropout as jpacked
from lr2ppo_tpu.train.optim import build_optimizer as jbuild
from lr2ppo_torch.config import OptimConfig as TOptimConfig
from lr2ppo_torch.ops import fast_dropout as tfd
from lr2ppo_torch.ops import hash_dropout as thd
from lr2ppo_torch.train import optim as topt

torch.set_num_threads(1)

# factored: both of the two largest dims >= 128 (either order); not: a
# 64 x 32 matrix, a vector, a 3-d tensor with one large dim; "zero" starts
# at 0, so its update takes the 1e-3 floor of the parameter scale
SHAPES = {"big": (256, 160), "tall": (130, 300), "cube": (3, 200, 128),
          "small": (64, 32), "vec": (50,), "flat3": (2, 3, 400),
          "zero": (40,)}
STEPS, TRAIN_STEPS, LR = 5, 10, 1e-2


def _inputs():
    rng = np.random.RandomState(0)
    params = {k: (np.zeros(s, np.float32) if k == "zero"
                  else rng.randn(*s).astype(np.float32))
              for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * (0.1 + i)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(STEPS)]
    return params, grads


def _port_run(params, grads, scheduler, start=None):
    named = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params.items()}
    cfg = dataclasses.replace(TOptimConfig(), optimizer="adafactor",
                              learning_rate=LR, scheduler=scheduler)
    opt = topt.build_optimizer(cfg, named, TRAIN_STEPS)
    if start is not None:
        opt.load_state_dict(start)
    for g in grads:
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        opt.zero_grad()
    return {k: p.detach().numpy() for k, p in named.items()}, opt


@pytest.mark.parametrize("scheduler", ["linear", "constant"])
def test_adafactor_matches_optax(scheduler):
    """Each parameter after 5 steps within 1e-6 of its tensor's scale."""
    assert topt.Adafactor.factored_dims(SHAPES["big"]) == (1, 0)
    assert topt.Adafactor.factored_dims(SHAPES["tall"]) == (0, 1)
    assert topt.Adafactor.factored_dims(SHAPES["cube"]) == (2, 1)
    for k in ("small", "vec", "flat3", "zero"):
        assert topt.Adafactor.factored_dims(SHAPES[k]) is None
    params, grads = _inputs()
    tx = jbuild(dataclasses.replace(OptimConfig(), optimizer="adafactor",
                                    learning_rate=LR, scheduler=scheduler),
                TRAIN_STEPS)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    got, opt = _port_run(params, grads, scheduler)
    assert opt.count == STEPS
    for k, want in jp.items():
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
        assert not np.array_equal(got[k], params[k]), k


def test_adafactor_state_dict_round_trip_continues_the_trajectory():
    """The .state resume: statistics and count into a fresh optimizer give
    the uninterrupted trajectory bit for bit; other parameters are
    refused."""
    params, grads = _inputs()
    whole, _ = _port_run(params, grads, "linear")
    mid, opt = _port_run(params, grads[:2], "linear")
    state = {k: (v if k == "count" else {n: t.clone() for n, t in v.items()})
             for k, v in opt.state_dict().items()}
    assert set(state["v_row"]) == {"big", "tall", "cube"}
    assert set(state["v"]) == {"small", "vec", "flat3", "zero"}
    rest, _ = _port_run(mid, grads[2:], "linear", start=state)
    for k in whole:
        np.testing.assert_array_equal(rest[k], whole[k])
    other = topt.Adafactor({"w": torch.nn.Parameter(torch.zeros(3))},
                           lambda t: 1.0)
    with pytest.raises(KeyError, match="other parameters"):
        other.load_state_dict(state)


def test_fast_dropout_keep_share_and_scale():
    """Keep share within 5 sigma of threshold / 256 (230/256 at rate 0.1),
    kept values scaled by 256 / threshold; JAX's packed dropout keeps the
    same quantized share."""
    n = 400_003
    x = torch.ones(n)
    y = tfd.packed_dropout(x, 12345, 0.1)
    thr = tfd.keep_threshold(0.1)
    assert thr == 230
    keep = thr / 256.0
    sigma = (keep * (1 - keep) / n) ** 0.5
    share = float((y != 0).float().mean())
    assert abs(share - keep) < 5 * sigma
    assert torch.equal(torch.unique(y[y != 0]),
                       torch.tensor([1.0 / keep]))
    jy = np.asarray(jpacked(jnp.ones(n), jax.random.PRNGKey(0), 0.1))
    assert abs(float((jy != 0).mean()) - keep) < 5 * sigma
    # the seed decides the mask; another seed draws another one
    assert torch.equal(y, tfd.packed_dropout(x, 12345, 0.1))
    assert not torch.equal(y, tfd.packed_dropout(x, 12346, 0.1))
    assert tfd.packed_dropout(x, 1, 0.0) is x


def test_fast_dropout_saves_no_mask_and_backward_applies_its_mask():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(37, 41).astype(np.float32) + 5.0)
    g = torch.from_numpy(rng.randn(37, 41).astype(np.float32) + 5.0)
    packed = []
    xr = x.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        y = tfd.packed_dropout(xr, -77, 0.25)
    assert packed == []
    y.backward(g)
    assert torch.equal(xr.grad, tfd.packed_dropout(g, -77, 0.25))
    assert torch.equal(xr.grad == 0, y.detach() == 0)
    assert bool((y == 0).any()) and bool((y != 0).any())


def test_module_dropout_fast_draws_a_seed_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(64, 64)
    y = thd.module_dropout(x, 0.1, False, gen, False, True)
    seed = thd.draw_seed(torch.Generator().manual_seed(3))
    assert torch.equal(y, tfd.packed_dropout(x, seed, 0.1))


def test_hash_dropout_wrapper_keeps_its_contract():
    """The trimmed wrapper: scale and threshold cached per (rate, dtype);
    a CPU tensor takes the plain version, and the launcher refuses a tensor
    that is not on a CUDA device or not float32/bfloat16."""
    assert thd.scale_for(0.1, torch.bfloat16) == 1.109375
    assert thd.scale_for(0.1, torch.bfloat16) == 1.109375
    assert thd.scale_for.cache_info().hits >= 1
    x = torch.randn(5, 7)
    before = thd.hash_dropout.launches
    y = thd.hash_dropout(x, 3, 0.1)
    assert thd.hash_dropout.launches == before
    assert torch.equal(y, thd.hash_dropout_reference(x, 3, 0.1))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        thd.launch_elementwise("hash_dropout", x, 1, 2, 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        thd.check_elementwise(x.to(torch.float64), "hash_dropout")
