"""lr2ppo_torch.ops.losses against lr2ppo_tpu.ops.losses at float32, on the
same numpy inputs: exact, or within 1e-6 where the two frameworks' kernels
sum or exponentiate in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.ops import losses as jl
from lr2ppo_torch.ops import losses as tl

torch.set_num_threads(1)


def _both(fn, *arrays, **kw):
    ref = np.asarray(getattr(jl, fn)(*map(jnp.asarray, arrays), **kw))
    got = getattr(tl, fn)(*map(torch.from_numpy, arrays), **kw).numpy()
    assert got.shape == ref.shape
    return got, ref


def _rng(seed):
    return np.random.RandomState(seed)


def test_safe_log_clamps_at_1e_20():
    t = np.asarray([0.0, 1e-30, 1e-20, 0.5, 3.0], np.float32)
    got, ref = _both("safe_log", t)
    np.testing.assert_array_equal(got, ref)


def test_smooth_l1_nll_reward_pair_log_sig():
    rng = _rng(0)
    pred = rng.randn(40).astype(np.float32)
    tgt = rng.randint(0, 3, size=40).astype(np.int32)
    np.testing.assert_allclose(*_both("smooth_l1_loss", pred, tgt, beta=0.3),
                               rtol=1e-6)
    logits = rng.randn(10, 3).astype(np.float32)
    np.testing.assert_allclose(
        *_both("nll_3way_loss", logits, tgt[:10].astype(np.int64)), rtol=1e-6)
    a, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    for margin in (1.0, 0.01):
        np.testing.assert_allclose(
            *_both("reward_pair_hinge_loss", a, b, margin=margin), rtol=1e-6)
    np.testing.assert_allclose(*_both("log_sig_loss", a, b), rtol=1e-6)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("margin", [0.01, 1.0])
def test_rank_hinge_averages_over_violating_pairs(k, margin):
    """The count is the batch's number of violating pairs, not a per-row
    one; with every pair satisfied the loss is 0."""
    rng = _rng(2)
    scores = rng.randn(6, k).astype(np.float32)
    idx = np.stack([rng.permutation(k) for _ in range(6)]).astype(np.int32)
    got, ref = _both("rank_hinge_loss", scores, idx, margin=margin)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    ordered = np.argsort(-scores, axis=1).astype(np.int32)
    far = scores * 100.0
    got, ref = _both("rank_hinge_loss", far, ordered, margin=margin)
    assert got == ref == 0.0


def test_clipped_value_loss():
    rng = _rng(3)
    v, old = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    r = rng.randn(32).astype(np.float32)
    np.testing.assert_allclose(*_both("clipped_value_loss", v, r, old,
                                      clip=0.5), rtol=1e-6)


def test_kl_entropy_expected_scores():
    rng = _rng(4)
    old = rng.randn(8, 2).astype(np.float32) * 3
    new = rng.randn(8, 2).astype(np.float32) * 3
    new[0] = [60.0, -60.0]                 # a probability below the clamp
    got, ref = _both("categorical_kl", old, new)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    got, ref = _both("categorical_entropy", new)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    logits = rng.randn(4, 5, 3).astype(np.float32)
    np.testing.assert_allclose(*_both("cls_expected_scores", logits),
                               rtol=1e-6)


def test_pl_log_prob():
    rng = _rng(5)
    scores = rng.randn(6, 4).astype(np.float32)
    order = np.stack([rng.permutation(4)[:3] for _ in range(6)]).astype(
        np.int32)
    got, ref = _both("pl_log_prob", scores, order)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_gae_advantages():
    rng = _rng(6)
    rewards = rng.randn(5, 3).astype(np.float32)
    values = rng.randn(5, 3).astype(np.float32)
    cont = np.asarray([1, 1, 0, 1, 0], np.float32)
    ref = jl.gae_advantages(jnp.asarray(rewards), jnp.asarray(values),
                            jnp.asarray(cont), 0.99, 0.95)
    got = tl.gae_advantages(torch.from_numpy(rewards),
                            torch.from_numpy(values), torch.from_numpy(cont),
                            0.99, 0.95)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
