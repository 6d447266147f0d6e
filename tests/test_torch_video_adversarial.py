"""The remainder, the port against the JAX package on the CPU: quick_gelu,
VideoTransformer and ProjectionLayer from the JAX modules' weights through
`video_params_from_flax` (the reference's key layout), and FGM, PGD and the
clean + adversarial gradient on the same trees (JAX's nested dicts, the
port's named tensors)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lr2ppo_tpu.models import video as jvideo
from lr2ppo_tpu.ops import adversarial as jadv
from lr2ppo_torch.models.video import (ProjectionLayer, VideoTransformer,
                                       quick_gelu, video_params_from_flax)
from lr2ppo_torch.ops.adversarial import (adversarial_grads, fgm_perturb,
                                          pgd_perturb)

torch.set_num_threads(1)

# float32 products and norms summed in other orders: each output within
# RTOL of its tensor's largest magnitude
RTOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * max(float(np.abs(want).max()),
                                               1e-30))


def test_quick_gelu_is_jaxs():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(quick_gelu(torch.from_numpy(x)), jvideo.quick_gelu(jnp.asarray(x)))


@pytest.mark.parametrize("layers,heads", [(2, 4), (1, 2)])
def test_video_transformer_matches_jax(layers, heads):
    frame, d, out_dim = 5, 16, 8
    x = np.random.default_rng(0).standard_normal((3, frame, d)).astype(
        np.float32)
    jm = jvideo.VideoTransformer(frame, d, layers, heads, out_dim)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                              jnp.asarray(x)))
    model = VideoTransformer(frame, d, layers, heads, out_dim)
    model.load_state_dict(video_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (3, frame + 1, out_dim)
    _close(got, jm.apply(params, jnp.asarray(x)))
    # the reference's (nn.MultiheadAttention) keys
    assert "transformer.resblocks.0.attn.in_proj_weight" in \
        model.state_dict()
    seeded = VideoTransformer(frame, d, layers, heads, out_dim)
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.isfinite(seeded(torch.from_numpy(x))).all()


def test_projection_layer_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 7, 12)).astype(
        np.float32)
    jm = jvideo.ProjectionLayer(projection_dim=16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                              jnp.asarray(x)))
    model = ProjectionLayer(12, 16)
    model.load_state_dict(video_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        dropped = model(torch.from_numpy(x), deterministic=False,
                        generator=torch.Generator().manual_seed(0))
    _close(got, jm.apply(params, jnp.asarray(x), deterministic=True))
    assert not torch.equal(dropped, got)


def _trees(seed=0):
    """JAX's nested tree and the port's named tensors of the same values:
    two embedding leaves and two others."""
    rng = np.random.default_rng(seed)
    nested = {"embedding": {"word": rng.standard_normal((4, 3)),
                            "pos": rng.standard_normal((5, 3))},
              "encoder": {"kernel": rng.standard_normal((3, 3))},
              "head": {"w": rng.standard_normal((3,))}}
    nested = jax.tree.map(lambda a: a.astype(np.float32), nested)
    flat = {f"{a}.{b}": torch.from_numpy(v.copy())
            for a, sub in nested.items() for b, v in sub.items()}
    return jax.tree.map(jnp.asarray, nested), flat


def _flat(tree):
    return {f"{a}.{b}": np.asarray(v) for a, sub in tree.items()
            for b, v in sub.items()}


def _held(got, want_tree):
    want = _flat(want_tree)
    assert got.keys() == want.keys()
    for k, v in want.items():
        _close(got[k], v)


def test_fgm_and_pgd_perturb_like_jax():
    jp, tp = _trees(0)
    jg, tg = _trees(1)
    _held(fgm_perturb(tp, tg, 0.5), jadv.fgm_perturb(jp, jg, 0.5))
    cur_j, cur_t = jp, tp
    for _ in range(4):
        cur_j = jadv.pgd_perturb(cur_j, jp, jg, 0.2, 0.3)
        cur_t = pgd_perturb(cur_t, tp, tg, 0.2, 0.3)
        _held(cur_t, cur_j)
    delta = cur_t["embedding.word"] - tp["embedding.word"]
    assert float(torch.linalg.vector_norm(delta)) <= 0.2 + 1e-6
    assert torch.equal(cur_t["head.w"], tp["head.w"])


def test_a_zero_or_nan_gradient_leaves_the_leaf_alone():
    jp, tp = _trees(0)
    jg, tg = _trees(1)
    tg["embedding.word"] = torch.zeros_like(tg["embedding.word"])
    tg["embedding.pos"] = torch.full_like(tg["embedding.pos"], float("nan"))
    jg = {**jg, "embedding": {"word": jnp.zeros((4, 3)),
                              "pos": jnp.full((5, 3), jnp.nan)}}
    got = fgm_perturb(tp, tg, 0.5)
    assert torch.equal(got["embedding.word"], tp["embedding.word"])
    assert torch.equal(got["embedding.pos"], tp["embedding.pos"])
    _held(got, jadv.fgm_perturb(jp, jg, 0.5))
    _held(pgd_perturb(tp, tp, tg), jadv.pgd_perturb(jp, jp, jg))


@pytest.mark.parametrize("mode", ["fgm", "pgd"])
def test_adversarial_grads_match_jax(mode):
    """The clean loss and the clean + adversarial gradient of a loss that
    reads every leaf non-linearly."""
    jp, tp = _trees(2)
    x = np.random.default_rng(3).standard_normal((2, 3)).astype(np.float32)

    def jloss(p):
        h = jnp.tanh(jnp.asarray(x) @ p["encoder"]["kernel"]
                     + p["embedding"]["word"][:2])
        return (jnp.sum(h * p["head"]["w"]) ** 2
                + jnp.sum(p["embedding"]["pos"] ** 3))

    def tloss(p):
        h = torch.tanh(torch.from_numpy(x) @ p["encoder.kernel"]
                       + p["embedding.word"][:2])
        return (torch.sum(h * p["head.w"]) ** 2
                + torch.sum(p["embedding.pos"] ** 3))

    kw = dict(epsilon=0.1, alpha=0.05, pgd_k=3)
    want_loss, want = jadv.adversarial_grads(jloss, jp, mode, **kw)
    got_loss, got = adversarial_grads(tloss, tp, mode, **kw)
    _close(got_loss, want_loss)
    _held(got, want)
    with pytest.raises(ValueError, match="unknown adversarial mode"):
        adversarial_grads(tloss, tp, "bogus")
