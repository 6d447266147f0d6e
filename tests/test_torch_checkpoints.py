"""The weight bridge: lr2ppo_torch.train.checkpoints against the JAX
package's key map, and its loader on checkpoints the JAX package writes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.config import ModelConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.train import checkpoints as jck
from lr2ppo_torch.models.scorer import ScoreModel
from lr2ppo_torch.train.checkpoints import load_any, params_from_flax

torch.set_num_threads(1)

CFG = ModelConfig(feat_size=32, seq_length=6, max_imgs=2, visual_feat_dim=32,
                  num_heads=4)


@pytest.fixture(scope="module")
def flax_params():
    text = jnp.zeros((1, 2, CFG.seq_length, CFG.feat_size))
    img = jnp.zeros((1, CFG.max_imgs, CFG.feat_size))
    params = JScore(CFG).init(jax.random.PRNGKey(0), text, img)
    return jax.tree.map(np.asarray, params)


def _assert_same(sd, ref):
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert isinstance(sd[k], torch.Tensor)
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)


def test_params_from_flax_matches_flax_to_torch(flax_params):
    """Key for key and bit for bit, and the port's module takes it strict."""
    sd = params_from_flax(flax_params)
    _assert_same(sd, jck.flax_to_torch(flax_params))
    assert "xit.0.0.0.fn.1.queries.weight" in sd
    assert "xit.0.0.1.fn.1.3.weight" in sd
    model = ScoreModel(CFG)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)


def test_params_from_flax_copies(flax_params):
    sd = params_from_flax(flax_params)
    sd["head.bias"].add_(1.0)
    assert not np.array_equal(sd["head.bias"].numpy(),
                              flax_params["params"]["head"]["bias"])


def test_load_any_reads_a_jax_pickle(tmp_path, flax_params):
    path = str(tmp_path / "best.ckpt")
    jck.save_checkpoint(path, {"actor": flax_params}, {"step": 3})
    tree = load_any(path, kind="actor_critic")
    assert set(tree) == {"actor"}
    _assert_same(tree["actor"], jck.flax_to_torch(flax_params))
    single = str(tmp_path / "single.ckpt")
    jck.save_checkpoint(single, flax_params)
    _assert_same(load_any(single), jck.flax_to_torch(flax_params))


def test_load_any_reads_a_reference_bin(tmp_path, flax_params):
    path = str(tmp_path / "model.bin")
    jck.save_torch_compatible(path, flax_params)
    sd = load_any(path)
    _assert_same(sd, jck.flax_to_torch(flax_params))
    ScoreModel(CFG).load_state_dict(sd, strict=True)
    # an ActorCritic .bin splits on its prefixes
    ac = str(tmp_path / "ac.bin")
    torch.save({**{f"actor.{k}": v for k, v in sd.items()},
                **{f"critic.{k}": v for k, v in sd.items()}}, ac)
    both = load_any(ac, kind="actor_critic")
    _assert_same(both["actor"], sd)
    _assert_same(both["critic"], sd)


def test_load_any_refuses_an_orbax_directory(tmp_path, flax_params):
    """An orbax directory the JAX package wrote (its 'orbax' backend) is
    refused with a message that names the JAX package."""
    path = str(tmp_path / "best")
    jck.save_checkpoint(path, flax_params, backend="orbax")
    with pytest.raises(ValueError, match="orbax.*JAX package"):
        load_any(path)
