"""AdamW's weight-decay mask against the JAX package's `decay_mask`, key for
key: JAX's mask (True where the flax leaf is not named `bias`) is carried
through the weight bridge as arrays of its leaves' shapes, and every port key
must decay exactly where its bridged mask does. The tower zoo of
tests/test_torch_encoders.py (the RNN family, the bi-stacks, the gated CNN,
whose convolution biases JAX names `<conv>_b`), the dual clip tower, T5 and
the Transformer base (mt), the masked_patch, word_patch and speech
embeddings (the speech convolutions' biases are `conv_<i>_bias` in JAX), and
the multimodal ScoreModel and SeqScoreModel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.config import ModelConfig as JModelConfig
from lr2ppo_tpu.models.scorer import ScoreModel as JScore
from lr2ppo_tpu.models.scorer import SeqScoreModel as JSeq
from lr2ppo_tpu.towers import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_tpu.train.optim import decay_mask
from lr2ppo_torch.config import ModelConfig
from lr2ppo_torch.models.scorer import ScoreModel, SeqScoreModel
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 tower_params_from_flax)
from lr2ppo_torch.train.checkpoints import params_from_flax
from lr2ppo_torch.train.optim import decays, no_decay_names
from test_torch_encoders import (ENCODERS, _dual_inputs, _inputs, dual_raw,
                                 raw_cfg)
from test_torch_seq2seq import _batch as seq2seq_batch
from test_torch_seq2seq import mt_raw
from test_torch_seq2seq_parallel import t5_raw
from test_torch_vision_speech import CASES as EMBEDDING_CASES
from test_torch_vision_speech import _embedding_case

torch.set_num_threads(1)


def _shapes(module, *args):
    """A flax module's param tree as shapes only (no compile)."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)


def _mask_arrays(params):
    """JAX's decay_mask of a param tree as bool arrays of the leaves'
    shapes, so the bridge's reshapes carry it to the port's keys."""
    return jax.tree.map(lambda p, m: np.full(p.shape, bool(m)),
                        params, decay_mask(params))


def _check(model, bridged: dict, prefix: str = ""):
    """Every parameter of `model` decays where its bridged JAX mask says."""
    no_decay = no_decay_names(model)
    names = [k for k, _ in model.named_parameters()]
    assert sorted(names) == sorted(k[len(prefix):] for k in bridged)
    for k in names:
        want = bridged[prefix + k].numpy()
        assert want.all() or not want.any(), k
        assert decays(k, no_decay) == bool(want.all()), k


def _tower_cases():
    cases = {f"{name}_lm": ("tower", raw_cfg(**kw)) for name, kw in
             ENCODERS.items()}
    cases["clip_untied"] = ("dual", dual_raw(False))
    cases["clip_tied"] = ("dual", dual_raw(True))
    cases["t5"] = ("seq2seq", t5_raw())
    cases["mt"] = ("seq2seq", mt_raw())
    return cases


TOWERS = _tower_cases()


@pytest.mark.parametrize("case", sorted(TOWERS))
def test_tower_mask_is_jaxs(case):
    kind, raw = TOWERS[case]
    args = {"seq2seq": seq2seq_batch, "dual": _dual_inputs,
            "tower": _inputs}[kind](0)
    params = _shapes(JTowerModel(JTowerConfig.from_dict(raw)), *args)
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    _check(model, tower_params_from_flax(_mask_arrays(params)))


@pytest.mark.parametrize("case", sorted(EMBEDDING_CASES))
def test_embedding_mask_is_jaxs(case):
    kind = EMBEDDING_CASES[case]["kind"]
    jm, tm, inputs, _ = _embedding_case(rng=np.random.default_rng(0),
                                        **EMBEDDING_CASES[case])
    src = (jnp.asarray(inputs[0]) if kind == "speech"
           else tuple(map(jnp.asarray, inputs)))
    params = _shapes(jm, src, jnp.ones((2, 1), jnp.int32))["params"]
    bridged = tower_params_from_flax({"embedding": {kind: _mask_arrays(
        params)}})
    _check(tm, bridged, f"embedding.{kind}.")


D, SEQ, IMGS, B, T = 32, 4, 2, 2, 3


@pytest.mark.parametrize("kind", ["score", "seq_score"])
def test_multimodal_mask_is_jaxs(kind):
    kw = dict(feat_size=D, seq_length=SEQ, max_imgs=IMGS, visual_feat_dim=D,
              num_heads=4, drop_p=0.0, forward_drop_p=0.0)
    rng = np.random.RandomState(0)
    args = [rng.randn(B, T, SEQ, D).astype(np.float32),
            rng.randn(B, IMGS, D).astype(np.float32)]
    if kind == "score":
        jm, tm = JScore(JModelConfig(**kw)), ScoreModel(ModelConfig(**kw))
    else:
        args.append(np.tile(np.arange(T, dtype=np.int32), (B, 1)))
        jm, tm = JSeq(JModelConfig(**kw)), SeqScoreModel(ModelConfig(**kw))
    params = _shapes(jm, *map(jnp.asarray, args))["params"]
    _check(tm, params_from_flax(_mask_arrays(params)))
