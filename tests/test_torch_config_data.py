"""The port's own copies of the JAX-free host side against the JAX
package's: parse_config gives the same configuration for the same argv, and
the MovieNet ppo and eval loaders give the same batches, array for array."""

import dataclasses

import numpy as np
import pytest

from lr2ppo_tpu import config as jconfig
from lr2ppo_tpu.cli import _common as jcommon
from lr2ppo_torch import config as tconfig
from lr2ppo_torch.cli import _common as tcommon
from fixtures import make_movienet

ARGVS = [
    [],
    ["--profile", "fast"],
    ["--profile", "fast", "--rollout_int8", "0", "--moment_dtype",
     "float32", "--compute_dtype", "float32"],
    ["--batch_size", "256", "--max_tags", "2", "--update_timesteps", "2",
     "--max_timesteps", "1", "--eval_steps", "2", "--seed", "11",
     "--use_gae", "--surrogate_clip", "true", "--grad_clip", "1.5",
     "--scheduler", "cosine", "--warmup", "0.3", "--max_imgs", "4",
     "--feat_size", "32", "--item_dtype", "float32", "--dp", "1"],
    ["--mode", "cls", "--reward_int8", "true", "--hash_dropout", "false",
     "--learning_rate", "3e-4", "--critic_learning_rate", "1e-3",
     "--unknown_flag", "7", "--use_pairwise"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_config_matches_the_jax_package(argv):
    got = dataclasses.asdict(tconfig.parse_config(argv))
    ref = dataclasses.asdict(jconfig.parse_config(argv))
    assert got == ref


def test_profiles_and_rollout_int8_mode_match():
    assert tconfig.PROFILES == jconfig.PROFILES
    for v in (True, False, "1", "0", "actor", "both", "off", ""):
        assert tconfig.rollout_int8_mode(v) == jconfig.rollout_int8_mode(v)
    with pytest.raises(ValueError):
        tconfig.rollout_int8_mode("sometimes")
    with pytest.raises(ValueError):
        tconfig.parse_config(["--profile", "nope"])


def _cfgs(tmp_path, *extra):
    j, _ = make_movienet(str(tmp_path / "data"), n_items=7, seq=4, feat=16,
                         seed=3)
    argv = ["--train_path", j, "--dev_path", j, "--feat_size", "16",
            "--seq_length", "4", "--max_imgs", "3", "--batch_size", "4",
            "--max_tags", "2", "--num_workers", "2", "--loader", "thread",
            "--seed", "5", *extra]
    return tconfig.parse_config(argv), jconfig.parse_config(argv)


def _assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("item_dtype", ["float32", "bfloat16"])
def test_movienet_ppo_loader_matches(tmp_path, item_dtype):
    """Two epochs of the shuffled ppo-mode loader (fresh pairs per epoch)."""
    tcfg, jcfg = _cfgs(tmp_path, "--item_dtype", item_dtype)
    tl = tcommon.movienet_train_loader(tcfg, "ppo")
    jl = jcommon.movienet_train_loader(jcfg, "ppo")
    assert len(tl) == len(jl)
    for epoch in (1, 2):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        # copies: the loaders recycle their batch buffers
        _assert_batches_equal([{k: np.array(v) for k, v in b.items()}
                               for b in tl],
                              [{k: np.array(v) for k, v in b.items()}
                               for b in jl])
    _assert_batches_equal([tl.first_batch()], [jl.first_batch()])


def test_movienet_eval_loader_matches(tmp_path):
    tcfg, jcfg = _cfgs(tmp_path)
    _assert_batches_equal(tcommon.movienet_eval_loader(tcfg),
                          jcommon.movienet_eval_loader(jcfg))
    assert (tcommon.h5_path_for(tcfg.data.dev_path, tcfg)
            == jcommon.h5_path_for(jcfg.data.dev_path, jcfg))
