"""The seq2seq towers on a mesh, on the CPU over gloo (tests/
test_torch_parallel.py:spawn): the tp rule table on the decoder's keys
against JAX's, its coverage at T5-base's widths, T5's position bias sliced
to a tp rank's heads, and the pretraining CLI at --data_processor t5 on
T5-tiny (2 + 2 layers of 16, 4 heads, hash dropout at 0.1) at dp 2, tp 2
and tp 2 with --sp, two ranks each, against the same run in one process.
The ranks import no JAX."""

import json

import numpy as np
import pytest
import torch

from lr2ppo_torch.parallel import mesh as pm
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint)
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.train.checkpoints import save_model
from test_torch_parallel import _jax_tp_dims, spawn

torch.set_num_threads(1)

TOKENS = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + list("abcdefghi")
STEPS = 3
# tp against world 1: float32 sums split over tp, over 3 AdamW steps (tests/
# test_torch_parallel_stages.py's tp pretraining tolerance)
TOL = 1e-4


def t5_raw(**kw):
    """T5-tiny (2 + 2 layers of 16, 4 heads), here and in tests/
    test_torch_seq2seq.py: T5's norms, no biases, no attention scale, the
    relative bias in both stacks, no position table, untied target-side
    words. This module holds it because the ranks import it, and no JAX."""
    return {**dict(emb_size=16, hidden_size=16, feedforward_size=32,
                   heads_num=4, layers_num=2, decoder_layers_num=2,
                   dropout=0.0, max_seq_length=16, vocab_size=40,
                   embedding=["word"], tgt_embedding=["word"],
                   encoder="transformer", mask="fully_visible",
                   decoder="transformer", target=["lm"], layernorm="t5",
                   layernorm_positioning="pre", hidden_act="relu",
                   remove_transformer_bias=True, remove_attention_scale=True,
                   remove_embedding_layernorm=True,
                   relative_position_embedding=True,
                   relative_attention_buckets_num=8,
                   has_lmtarget_bias=False), **kw}


# T5-base (google-t5/t5-base config.json) at 2 + 2 layers
T5_BASE_CUT = dict(emb_size=768, hidden_size=768, feedforward_size=3072,
                   heads_num=12, layers_num=2, decoder_layers_num=2,
                   vocab_size=32128, relative_attention_buckets_num=32)


def test_rule_table_matches_jax_on_the_decoder_and_covers_t5_base():
    """Every parameter of a T5 and of a post-LN seq2seq tower splits as
    JAX's table splits it (the decoder's attention and FFN by the existing
    suffixes; the bias tables, norms and both word tables replicated), and
    T5-base's widths leave no large parameter outside the table."""
    from lr2ppo_tpu.towers import torch_tower_to_flax

    for raw in (t5_raw(), t5_raw(layernorm="normal",
                                 layernorm_positioning="post",
                                 remove_transformer_bias=False)):
        sd = TowerModel(TowerConfig.from_dict(raw),
                        with_target=True).state_dict()
        want = _jax_tp_dims(sd, torch_tower_to_flax)
        got = {k: pm.tp_dim(k) for k in sd}
        assert got == want
        for sub in ("self_attn", "context_attn"):
            for i in "012":
                assert got[f"decoder.transformer_decoder.1.{sub}."
                           f"linear_layers.{i}.weight"] == 0
            assert got[f"decoder.transformer_decoder.1.{sub}."
                       "final_linear.weight"] == 1
        assert got["decoder.self_pos_emb.relative_attention_bias.weight"] \
            is None
    big = TowerModel(TowerConfig.from_dict(t5_raw(**T5_BASE_CUT)),
                     device="meta", with_target=True)
    pm.assert_tp_coverage(list(big.named_parameters()), tp=2)
    assert pm.tp_dim("target.lm.output_layer.weight") == 0


def _bias_rank(rank, world, url, table, q_len, k_len):
    """This rank's heads of the bias and the whole table's gradient."""
    from lr2ppo_torch.towers.layers import RelativePositionEmbedding

    mesh = pm.make_mesh(1, world)
    rel = RelativePositionEmbedding(table.shape[1], False, table.shape[0])
    rel.relative_attention_bias.weight.data = torch.tensor(table)
    bias = rel(q_len, k_len, mesh)
    (bias * (1.0 + torch.arange(bias.numel()).reshape(bias.shape)
             + 100.0 * rank)).sum().backward()
    return bias.detach().numpy(), \
        rel.relative_attention_bias.weight.grad.numpy()


def test_position_bias_keeps_a_ranks_heads_and_gathers_the_gradient(
        tmp_path):
    """At tp 2 a rank reads its heads of the (1, H, Sq, Sk) bias, and the
    replicated table's gradient is the sum over every rank's heads: what
    one process gets for the whole bias under the same cotangent."""
    from lr2ppo_torch.towers.layers import RelativePositionEmbedding

    table = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    ranks = spawn(_bias_rank, 2, tmp_path, table, 6, 5)
    rel = RelativePositionEmbedding(4, False, 8)
    rel.relative_attention_bias.weight.data = torch.tensor(table)
    whole = rel(6, 5)
    ct = torch.cat([1.0 + torch.arange(2 * 30).reshape(1, 2, 6, 5)
                    + 100.0 * r for r in range(2)], dim=1)
    (whole * ct).sum().backward()
    for r, (bias, grad) in enumerate(ranks):
        np.testing.assert_array_equal(bias,
                                      whole.detach()[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            grad, rel.relative_attention_bias.weight.grad.numpy())


# -- the CLI on a mesh -------------------------------------------------------
LEGS = {"dp2": ["--dp", "2"], "tp2": ["--tp", "2", "--dp", "1"],
        "tp2_sp": ["--tp", "2", "--dp", "1", "--sp"]}


def _files(d):
    (d / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    rng = np.random.RandomState(0)
    (d / "c.txt").write_text("".join(
        " ".join(rng.choice(list("abcdefghi"), 12)) + "\n"
        for _ in range(40)))
    (d / "tower.json").write_text(json.dumps(t5_raw(
        vocab_size=None, dropout=0.1)))
    init = str(d / "init.bin")
    cfg = TowerConfig.from_json(str(d / "tower.json"),
                                vocab_size=len(TOKENS) + 100)
    model = TowerModel(cfg, with_target=True)
    init_weights(model, torch.Generator().manual_seed(3))
    save_model(init, model)
    return ["--corpus_path", str(d / "c.txt"), "--tower_config",
            str(d / "tower.json"), "--data_processor", "t5", "--tokenizer",
            "space", "--vocab_path", str(d / "v.txt"), "--batch_size", "4",
            "--accumulation_steps", "2", "--seq_length", "16",
            "--tgt_seq_length", "12", "--total_steps", str(STEPS),
            "--report_steps", "1", "--learning_rate", "1e-2",
            "--hash_dropout", "--pretrained_model_path", init]


def _legs_rank(rank, world, url, argv, outs):
    from lr2ppo_torch.cli import pretrain

    for name, extra in LEGS.items():
        pretrain.main(argv + extra + ["--output_model_path", outs[name],
                                      "--log_path", outs[name] + ".log"],
                      device="cpu")
    return rank


def _records(out):
    with open(out + ".log.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The t5 CLI in one process, then dp 2, tp 2 and tp 2 + --sp in one
    spawn of two ranks: {leg: (records, final weights)}."""
    d = tmp_path_factory.mktemp("seq2seq_mesh")
    argv = _files(d)
    from lr2ppo_torch.cli import pretrain

    out = {}
    world1 = str(d / "world1")
    pretrain.main(argv + ["--output_model_path", world1, "--log_path",
                          world1 + ".log"], device="cpu")
    outs = {name: str(d / name) for name in LEGS}
    spawn(_legs_rank, 2, d, argv, outs, timeout=240)
    for name, path in {"world1": world1, **outs}.items():
        out[name] = (_records(path), load_tower_checkpoint(path))
    return out


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_t5_cli_on_a_mesh_tracks_world_1(mesh_runs, leg):
    """Each leg takes world 1's hash-dropout masks (the global-index form
    at a dp shard and at a tp rank's heads): the per-step losses and
    accuracies and every final weight within TOL of world 1's (of each
    tensor's largest magnitude), the weights moved from the start."""
    wrec, want = mesh_runs["world1"]
    rec, got = mesh_runs[leg]
    assert [r["step"] for r in rec] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in rec],
                               [r["loss"] for r in wrec], rtol=TOL)
    np.testing.assert_allclose([r["acc"] for r in rec],
                               [r["acc"] for r in wrec], atol=TOL)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=TOL * float(w.abs().max()),
                                   err_msg=f"{leg} {k}")


def test_sp_trains_to_the_tp_bits(mesh_runs):
    """--sp splits only the encoder's stream and gathers the memory whole
    before the decoder: tp 2 with --sp is tp 2's run, bit for bit."""
    (r_tp, w_tp), (r_sp, w_sp) = mesh_runs["tp2"], mesh_runs["tp2_sp"]
    assert [r["loss"] for r in r_sp] == [r["loss"] for r in r_tp]
    for k in w_tp:
        assert torch.equal(w_sp[k], w_tp[k]), k
