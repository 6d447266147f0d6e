"""The latent MoE tower (Moonlight-16B-A3B's DeepSeek-V3 block: towers/
mla.py, towers/moe.py, towers/latent.py, ops/mla_attention.py's plain
version) against the plain reference tests/moonlight_reference.py on the
CPU, at a tiny size: hidden 64, 4 heads, latent 16, nope/rope/v 8/8/8, 8
experts of width 16, 2 a token, 1 shared, 1 dense + 2 MoE layers, 64
tokens.

Everything runs in float32 on both sides, so the gaps are rounding only:
the port and the reference order their sums differently (the port's
dispatch sorts the rows by expert and adds the experts' parts with
index_add, the reference adds whole-batch products), which leaves gaps of
a few float32 ulps of the results. Each comparison holds results to 1e-5
relative (about 80 ulps) and gradients to 1e-4 (long sums through the
backward of 3 layers). The routes are compared exactly, on inputs whose
scores leave no near-tie at the top k.

Imports no JAX: the reference is written from the published equations.
"""

import dataclasses
import json
import os

import moonlight_reference as ref
import numpy as np
import pytest
import torch

from lr2ppo_torch.ops.mla_attention import (mla_attention,
                                            reference_mla_attention)
from lr2ppo_torch.towers import moe as moe_mod
from lr2ppo_torch.towers.latent import LatentLayer
from lr2ppo_torch.towers.layers import T5LayerNorm
from lr2ppo_torch.towers.mla import LatentAttention
from lr2ppo_torch.towers.model import (LatentMoeConfig, TowerConfig,
                                       TowerModel, init_weights)
from lr2ppo_torch.train.optim import no_decay_names

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S = 2, 32                      # 64 tokens

TINY = dict(
    emb_size=64, hidden_size=64, heads_num=4, layers_num=3,
    feedforward_size=96, vocab_size=101, max_seq_length=64,
    embedding=["word"], encoder="transformer", mask="causal",
    layernorm_positioning="pre", layernorm="t5",
    remove_embedding_layernorm=True, remove_transformer_bias=True,
    target=["lm"], dropout=0.0, hidden_act="silu",
    kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
    rope_theta=50000.0, rms_norm_eps=1e-5, n_routed_experts=8,
    num_experts_per_tok=2, n_shared_experts=1, moe_intermediate_size=16,
    first_k_dense_replace=1, routed_scaling_factor=2.446,
    aux_loss_alpha=1e-2, bias_update_speed=1e-3)


def tiny_cfg(**kw) -> LatentMoeConfig:
    return TowerConfig.from_dict({**TINY, **kw})


def ref_cfg(cfg) -> dict:
    return dataclasses.asdict(cfg)


def tower(seed=0, **kw):
    model = TowerModel(tiny_cfg(**kw), with_target=True)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def close(got, want, rtol=RTOL):
    got, want = got.detach().double(), want.detach().double()
    gap = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert gap <= rtol, gap


def batch(seed=1, vocab=101):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(5, vocab, (B, S), generator=g)
    tgt = torch.randint(5, vocab, (B, S), generator=g)
    tgt[0, -3:] = 0                       # padded targets leave the loss
    return src, tgt, torch.ones_like(src)


def test_config_reaches_the_model_without_a_tower_field():
    raw = json.load(open(os.path.join(
        REPO, "perfbench", "configs", "moonlight-16b-a3b-ep8.json")))
    cfg = TowerConfig.from_dict(raw)
    assert type(cfg) is LatentMoeConfig and isinstance(cfg, TowerConfig)
    assert (cfg.layers_num, cfg.heads_num, cfg.feedforward_size) == \
        (9, 16, 11264)
    assert cfg.n_router == 64 and cfg.held() == list(range(8))
    assert "kv_lora_rank" not in {f.name for f in
                                  dataclasses.fields(TowerConfig)}
    # a published config.json (all 64 experts held) reads as it is
    pub = dict(raw, n_routed_experts=64, num_hidden_layers=27)
    for k in ("router_experts", "layers_num"):
        pub.pop(k)
    cfg = TowerConfig.from_dict(pub)
    assert cfg.n_router == 64 and len(cfg.held()) == 64
    assert cfg.layers_num == 27
    for bad in (dict(q_lora_rank=1536), dict(scoring_func="softmax"),
                dict(first_held_expert=60)):
        with pytest.raises(ValueError):
            TowerConfig.from_dict({**raw, **bad})


def test_norms_take_the_config_eps_and_are_not_decayed():
    model = tower(rms_norm_eps=3e-4)
    norms = [m for m in model.modules() if isinstance(m, T5LayerNorm)]
    assert len(norms) == 3 * 3 + 1 and all(m.eps == 3e-4 for m in norms)
    keys = no_decay_names(model)
    want = {k for k in dict(model.named_parameters())
            if k.endswith(("layernorm.weight", "layer_norm.weight"))}
    assert keys == want and len(want) == 10
    assert T5LayerNorm(8).eps == 1e-6      # the T5 towers keep theirs


def test_attention_plain_version_matches_reference_with_its_own_widths():
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(2, 3, 17, 12, generator=g) for _ in range(2))
    v = torch.randn(2, 3, 17, 5, generator=g)
    got = mla_attention(q, k, v, 0.3)
    close(got, ref.causal_attention(q, k, v, 0.3))
    assert torch.equal(got, reference_mla_attention(q, k, v, 0.3))


def test_mla_forward_and_backward_match_reference():
    cfg = tiny_cfg()
    attn = LatentAttention(cfg)
    init_weights(attn, torch.Generator().manual_seed(4))
    p = {f"a.{k}": v.detach().clone().requires_grad_(True)
         for k, v in attn.state_dict().items()}
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(5))
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = attn(x1)
    want = ref.mla(p, "a.", x2, ref_cfg(cfg))
    close(got, want)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(6))
    got.backward(dy)
    want.backward(dy)
    close(x1.grad, x2.grad, GRAD_RTOL)
    for k, prm in attn.named_parameters():
        close(prm.grad, p["a." + k].grad, GRAD_RTOL)


def moe_layer(cfg, seed=7):
    layer = moe_mod.MoeFeedForward(cfg)
    init_weights(layer, torch.Generator().manual_seed(seed))
    with torch.no_grad():                  # a correction bias in play
        layer.gate.e_score_correction_bias.copy_(
            torch.linspace(-0.02, 0.02, cfg.n_router))
    return layer


def test_router_choices_and_weights_match_reference():
    cfg = tiny_cfg()
    layer = moe_layer(cfg)
    x = torch.randn(B * S, 64, generator=torch.Generator().manual_seed(8))
    scores = torch.sigmoid(layer.gate(x))
    bias = layer.gate.e_score_correction_bias
    idx, w = moe_mod.route(scores, bias, 2, cfg.routed_scaling_factor)
    ridx, rw = ref.route(scores, bias, 2, cfg.routed_scaling_factor)
    assert torch.equal(idx, ridx)
    close(w, rw)
    assert torch.allclose(w.sum(-1), torch.full((B * S,), 2.446))


def test_moe_layer_output_and_balance_match_reference():
    cfg = tiny_cfg()
    layer = moe_layer(cfg)
    p = {f"m.{k}": v for k, v in layer.state_dict().items()}
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(9))
    y, aux = layer(x, deterministic=False)
    want, raux, ridx = ref.moe(p, "m.", x, ref_cfg(cfg),
                               layer.gate.e_score_correction_bias,
                               list(range(8)))
    close(y, want)
    close(aux, raux)
    load = torch.bincount(ridx.reshape(-1), minlength=8).float()
    assert torch.equal(layer.load, load)


def test_expert_backward_runs_inside_its_span():
    """Traced, the held experts' backward lies in a `moe.experts` range of
    its own: the two products a projection's backward makes (its input's
    and its weight's gradient), for each of an expert's three projections
    with rows, and none of the shared experts' or the router's."""
    cfg = tiny_cfg()
    layer = moe_layer(cfg)
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(11),
                    requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y, aux = layer(x, deterministic=False)
        (y.square().sum() + aux).backward()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "lr2ppo.moe.experts")
    assert len(spans) == 2                 # the forward, then the backward
    (fs, fe), (bs, be) = spans
    mms = [e.time_range for e in events if e.name == "aten::mm"]
    inside = sum(bs <= r.start and r.end <= be for r in mms)
    rows = int((layer.load > 0).sum())
    assert inside == 6 * rows
    # after the experts' forward, outside their backward: the shared
    # experts' forward (3) and backward (6), the router's backward (2)
    after = sum(r.start > fe and not (bs <= r.start <= be) for r in mms)
    assert after == 3 + 6 + 2


def test_expert_shares_add_up_to_the_uncut_layer():
    """4 shares of 2 experts each (router over all 8), the shared expert
    counted once: their outputs add up to the uncut reference layer."""
    whole = moe_layer(tiny_cfg())
    state = whole.state_dict()
    p = {f"m.{k}": v for k, v in state.items()}
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(10))
    want, _, _ = ref.moe(p, "m.", x, ref_cfg(tiny_cfg()),
                         whole.gate.e_score_correction_bias, list(range(8)))
    total = None
    for first in (0, 2, 4, 6):
        cfg = tiny_cfg(n_routed_experts=2, router_experts=8,
                       first_held_expert=first)
        share = moe_mod.MoeFeedForward(cfg)
        assert share.held == [first, first + 1]
        share.load_state_dict({k: v for k, v in state.items()
                               if not k.startswith("experts.")
                               or int(k.split(".")[1]) in share.held},
                              strict=True)
        y, _ = share(x)
        total = y if total is None else total + y
    shared = ref.swiglu(p, "m.shared_experts.", x)
    close(total - 3 * shared, want)


def test_tower_loss_gradients_and_a_step_match_reference():
    """The whole tower's LM loss, balance loss and every leaf's gradient,
    then one AdamW step (a constant lr) with the correction bias update,
    through the port's make_pretrain_step."""
    from lr2ppo_torch.config import Config
    from lr2ppo_torch.train.common import TrainState
    from lr2ppo_torch.train.optim import build_optimizer
    from lr2ppo_torch.train.pretrain import make_pretrain_step

    model = tower()
    cfg = ref_cfg(model.cfg)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    p = {k: v.clone().requires_grad_(True) for k, v in start.items()
         if "e_score_correction_bias" not in k}
    biases = {i: start[f"encoder.transformer.{i}.mlp.gate."
                       "e_score_correction_bias"] for i in (1, 2)}
    src, tgt, seg = batch()
    loss, lm, bal, routes = ref.tower_loss(p, cfg, src, tgt, biases,
                                           list(range(8)))
    loss.backward()
    out = model(src, tgt, seg, deterministic=False)
    close(out[0], loss)
    close(model.encoder.balance_loss, bal)
    assert float(bal.detach()) > 0
    out[0].backward()
    for k, prm in model.named_parameters():
        close(prm.grad, p[k].grad, GRAD_RTOL)
    model.zero_grad()
    for m in model.modules():
        if isinstance(m, moe_mod.MoeFeedForward):
            m.load.zero_()

    c = Config()
    c.optim.learning_rate, c.optim.scheduler = 1e-2, "constant"
    state = TrainState(model, build_optimizer(
        c.optim, dict(model.named_parameters()), 10,
        no_decay=no_decay_names(model)))
    m = make_pretrain_step(1)(state, torch.Generator().manual_seed(0),
                              {"src": src, "tgt": tgt, "seg": seg})
    close(m["loss"], loss)
    want = ref.adamw_step({k: v.detach() for k, v in p.items()},
                          {k: v.grad for k, v in p.items()}, 1e-2,
                          c.optim.beta1, c.optim.beta2, c.optim.adam_eps,
                          c.optim.weight_decay)
    got = model.state_dict()
    for k, w in want.items():
        close(got[k] - start[k], w - start[k], GRAD_RTOL)
    for i in (1, 2):
        key = f"encoder.transformer.{i}.mlp.gate.e_score_correction_bias"
        bias = ref.bias_step(biases[i], routes[i], 1e-3)
        assert torch.equal(got[key], bias) and bool((bias != 0).any())


def test_remat_recompute_counts_no_load_twice_and_matches():
    """remat on and off give the same loss, gradients and loads: the
    recompute neither counts the load again nor moves the bias."""
    src, tgt, seg = batch(2)
    runs = []
    for remat in (False, True):
        model = tower(remat=remat)
        model(src, tgt, seg, deterministic=False)[0].backward()
        runs.append((model, [m.load.clone() for m in model.modules()
                             if isinstance(m, moe_mod.MoeFeedForward)]))
    (a, la), (b, lb) = runs
    for x, y in zip(la, lb):
        assert torch.equal(x, y) and float(x.sum()) == B * S * 2
    grads = dict(a.named_parameters())
    for k, prm in b.named_parameters():
        close(prm.grad, grads[k].grad, RTOL)


@pytest.mark.parametrize("flag", ["--tp", "--pp", "--sp", "--fsdp", "--dp"])
def test_parallel_flags_raise_naming_the_flag(flag, tmp_path):
    from lr2ppo_torch.cli.pretrain import build, parser

    (tmp_path / "tower.json").write_text(json.dumps(TINY))
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
        + [f"w{i}" for i in range(96)]) + "\n")
    (tmp_path / "corpus.txt").write_text(" ".join(
        f"w{i % 96}" for i in range(400)) + "\n")
    extra = {"--tp": ["--tp", "2"], "--pp": ["--pp", "2"],
             "--sp": ["--tp", "1", "--sp"], "--fsdp": ["--fsdp"],
             "--dp": ["--dp", "2"]}[flag]
    args = parser().parse_args([
        "--corpus_path", str(tmp_path / "corpus.txt"),
        "--tower_config", str(tmp_path / "tower.json"),
        "--vocab_path", str(tmp_path / "vocab.txt"), "--tokenizer", "space",
        "--data_processor", "lm", "--seq_length", "16", "--device", "cpu",
        *extra])
    with pytest.raises((ValueError, SystemExit), match=flag):
        build(args, "cpu")


def test_latent_layer_kinds_follow_first_k_dense():
    model = tower()
    kinds = [type(layer.mlp).__name__ for layer in model.encoder.transformer]
    assert kinds == ["SwiGLU", "MoeFeedForward", "MoeFeedForward"]
    assert all(isinstance(layer, LatentLayer)
               for layer in model.encoder.transformer)
    # the MoE layer holds its experts under their global ids
    held = tower(n_routed_experts=2, router_experts=8, first_held_expert=4)
    assert sorted(held.encoder.transformer[1].mlp.experts) == ["4", "5"]
    assert held.encoder.transformer[1].mlp.gate.weight.shape == (8, 64)
    assert np.isfinite(float(held(*batch())[0].detach()))
