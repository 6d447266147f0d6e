"""The causal attention kernel of the latent tower (ops/mla_attention.py)
against its plain version on a CUDA card, forward and backward, and a
training step of a latent MoE tower whose every attention call takes the
kernel.

The kernel works in bfloat16 with float32 statistics; the plain version's
forward rounds the normalized probabilities to bfloat16 where the kernel
rounds them before normalizing, and its backward (autograd over float32
copies of q, k, v) keeps every intermediate in float32 where the kernel
rounds P and dS to bfloat16 for its products. So the two agree to
bfloat16's rounding of long sums, not bit for bit: each result is held to
a norm-relative gap of 1e-2 (forward) and 2e-2 (gradients), about 3x and
6x bfloat16's unit roundoff of 2^-8, and to a worst element within 6e-2 of
the result's largest magnitude.

Imports torch only, so it runs on a machine with a card and no JAX:
`python -m pytest --noconftest -q tests/test_torch_mla_attention_cuda.py`.
Elsewhere every test skips.
"""

import json
import os

import pytest
import torch

from lr2ppo_torch.ops.mla_attention import (mla_attention,
                                            reference_mla_attention)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_GAP, GRAD_GAP, ELEMENT_GAP = 1e-2, 2e-2, 6e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and triton")
    return torch.device("cuda", 0)


def inputs(b, h, s, dev, heads_last=False, seed=0):
    """q, k (B, H, S, 192), v (B, H, S, 128) bf16, N(0, 1); with
    `heads_last` views of (B, S, H, d) tensors, as the tower hands them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(d):
        shape = (b, s, h, d) if heads_last else (b, h, s, d)
        t = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return t.transpose(1, 2) if heads_last else t

    return make(192), make(192), make(128)


def gaps(got, want):
    got, want = got.detach().float(), want.detach().float()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    el = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    return rel, el


@pytest.mark.parametrize("b,h,s,heads_last", [
    (1, 16, 8192, False), (1, 16, 8192, True), (2, 4, 1000, True),
    (1, 2, 77, False)])
def test_kernel_matches_plain_forward_and_backward(b, h, s, heads_last,
                                                   dev):
    q, k, v = inputs(b, h, s, dev, heads_last)
    scale = 1.0 / 192 ** 0.5
    qk = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = mla_attention(*qk, scale)
    want = reference_mla_attention(q, k, v, scale)
    rel, el = gaps(out, want)
    assert rel < FWD_GAP and el < ELEMENT_GAP, (rel, el)
    do = torch.randn(out.shape, device=dev).to(torch.bfloat16)
    out.backward(do)
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    reference_mla_attention(*ref, scale).backward(do.float())
    for name, got, r in zip("qkv", qk, ref):
        rel, el = gaps(got.grad, r.grad)
        assert rel < GRAD_GAP and el < ELEMENT_GAP, (name, rel, el)
        assert got.grad.shape == got.shape


def test_kernel_is_counted_and_refuses_what_it_does_not_take(dev):
    q, k, v = inputs(1, 2, 64, dev)
    before = (mla_attention.launches, dict(mla_attention.kernel_calls))
    mla_attention(q, k, v)
    assert mla_attention.launches == before[0] + 1
    assert mla_attention.kernel_calls["fwd"] == before[1]["fwd"] + 1
    with pytest.raises(ValueError):
        mla_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        mla_attention(q[..., :128], k[..., :128], v)


def test_tower_step_takes_the_kernel_at_every_attention_call(dev):
    """One traced training step of the Moonlight configuration cut to 2
    layers (1 dense, 1 MoE) at 2,048 tokens, remat on: every `attn.mla`
    span holds one kernel forward (the forward and the recompute), the
    backward runs the kernel's backward once a layer, the plain version
    never runs, and the MoE layer counts its assignments and syncs."""
    from lr2ppo_torch.towers.model import TowerConfig, TowerModel, \
        init_weights
    from lr2ppo_torch.utils import counters

    with open(os.path.join(REPO, "perfbench", "configs",
                           "moonlight-16b-a3b-ep8.json")) as f:
        raw = json.load(f)
    raw.update(layers_num=2, num_hidden_layers=2, vocab_size=1024)
    cfg = TowerConfig.from_dict(raw)
    model = TowerModel(cfg, torch.bfloat16, dev, with_target=True)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    src = torch.randint(5, 1024, (1, 2048), device=dev)
    tgt = torch.roll(src, -1, 1)
    seg = torch.ones_like(src)
    plain = mla_attention.plain_calls
    calls = dict(mla_attention.kernel_calls)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss = model(src, tgt, seg, deterministic=False)[0]
        loss.backward()
        torch.cuda.synchronize()
    # the host's ranges (the profiler mirrors each on the device's track)
    spans = sum(e.count for e in prof.key_averages()
                if e.key == "lr2ppo.attn.mla"
                and str(e.device_type).endswith("CPU"))
    fwd = mla_attention.kernel_calls["fwd"] - calls["fwd"]
    bwd = mla_attention.kernel_calls["bwd"] - calls["bwd"]
    assert spans == fwd == 2 * cfg.layers_num
    assert bwd == cfg.layers_num
    assert mla_attention.plain_calls == plain
    got = counters()
    assert got["moe.assignments"] > 0 and got["moe.host_syncs"] >= 1
    assert torch.isfinite(loss)
