"""The causal attention kernels of the latent tower (ops/mla_attention.py:
the Triton forward, the CUDA C++ backward in
kernels/csrc/mla_attention_bwd.cu) against the plain version on a CUDA card,
forward and backward, and a training step of a latent MoE tower whose every
attention call takes the kernels.

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


def inputs(b, h, s, dev, heads_last=False, seed=0, v_slice=False):
    """q, k (B, H, S, 192), v (B, H, S, 128) bf16, N(0, 1); with
    `heads_last` views of (B, S, H, d) tensors, as the tower hands them;
    with `v_slice` v is the last 128 of 256 columns of a (B, S, H, 256)
    tensor, 256 bytes past its start, as `kv_b_proj`'s output gives it."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(d):
        shape = (b, s, h, d) if heads_last else (b, h, s, d)
        t = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return t.transpose(1, 2) if heads_last else t

    q, k = make(192), make(192)
    if v_slice:
        kv = torch.randn(b, s, h, 256, generator=g, device=dev)
        return q, k, kv.to(torch.bfloat16)[..., 128:].transpose(1, 2)
    return q, k, make(128)


def gaps(got, want):
    got, want = got.detach().float(), want.detach().float()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    el = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    return rel, el


@pytest.mark.parametrize("b,h,s,heads_last,v_slice", [
    (1, 16, 8192, False, False), (1, 16, 8192, True, False),
    (2, 4, 1000, True, False), (1, 2, 77, False, False),
    (2, 16, 8192, True, False), (1, 4, 4160, True, False),
    (2, 4, 1000, True, True)])
def test_kernel_matches_plain_forward_and_backward(b, h, s, heads_last,
                                                   v_slice, dev):
    """Batch 2 at the cell's heads-last strides; 4,160 tokens, not a whole
    number of 128-key tiles; v a slice at an offset of a wider tensor. The
    plain version runs one sequence at a time (its scores at 8,192 tokens
    would not fit whole twice)."""
    q, k, v = inputs(b, h, s, dev, heads_last, v_slice=v_slice)
    scale = 1.0 / 192 ** 0.5
    qk = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = mla_attention(*qk, scale)
    do = torch.randn(out.shape, device=dev).to(torch.bfloat16)
    out.backward(do)
    for i in range(b):
        one = [t[i:i + 1] for t in (q, k, v)]
        want = reference_mla_attention(*one, scale)
        rel, el = gaps(out[i:i + 1], want)
        assert rel < FWD_GAP and el < ELEMENT_GAP, (i, rel, el)
        del want
        ref = [t.detach().float().requires_grad_(True) for t in one]
        reference_mla_attention(*ref, scale).backward(do[i:i + 1].float())
        for name, got, r in zip("qkv", qk, ref):
            rel, el = gaps(got.grad[i:i + 1], r.grad)
            assert rel < GRAD_GAP and el < ELEMENT_GAP, (i, name, rel, el)
        del ref
    for got in qk:
        assert got.grad.shape == got.shape


def test_backward_repeats_and_counts_its_launches(dev):
    """Two backward calls on the same inputs: dk and dv bit for bit (each
    block sums its own keys in a fixed order), dq within float32 reduction
    order (the tiles' partial dQ meet in a float32 accumulator in whatever
    order the blocks reach it); each call adds its three launches (the
    pre-pass, the main kernel, the dQ pass) and one backward call."""
    from lr2ppo_torch.ops import mla_attention as mod

    q, k, v = inputs(2, 4, 1000, dev, heads_last=True, seed=3)
    scale = 1.0 / 192 ** 0.5
    o, lse = mod._launch_fwd(q, k, v, scale)
    do = torch.randn(o.shape, device=dev).to(torch.bfloat16)
    before = mla_attention.launches
    first = mod._launch_bwd(q, k, v, o, lse, do, scale)
    assert mla_attention.launches == before + 3
    second = mod._launch_bwd(q, k, v, o, lse, do, scale)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    rel = float((first[0].float() - second[0].float()).norm()
                / first[0].float().norm())
    assert rel <= 1e-3, rel
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    calls = dict(mla_attention.kernel_calls)
    launches = mla_attention.launches
    mla_attention(*qkv, scale).backward(do)
    assert mla_attention.kernel_calls["bwd"] == calls["bwd"] + 1
    assert mla_attention.launches == launches + 1 + 3


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
