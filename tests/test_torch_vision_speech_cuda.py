"""Image and speech pretraining on a CUDA card: hash dropout against its
plain version at the new sites (BEiT-base's (32, 197, 768) and (32, 12,
197, 197), S2T-small's (16, 400, 256), float32), forward and backward bit
for bit; the VQGAN at the published f16-1024 widths encoding on the card
and on the CPU from the same weights, quant_conv's output within Z_RTOL and
the tokens equal wherever the CPU's margin between its two nearest codes
exceeds twice the gap in the distances; and tiny BEiT and S2T towers'
training steps, which launch the kernel at every site.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_vision_speech_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.device import require_cuda
from lr2ppo_torch.ops.hash_dropout import hash_dropout, hash_dropout_reference
from lr2ppo_torch.towers import TowerConfig, TowerModel
from lr2ppo_torch.towers.model import init_weights
from lr2ppo_torch.towers.vqgan import VQGANConfig, VQGANEncoder, init_vqgan

pytestmark = pytest.mark.cuda

# quant_conv's output on the card against the CPU's, float32 with TF32 off:
# within Z_RTOL of the largest |z|
Z_RTOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return require_cuda()


@pytest.mark.parametrize("shape", [(32, 197, 768), (32, 12, 197, 197),
                                   (16, 400, 256)],
                         ids=["beit_residual", "beit_probs", "s2t_encoder"])
@pytest.mark.parametrize("seed", [0, -5, 2**31 - 1])
def test_kernel_is_bit_equal_at_the_new_sites(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, device=dev, generator=gen) + 10.0
    g = torch.randn(shape, device=dev, generator=gen) + 10.0
    xr = x.clone().requires_grad_(True)
    before = hash_dropout.launches
    y = hash_dropout(xr, seed, 0.1)
    y.backward(g)
    assert hash_dropout.launches == before + 2
    assert torch.equal(y.detach(), hash_dropout_reference(x, seed, 0.1))
    assert torch.equal(xr.grad, hash_dropout_reference(g, seed, 0.1))


def test_vqgan_tokens_on_the_card_are_the_cpus(dev):
    cpu = VQGANEncoder(VQGANConfig())
    init_vqgan(cpu, torch.Generator().manual_seed(0))
    card = VQGANEncoder(VQGANConfig(), device=dev)
    card.load_state_dict(cpu.state_dict(), strict=True)
    px = torch.rand(2, 3, 224, 224, generator=torch.Generator()
                    .manual_seed(1))
    with torch.inference_mode():
        z_cpu = cpu.features(px)
        z_card = card.features(px.to(dev)).cpu()
        idx_cpu = cpu.quantize_features(z_cpu)[0]
        idx_card = card.quantize_features(z_card.to(dev))[0].cpu()
    assert idx_cpu.shape == (2, 196)
    assert float((z_card - z_cpu).abs().max()) <= \
        Z_RTOL * float(z_cpu.abs().max())
    e = cpu.quantize.embedding.weight.detach().double()

    def dist(z):
        z = z.double()
        return (z.pow(2).sum(-1, keepdim=True) - 2 * z @ e.t()
                + e.pow(2).sum(-1))

    d_cpu = dist(z_cpu)
    gap = float((d_cpu - dist(z_card)).abs().max())
    two = d_cpu.topk(2, dim=-1, largest=False).values
    decided = (two[..., 1] - two[..., 0]) > 2 * gap
    assert torch.equal(idx_card[decided], idx_cpu[decided])


@pytest.mark.parametrize("kind", ["beit", "s2t"])
def test_tower_step_launches_at_every_site(dev, kind):
    small = dict(emb_size=64, hidden_size=64, feedforward_size=128,
                 heads_num=4, layers_num=2, dropout=0.1, hash_dropout=True)
    rng = np.random.RandomState(0)
    if kind == "beit":
        cfg = TowerConfig(**small, embedding=["masked_patch", "pos"],
                          vocab_size=64, image_height=32, image_width=32,
                          patch_size=8, max_seq_length=17,
                          layernorm_positioning="pre")
        src = (torch.rand(4, 3, 32, 32, device=dev),
               torch.from_numpy(rng.randint(1, 17, (4, 3))).to(dev))
        tgt = torch.from_numpy(np.where(rng.rand(4, 17) < 0.3,
                                        rng.randint(1, 64, (4, 17)), 0)
                               ).to(dev)
        args = (src, tgt, torch.ones(4, 17, dtype=torch.long, device=dev))
        want = 2 * (1 + 3 * cfg.layers_num)
    else:
        cfg = TowerConfig(**small, embedding=["speech", "sinusoidalpos"],
                          tgt_embedding=["word", "sinusoidalpos"],
                          decoder="transformer", decoder_layers_num=1,
                          target=["lm"], vocab_size=50, max_seq_length=32,
                          max_audio_frames=64, layernorm_positioning="pre",
                          remove_embedding_layernorm=True)
        tgt_in = torch.from_numpy(rng.randint(5, 50, (4, 8))).to(dev)
        seg = torch.ones(4, 16, dtype=torch.long, device=dev)
        args = (torch.randn(4, 64, 80, device=dev), tgt_in.roll(-1, 1), seg,
                tgt_in, torch.ones_like(tgt_in))
        want = 2 * (1 + 3 * cfg.layers_num + 1 + 5)
    model = TowerModel(cfg, device=dev, with_target=True)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    before = hash_dropout.launches
    loss = model(*args, deterministic=False,
                 generator=torch.Generator().manual_seed(1))[0]
    loss.backward()
    assert hash_dropout.launches - before == want
    assert torch.isfinite(loss)
