"""Hash dropout on the tower pretraining path, on a CUDA card: the kernel
against its plain version at the two tower sites of XLM-R base MLM at batch
32 x 128 (the (32, 128, 768) residual branches and the (32, 12, 128, 128)
attention probabilities, float32), forward and backward bit for bit; and a
tiny tower's training step, which launches the kernel at every site,
forward and backward.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_pretrain_cuda.py`.
Elsewhere every test skips.
"""

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops.hash_dropout import hash_dropout, hash_dropout_reference
from lr2ppo_torch.towers import TowerConfig, TowerModel
from lr2ppo_torch.towers.model import init_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(32, 128, 768), (32, 12, 128, 128)],
                         ids=["residual", "probs"])
@pytest.mark.parametrize("seed", [0, -5, 2**31 - 1])
def test_kernel_is_bit_equal_at_the_tower_sites(dev, shape, seed):
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
    assert torch.equal(y.detach() == 0, xr.grad == 0)


def test_tower_training_step_launches_at_every_site(dev):
    layers = 2
    cfg = TowerConfig(emb_size=64, hidden_size=64, feedforward_size=128,
                      heads_num=4, layers_num=layers, max_seq_length=32,
                      vocab_size=50, dropout=0.1, hash_dropout=True)
    model = TowerModel(cfg, device=dev, with_target=True)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randint(5, 50, (4, 32))).to(dev)
    tgt = torch.from_numpy(np.where(rng.rand(4, 32) < 0.3,
                                    rng.randint(5, 50, (4, 32)), 0)).to(dev)
    seg = torch.ones_like(src)
    before = hash_dropout.launches
    loss = model(src, tgt, seg, deterministic=False,
                 generator=torch.Generator().manual_seed(1))[0]
    loss.backward()
    assert hash_dropout.launches - before == 2 * (1 + 3 * layers)
    assert torch.isfinite(loss)
