"""The AdamW kernel (ops/adamw.py:adamw) against its plain version on a CUDA
card, bit for bit: p, m and v after each of 3 steps from the same inputs.

Imports torch and numpy only, so it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -q tests/test_torch_adamw_cuda.py`.
Elsewhere every test skips.
"""

import math

import numpy as np
import pytest
import torch

from lr2ppo_torch.ops import adamw as ops
from lr2ppo_torch.ops.adamw import adamw, adamw_reference
from lr2ppo_torch.parallel.mesh import shard_slice
from lr2ppo_torch.train import optim as topt
from lr2ppo_torch.utils import counters

pytestmark = pytest.mark.cuda

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LRS = (1e-3, 5e-4, 2e-3)
B1, B2, EPS, WD = 0.9, 0.999, 1e-6, 0.01
# the bias correction's step scale at steps 1-3
CORRECTED = tuple(math.sqrt(1 - B2 ** c) / (1 - B1 ** c) for c in (1, 2, 3))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so -0 and +0 differ."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def values(shape, seed: int, dev, dtype, scale: float = 1.0,
           positive: bool = False) -> torch.Tensor:
    """Seeded values over several magnitudes, with zeros and tiny ones."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * 10.0 ** rng.randint(-4, 2, size=shape) * scale
    flat = x.reshape(-1)
    flat[::17] = 0.0
    flat[5::23] = 1e-9
    x = np.abs(x) if positive else x
    return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)


def run3(p, p_of, m, v, grads, wd=WD, scales=(1.0,) * 3, norms=(None,) * 3,
         clip=None):
    """Three steps of the kernel on p_of(p) and of the plain version on
    p_of(a clone of p), from the same moments and gradients (grads[t] None:
    zero); after each step the whole of p (of which p_of may take a view),
    m and v agree bit for bit, and the kernel launched once a step."""
    rp = p.clone()
    rm, rv = m.clone(), v.clone()
    for t, g in enumerate(grads):
        before = ops.adamw.launches
        took = adamw(p_of(p), g, m, v, LRS[t], B1, B2, EPS, wd, scales[t],
                     norms[t], clip)
        adamw_reference(p_of(rp), g, rm, rv, LRS[t], B1, B2, EPS, wd,
                        scales[t], norms[t], clip)
        torch.cuda.synchronize()
        assert took and ops.adamw.launches == before + 1
        for name, a, b in (("p", p, rp), ("m", m, rm), ("v", v, rv)):
            assert torch.equal(bits(a), bits(b)), \
                f"{name} differs at step {t + 1}"


@pytest.mark.parametrize("decay", [True, False], ids=["decay", "no_decay"])
@pytest.mark.parametrize("moments", sorted(DTYPES))
@pytest.mark.parametrize("params", sorted(DTYPES))
def test_bit_equal_by_dtype_and_decay(dev, params, moments, decay):
    """Parameters and moments in float32 and bfloat16, the decay on and
    off, at 37 x 1031 (neither a multiple of the 8 values a thread takes)."""
    shape = (37, 1031)
    p = values(shape, 1, dev, DTYPES[params], 0.02)
    m = values(shape, 2, dev, DTYPES[moments], 1e-3)
    v = values(shape, 3, dev, DTYPES[moments], 1e-6, positive=True)
    grads = [values(shape, 10 + t, dev, DTYPES[params], 1e-2)
             for t in range(3)]
    run3(p, lambda t: t, m, v, grads, wd=WD if decay else 0.0)


def case_inputs(shape, dev, params=torch.bfloat16, moments=torch.bfloat16):
    return (values(shape, 4, dev, params, 0.02),
            values(shape, 5, dev, moments, 1e-3),
            values(shape, 6, dev, moments, 1e-6, positive=True),
            [values(shape, 20 + t, dev, params, 1e-2) for t in range(3)])


def test_missing_gradient_is_zero(dev):
    """A step without a gradient (None) decays the moments and applies the
    weight decay, as the plain version's zeros do; with fp32 moments too."""
    for moments in (torch.bfloat16, torch.float32):
        p, m, v, grads = case_inputs((129, 67), dev, moments=moments)
        run3(p, lambda t: t, m, v, [grads[0], None, None])


def test_grad_clip_reads_the_device_norm(dev):
    """The norm lies on the card: above the clip (scaled), below it
    (kept), and equal to it (scaled, as `norm < clip` is false)."""
    p, m, v, grads = case_inputs((300, 301), dev)
    norms = tuple(torch.tensor(n, device=dev) for n in (3.7, 0.25, 1.0))
    run3(p, lambda t: t, m, v, grads, norms=norms, clip=1.0)


def test_correct_bias_step_scale(dev):
    p, m, v, grads = case_inputs((64, 1000), dev, params=torch.float32,
                                 moments=torch.float32)
    run3(p, lambda t: t, m, v, grads, scales=CORRECTED)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 8 * 1000 + 3, 1 << 20])
def test_sizes_off_the_vector_width(dev, n):
    """Sizes below, at and above the 8 values a thread takes, and one that
    spans many grid strides."""
    for params, moments in ((torch.bfloat16, torch.bfloat16),
                            (torch.bfloat16, torch.float32)):
        p, m, v, grads = case_inputs((n,), dev, params, moments)
        run3(p, lambda t: t, m, v, grads)


@pytest.mark.parametrize("shared", [False, True],
                         ids=["p_and_g_only", "all_four"])
def test_view_at_an_unaligned_offset(dev, shared):
    """p and g views 3 values into larger buffers (not 16-byte aligned):
    with fresh moments no column aligns all four, and every value goes one
    by one; with the moments at the same offset the vector steps start at
    a common column after a scalar head. Nothing outside the views
    changes."""
    n = 4099
    p, m, v, grads = case_inputs((n + 3,), dev, moments=torch.float32)
    grads = [g[3:] for g in grads]
    if not shared:
        m, v = m[3:].clone(), v[3:].clone()
        run3(p, lambda t: t[3:], m, v, grads)
        return
    assert p[3:].data_ptr() % 16
    rm, rv = m.clone(), v.clone()
    rp = p.clone()
    for t, g in enumerate(grads):
        adamw(p[3:], g, m[3:], v[3:], LRS[t], B1, B2, EPS, WD, 1.0)
        adamw_reference(rp[3:], g, rm[3:], rv[3:], LRS[t], B1, B2, EPS, WD,
                        1.0)
        torch.cuda.synchronize()
        for a, b in ((p, rp), (m, rm), (v, rv)):
            assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("shape,dim", [((48, 1000), 1), ((4, 64, 24), 1),
                                       ((40, 36), 0)],
                         ids=["2d_dim1", "3d_dim1", "2d_dim0"])
def test_zero1_slice(dev, shape, dim):
    """A zero1 rank's part of a parameter (DeviceCtx.optimizer's
    shard_slice view) and of its gradient, the moments contiguous: rows of
    the slice's width with the parameter's row stride. The rest of the
    parameter stays as it was."""
    for rank in (0, 3):
        p, _, _, grads = case_inputs(shape, dev)
        part = shard_slice(p, dim, rank, 4)
        m = values(part.shape, 7, dev, torch.bfloat16, 1e-3).contiguous()
        v = values(part.shape, 8, dev, torch.bfloat16, 1e-6,
                   positive=True).contiguous()
        run3(p, lambda t: shard_slice(t, dim, rank, 4), m, v,
             [shard_slice(g, dim, rank, 4) for g in grads])


def test_adamw_step_takes_the_kernel_for_every_tensor(dev, monkeypatch):
    """AdamW.step on a small bf16 model on the card (one parameter without
    a gradient, grad_clip from the norm step computes on the card): one
    launch a tensor, `optim.kernel_tensors` counts every tensor and
    `optim.plain_tensors` none while a profiler records, and the
    parameters equal those of the same steps through the plain version."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(33, 17),
                                torch.nn.LayerNorm(17),
                                torch.nn.Linear(17, 5, bias=False)).to(
                                    dev, torch.bfloat16)
    named = dict(model.named_parameters())
    twin = {k: torch.nn.Parameter(p.detach().clone())
            for k, p in named.items()}
    kw = dict(schedule=lambda t: 1e-2, weight_decay=WD, grad_clip=0.5,
              moment_dtype=torch.bfloat16)
    opt, ref = topt.AdamW(named, **kw), topt.AdamW(twin, **kw)
    n = len(named)
    for step in range(3):
        for k, p in named.items():
            g = (None if k == "1.bias" else
                 values(tuple(p.shape), 30 + step, dev, p.dtype, 1.0))
            p.grad = g
            twin[k].grad = None if g is None else g.clone()
        before = ops.adamw.launches
        seen = counters()
        with torch.profiler.profile():
            opt.step()
        after = counters()
        assert ops.adamw.launches - before == n
        assert (after.get("optim.kernel_tensors", 0)
                - seen.get("optim.kernel_tensors", 0)) == n
        assert (after.get("optim.plain_tensors", 0)
                == seen.get("optim.plain_tensors", 0))

        def plain(*a):
            adamw_reference(*a)
            return False
        with monkeypatch.context() as mp:
            mp.setattr(topt, "adamw", plain)
            ref.step()
        torch.cuda.synchronize()
        for k in named:
            assert torch.equal(bits(named[k].detach()),
                               bits(twin[k].detach())), k
            assert torch.equal(bits(opt.mu[k]), bits(ref.mu[k])), k
            assert torch.equal(bits(opt.nu[k]), bits(ref.nu[k])), k


def test_refuses_what_it_does_not_take(dev):
    p = torch.zeros(8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        adamw(p, None, torch.zeros_like(p), torch.zeros_like(p), 1e-3, B1,
              B2, EPS, 0.0, 1.0)
    p = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="two dtypes"):
        adamw(p, None, torch.zeros_like(p),
              torch.zeros_like(p, dtype=torch.bfloat16), 1e-3, B1, B2, EPS,
              0.0, 1.0)
    q = torch.zeros(8, 8, device=dev)
    with pytest.raises(ValueError, match="layout"):
        adamw(q.t(), None, torch.zeros(8, 8, device=dev),
              torch.zeros(8, 8, device=dev), 1e-3, B1, B2, EPS, 0.0, 1.0)
