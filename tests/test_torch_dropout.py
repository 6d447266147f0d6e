"""The port's dropout: hash dropout's plain version against the JAX
package's `_apply` bit for bit, the Philox counterpart of the TPU dropout
kernel (statistics, and exact values where it keeps), and module_dropout's
precedence. On the CPU both wrappers take their plain versions; the kernels
are held against them on the card (tests/test_torch_dropout_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lr2ppo_tpu.ops import hash_dropout as jhd
from lr2ppo_tpu.ops.pallas_dropout import tpu_dropout
from lr2ppo_torch.ops import dropout as td
from lr2ppo_torch.ops import fast_dropout as tfd
from lr2ppo_torch.ops import hash_dropout as thd

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEEDS = [0, 1, -1, -2**31, 2**31 - 1, 987654321, -123457]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hash_plain_version_is_bit_equal_to_jax(dtype, rate):
    """Forward and cotangent, f32 and bf16, int32 seeds including negative
    ones (JAX wraps them to uint32 with astype)."""
    jdt, tdt = DTYPES[dtype]
    x, g = _x((3, 37, 41)), _x((3, 37, 41), 1)
    for seed in SEEDS:
        jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
        ref, vjp = jax.vjp(lambda a: jhd.hash_dropout(a, jnp.int32(seed),
                                                      rate), jx)
        (ref_g,) = vjp(jg)
        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        out = thd.hash_dropout(tx, seed, rate)
        out.backward(torch.from_numpy(g).to(tdt))
        np.testing.assert_array_equal(_np(out.detach()),
                                      np.asarray(ref, np.float32))
        np.testing.assert_array_equal(_np(tx.grad),
                                      np.asarray(ref_g, np.float32))


# the kernel's plans at a small geometry (the ring: chunks of 64 bytes, 3
# stages, 2 SMs of 2 blocks; the register path: 4 threads a block, 2
# blocks an SM): (values, place) cases by their size in packs and chunks;
# a place is (row0, col0, width, w)
PLAN = {"chunk_bytes": 64, "stages": 3, "sms": 2, "blocks_per_sm": 2,
        "threads": 4, "reg_blocks_per_sm": 2}
# global indices past 2^16, so the hash's high half counts
SPLIT_PLACE = (2000, 5, 37, 13)       # w divides no chunk, col0 != 0
DP_PLACE = (7000, 0, 11, 11)          # a dp shard: the fast path at row0 7000


def _plan_cases(elem_bytes):
    pack, chunk = 16 // elem_bytes, PLAN["chunk_bytes"] // elem_bytes
    stages = PLAN["stages"]
    ring = PLAN["sms"] * PLAN["blocks_per_sm"] * stages * chunk
    return {"under_a_pack": (pack - 1, None), "one_value": (1, None),
            "one_chunk": (chunk, None),
            "chunk_less_a_pack": (chunk - pack, None),
            "chunk_and_a_pack": (chunk + pack, None),
            "stages_less_one": (stages * chunk - 1, None),
            "stages_and_one": (stages * chunk + 1, None),
            "wraps_the_ring": (3 * ring + 5, None),
            "split_place": (13 * 60, SPLIT_PLACE),
            "dp_shard": (11 * 50, DP_PLACE)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(_plan_cases(4)))
@pytest.mark.parametrize("path", ["ring", "registers"])
def test_kernel_plan_is_bit_equal_to_plain_and_jax(path, case, dtype):
    """The kernel's plan on either path (ops/hash_dropout.py:
    plan_keep_mask: the ring's chunks a block, stage order and refills,
    or the register path's strides; each pack's first global index on the
    fast and the split path; the hash as the kernel splits it; the final
    values) gives the plain version's values bit for bit, and JAX's
    `_apply` over the global array at the shard's elements."""
    jdt, tdt = DTYPES[dtype]
    elem_bytes = torch.empty((), dtype=tdt).element_size()
    n, place = _plan_cases(elem_bytes)[case]
    seed, rate = -123457, 0.3
    x = torch.from_numpy(_x((n,), n)).to(tdt)
    keep = thd.plan_keep_mask(n, elem_bytes, seed, rate, place,
                              ring=path == "ring", **PLAN)
    got = torch.where(keep, x * torch.tensor(thd.scale_for(rate, tdt),
                                             dtype=tdt),
                      torch.zeros((), dtype=tdt))
    assert torch.equal(got, thd.hash_dropout_reference(x, seed, rate, place))
    row0, col0, width, w = place or (0, 0, n, n)
    glob = np.zeros((row0 + n // w, width), np.float32)
    glob[row0:, col0:col0 + w] = _np(x).reshape(-1, w)
    ref = np.asarray(jhd._apply(jnp.asarray(glob, jdt), jnp.int32(seed),
                                rate), np.float32)
    np.testing.assert_array_equal(_np(got),
                                  ref[row0:, col0:col0 + w].reshape(-1))


def test_kernel_plan_at_the_card_geometry():
    """Both plans at the kernel's own geometry (132 SMs; the ring's 16 KB
    chunks, 4 stages, 2 blocks an SM; 256 threads, 8 blocks an SM on the
    register path): a size past three chunks with a ragged tail; the path
    is chosen by the L2's 50 MiB."""
    n = thd.CHUNK_BYTES // 4 * 3 + 7
    want = thd.keep_mask(0, n, 11, 0.1)
    for ring in (True, False):
        assert torch.equal(thd.plan_keep_mask(n, 4, 11, 0.1, ring=ring),
                           want)
    assert thd.L2_BYTES == 50 * 2**20


def test_hash_scale_is_rounded_to_the_dtype():
    assert thd.scale_for(0.1, torch.bfloat16) == 1.109375
    assert thd.scale_for(0.1, torch.float32) == float(np.float32(
        4294967296.0 / thd.threshold(0.1)))
    assert thd.threshold(0.0) == 4294967295


@pytest.mark.parametrize("kind", ["hash", "philox"])
def test_no_tensor_is_saved_for_the_backward(kind):
    fn = thd.hash_dropout if kind == "hash" else td.philox_dropout
    saved = []
    x = torch.randn(64, 32, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = fn(x, 3, 0.3)
    y.sum().backward()
    assert saved == []
    # the cotangent gets the forward's mask and scale
    np.testing.assert_array_equal(_np(x.grad), _np(fn(torch.ones_like(x), 3,
                                                      0.3)))


def test_hash_cotangent_is_taken_contiguous():
    """The hash index is the flat row-major position: a transposed
    cotangent is made contiguous before the mask is applied."""
    x = torch.randn(8, 6, requires_grad=True)
    g = torch.randn(6, 8).t()
    thd.hash_dropout(x, 5, 0.4).backward(g)
    np.testing.assert_array_equal(
        _np(x.grad), _np(thd.hash_dropout_reference(g.contiguous(), 5, 0.4)))


def test_philox_matches_the_random123_known_answer():
    """Philox4x32-10 of counter 0 under key 0 (Random123's kat_vectors)."""
    bits = td.philox_bits(torch.tensor([0]), 0)[0].tolist()
    assert bits == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_rate_zero_is_the_identity_as_in_jax():
    x = torch.from_numpy(_x((8, 128)))
    assert td.philox_dropout(x, 3, 0.0) is x
    ref = tpu_dropout(jnp.asarray(x.numpy()), jnp.int32(3), 0.0,
                      interpret=pltpu.InterpretParams())
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_philox_keep_share_scale_and_backward_mask(dtype, rate):
    """The bits cannot match the TPU's, so against JAX the check is
    statistical: the keep share lies within 5 sigma of 1 - rate. Where an
    element is kept its value is exactly the TPU kernel's x * scale (its
    CPU interpreter keeps every element). The backward applies the same
    mask, and a seed reproduces it."""
    jdt, tdt = DTYPES[dtype]
    x = _x((300, 3, 128))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = td.philox_dropout(tx, 42, rate)
    kept = _np(out.detach()) != 0
    n = kept.size
    assert abs(kept.mean() - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5
    all_kept = np.asarray(tpu_dropout(jnp.asarray(x, jdt), jnp.int32(42),
                                      rate, interpret=pltpu.InterpretParams()),
                          np.float32)
    np.testing.assert_array_equal(_np(out.detach())[kept], all_kept[kept])
    g = torch.from_numpy(_x((300, 3, 128), 2)).to(tdt)
    out.backward(g)
    np.testing.assert_array_equal(_np(tx.grad) != 0, kept & (_np(g) != 0))
    again = td.philox_dropout(torch.from_numpy(x).to(tdt), 42, rate)
    assert torch.equal(again, out.detach())
    other = td.philox_dropout(torch.from_numpy(x).to(tdt), 43, rate)
    assert 0.4 < float(((other != 0) == (again != 0)).float().mean()) < 0.95


def test_plain_versions_chunk_without_seams(monkeypatch):
    """The plain versions run in chunks to bound their int64 temporaries;
    the chunk size changes nothing."""
    x = torch.from_numpy(_x((1000, 7)))
    want = (thd.hash_dropout_reference(x, 9, 0.2),
            td.philox_dropout_reference(x, 9, 0.2))
    monkeypatch.setattr(thd, "_CHUNK", 100)
    monkeypatch.setattr(td, "_CHUNK", 100)
    assert torch.equal(thd.hash_dropout_reference(x, 9, 0.2), want[0])
    assert torch.equal(td.philox_dropout_reference(x, 9, 0.2), want[1])


def test_module_dropout_precedence(monkeypatch):
    """hash > fast > pallas (size-gated) > canonical, as in
    lr2ppo_tpu/ops/hash_dropout.py:module_dropout; one seed per active
    site from the caller's generator."""
    calls = []
    monkeypatch.setattr(thd, "hash_dropout",
                        lambda x, s, r: calls.append("hash") or x)
    monkeypatch.setattr(td, "philox_dropout",
                        lambda x, s, r: calls.append("pallas") or x)
    monkeypatch.setattr(thd, "canonical_dropout",
                        lambda x, s, r: calls.append("canonical") or x)
    monkeypatch.setattr(tfd, "packed_dropout",
                        lambda x, s, r: calls.append("fast") or x)
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4, 4)
    md = thd.module_dropout
    assert md(x, 0.1, True, None, True) is x            # deterministic
    assert md(x, 0.0, False, None, True) is x           # rate 0
    assert calls == []
    md(x, 0.1, False, gen, True, True, True, 1)
    md(x, 0.1, False, gen, False, False, True, 16)      # at the gate
    md(x, 0.1, False, gen, False, False, True, 17)      # below it
    md(x, 0.1, False, gen, False, False, False)
    md(x, 0.1, False, gen, False, True, True, 1)        # fast > pallas
    assert calls == ["hash", "pallas", "canonical", "canonical", "fast"]
    with pytest.raises(ValueError, match="Generator"):
        md(x, 0.1, False, None, True)


def test_canonical_dropout_keeps_the_share_and_scale():
    x = torch.ones(200, 200)
    y = thd.canonical_dropout(x, 7, 0.25)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))
    assert torch.equal(y, thd.canonical_dropout(x, 7, 0.25))


def test_draw_seed_is_an_int32_from_the_generator():
    a = [thd.draw_seed(torch.Generator().manual_seed(1)) for _ in range(2)]
    assert a[0] == a[1] and -2**31 <= a[0] < 2**31
