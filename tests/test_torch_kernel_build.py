"""The port's kernel build without a card: the ctypes signatures that
lr2ppo_torch/kernels/build.py declares for each library's C entries against
their definitions in the CUDA sources, and the hash that decides which
libraries rebuild. Imports torch only; nothing here compiles."""

import ctypes
import re
import shutil

import pytest

from lr2ppo_torch.kernels import build

# the C parameter and return types of the entries, as ctypes declares them
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int,
           "uint32_t": ctypes.c_uint32, "float": ctypes.c_float}
DEFINITION = re.compile(r"^(int|long long) (lr2ppo_\w+)\(([^)]*)\)\s*\{",
                        re.M)


def _definitions(name: str) -> dict:
    """{entry: ([parameter ctypes], return ctype)} of csrc/<name>.cu."""
    src = (build.CSRC / f"{name}.cu").read_text()
    out = {}
    for ret, fn, params in DEFINITION.findall(src):
        types = [" ".join(p.split()[:-1]).replace(" *", "*")
                 for p in params.split(",")]
        out[fn] = ([C_TYPES[t] for t in types], C_TYPES[ret])
    return out


@pytest.mark.parametrize("name", sorted(build.ENTRIES))
def test_entries_match_the_sources(name):
    """Every entry build.py binds is defined in the source with the same
    parameters and return type, and the source defines no other: a pointer
    declared as an int would be cut to 32 bits."""
    declared = {fn: (list(a), r) for fn, (a, r) in build.ENTRIES[name].items()}
    assert declared == _definitions(name)


def test_int8_matmul_binds_its_scratch_entry():
    """K2 takes a global scratch the wrapper sizes through its own entry:
    (rows, k) -> bytes, and the launch takes the scratch before the
    stream."""
    entries = build.ENTRIES["int8_matmul"]
    assert entries["lr2ppo_int8_matmul_scratch_bytes"] == (
        [ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong)
    args, ret = entries["lr2ppo_int8_matmul"]
    assert ret == ctypes.c_int and len(args) == 11
    assert args[-2:] == [ctypes.c_void_p, ctypes.c_void_p]


def test_a_shared_header_rebuilds_both_int8_kernels(tmp_path, monkeypatch):
    """K1 and K2 include hopper.cuh: an edit there names new libraries for
    both, while an edit to one kernel's source renames only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.ENTRIES}
    assert '#include "hopper.cuh"' in (csrc / "int8_mlp.cu").read_text()
    assert '#include "hopper.cuh"' in (csrc / "int8_matmul.cu").read_text()

    with open(csrc / "int8_matmul.cu", "a") as f:
        f.write("\n// edited\n")
    after = {name: build.library_path(name) for name in build.ENTRIES}
    assert [n for n in build.ENTRIES if after[n] != before[n]] == [
        "int8_matmul"]

    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    again = {name: build.library_path(name) for name in build.ENTRIES}
    assert again["int8_mlp"] != after["int8_mlp"]
    assert again["int8_matmul"] != after["int8_matmul"]


def test_mla_backward_entry_passes_pointers_whole():
    """The latent attention backward's C entry takes its ten tensors, the
    host's stride array and the stream as c_void_p (an int would cut a
    pointer to 32 bits), and `_launch_bwd`, which the benchmark wraps by
    name, keeps its signature."""
    import inspect

    from lr2ppo_torch.ops import mla_attention

    args, ret = build.ENTRIES["mla_attention_bwd"]["lr2ppo_mla_attention_bwd"]
    assert ret == ctypes.c_int and len(args) == 17
    assert args[:10] == [ctypes.c_void_p] * 10
    assert args[10:13] == [ctypes.c_int] * 3
    assert args[13] == ctypes.c_void_p and args[16] == ctypes.c_void_p
    assert args[14:16] == [ctypes.c_float] * 2
    assert build.ENTRIES["mla_attention_bwd"][
        "lr2ppo_mla_attention_bwd_scratch"] == ([ctypes.c_int] * 3,
                                                 ctypes.c_longlong)
    params = list(inspect.signature(mla_attention._launch_bwd).parameters)
    assert params == ["q", "k", "v", "o", "lse", "do", "scale"]
