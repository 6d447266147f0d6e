"""Build the CUDA sources under `csrc/` at first use, one shared library per
source, all `nvcc` processes started together.

Each library has a plain C interface and is loaded with ctypes: no PyTorch
headers, so `nvcc` takes seconds. It goes to `_build/` beside this file
(listed in .gitignore), named by the source's stem and a hash of the
source, the shared header and the flags, so an edited source builds anew
and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contracted into an FMA, so the epilogues
# round like the plain PyTorch versions. Never add --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entries' code for each tensor dtype they take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _i32, _i64, _u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32)
_ELEMENTWISE = [_vp, _vp, _i64, _u32, _u32, ctypes.c_float, _i32, _vp]
# (argtypes, restype) of each library's C entry
ENTRIES = {
    "int8_mlp": {
        "lr2ppo_int8_mlp": ([_vp] * 8 + [_i64, _i32, _i32, _i32, _vp, _vp],
                            _i32),
        "lr2ppo_int8_mlp_scratch_bytes": ([_i64, _i32, _i32, _i32], _i64)},
    "int8_matmul": {
        "lr2ppo_int8_matmul": ([_vp] * 4 + [_i64] + [_i32] * 4 + [_vp, _vp],
                               _i32),
        "lr2ppo_int8_matmul_scratch_bytes": ([_i64, _i32], _i64),
        # the tp entry: the int32 product, then the epilogue
        "lr2ppo_int8_dot_s32": ([_vp] * 3 + [_i64, _i32, _i32, _vp], _i32),
        "lr2ppo_int8_s32_epilogue": ([_vp] * 4 + [_i64, _i32, _i32, _vp],
                                     _i32)},
    # the elementwise arguments, then the shard's place in the global
    # array: (row0, col0, width, w) for hash, the element offset for Philox
    "hash_dropout": {
        "lr2ppo_hash_dropout": (_ELEMENTWISE, _i32),
        "lr2ppo_hash_dropout_place": (_ELEMENTWISE + [_u32, _u32, _u32, _i64],
                                      _i32),
        "lr2ppo_hash_dropout_geometry": ([_i32], _i32),
        "lr2ppo_hash_dropout_ring_from": ([_i64], _i64)},
    "philox_dropout": {"lr2ppo_philox_dropout": (_ELEMENTWISE + [_i64],
                                                 _i32)},
    "fused_attention": {
        "lr2ppo_fused_attention": (
            [_vp] * 5 + [_i32] * 4 + [_i64] * 9 + [ctypes.c_float, _i32, _vp],
            _i32),
        "lr2ppo_fused_attention_path": ([_i32, _i32, _i32], _i32)},
    # p, g, m, v, norm; rows, cols and the four row strides; the dtypes of
    # p, g and the moments; -lr, b1, 1 - b1, b2, 1 - b2, eps, wd, the step
    # scale and the clip; decay; the stream
    "adamw": {
        "lr2ppo_adamw": ([_vp] * 5 + [_i64] * 6 + [_i32] * 3
                         + [ctypes.c_float] * 9 + [_i32, _vp], _i32)},
    # q, k, v, o, lse, dout, dq, dk, dv, the scratch; batch, heads, seq; the
    # host's 24 strides; the scale in log2 units and the scale; the stream
    "mla_attention_bwd": {
        "lr2ppo_mla_attention_bwd": ([_vp] * 10 + [_i32] * 3 + [_vp]
                                     + [ctypes.c_float] * 2 + [_vp], _i32),
        "lr2ppo_mla_attention_bwd_scratch": ([_i32] * 3, _i64)},
}

# the library of each C entry
LIBRARY_OF = {fn: name for name, fns in ENTRIES.items() for fn in fns}

_libs: dict = {}
_fns: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH); "
                           "the CUDA kernels need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every library that does not exist yet, one nvcc per source,
    all at once. Returns {name: {"path", "seconds", "log"}}; seconds is 0
    for a library that was reused, and the log is the compiler's report of
    each kernel's registers, shared memory and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    nvcc = None
    for name in ENTRIES:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.lr2ppo_cuda_error_string.argtypes = [_i32]
        lib.lr2ppo_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def library_of(entry: str) -> ctypes.CDLL:
    """The loaded library that holds the C entry `entry`."""
    return library(LIBRARY_OF[entry])


def function(entry: str):
    """The C entry `entry` (its library loaded, and built, at first use),
    resolved once: a launch path calls this on every launch."""
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = getattr(library_of(entry), entry)
    return fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.lr2ppo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
