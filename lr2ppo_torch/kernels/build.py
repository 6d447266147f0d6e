"""Build the CUDA sources under `csrc/` into one shared library, at first use.

The library has a plain C interface and is loaded with ctypes: no PyTorch
headers, so `nvcc` takes seconds. It goes to `_build/` beside this file
(listed in .gitignore), named by a hash of the sources and the flags, so an
edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contracted into an FMA, so the epilogues
# round like the plain PyTorch versions. Never add --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH); "
                           "the CUDA kernels need the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lr2ppo_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library unless it exists. Returns its path, the seconds
    the build took (0 when it was reused) and the compiler's report, which
    lists each kernel's registers, shared memory and spills."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lr2ppo_int8_mlp.argtypes = [vp] * 8 + [i64, i32, i32, i32, vp]
        lib.lr2ppo_int8_mlp.restype = i32
        lib.lr2ppo_cuda_error_string.argtypes = [i32]
        lib.lr2ppo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.lr2ppo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
