"""The native (C++) LETOR parser, loaded with ctypes (the port's own copy of
lr2ppo_tpu/native: `parser.cpp` is the same source).

The shared library is built by g++ at first use, never at import, into
`_build/` beside this file (listed in .gitignore), named by a hash of the
source, the compiler and the flags, so an edited source builds anew and an
unchanged one is reused. The build goes to a per-process temporary file and
is renamed into place, so an interrupted or concurrent build never leaves a
truncated library behind.

Nothing here falls back to numpy: a build that fails, a file the parser
cannot read and a line it rejects all raise (where the JAX package's
parse_svmlight and parse_tsv return None). The numpy parser is chosen by
the caller (`parse_svmlight_file(..., use_native=False)`, the CLIs'
--use_native_loader 0).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "parser.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """The library's path for this source, compiler and flags."""
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join((CXX,) + FLAGS).encode())
    return os.path.join(BUILD_DIR, f"parser-{key.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([CXX, *FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    except (OSError, subprocess.CalledProcessError) as e:
        log = getattr(e, "stderr", "") or ""
        raise RuntimeError(
            f"the native LETOR parser did not build with {CXX!r}: {e}\n{log}"
            "\nPass --use_native_loader 0 (use_native=False) for the numpy "
            "parser") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The parser library, built first where it is missing; raises where
    the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.parse_svmlight.restype = ctypes.POINTER(ctypes.c_float)
        lib.parse_svmlight.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_long)]
        lib.parse_tsv.restype = ctypes.POINTER(ctypes.c_float)
        lib.parse_tsv.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(ctypes.c_long)]
        lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib



def parse_svmlight(path: str, num_features: int) -> np.ndarray:
    """svmlight -> (rows, 2+F) float32 [label, qid, feats...], stably sorted
    by qid, as the numpy parser of data/letor.py gives it. Raises where the
    file cannot be read or a data line does not parse."""
    lib = load()
    n = ctypes.c_long(0)
    ptr = lib.parse_svmlight(path.encode(), num_features, ctypes.byref(n))
    if not ptr:
        raise ValueError(
            f"the native parser could not read {path} as svmlight with "
            f"{num_features} features (a missing file, a malformed line or "
            "a feature index out of range)")
    shape = (n.value, 2 + num_features)
    try:                                # malloc(0) needs its free too
        arr = (np.ctypeslib.as_array(ptr, shape=shape).copy() if n.value
               else np.zeros(shape, np.float32))
    finally:
        lib.free_buffer(ptr)
    return arr[np.argsort(arr[:, 1], kind="stable")]


def parse_tsv(path: str) -> Optional[np.ndarray]:
    """A numeric tsv (tabs or spaces between values, blank lines skipped)
    -> (rows, cols) float32; None for a file with no values, as the JAX
    package gives. Raises where the file cannot be read or its rows differ
    in length, where the JAX package returns None."""
    lib = load()
    rows, cols = ctypes.c_long(0), ctypes.c_long(0)
    ptr = lib.parse_tsv(path.encode(), ctypes.byref(rows),
                        ctypes.byref(cols))
    if not ptr:
        raise ValueError(
            f"the native parser could not read {path} as a numeric tsv (a "
            "missing file, or rows of different lengths)")
    try:                                # malloc(0) needs its free too
        if rows.value == 0:
            return None
        return np.ctypeslib.as_array(
            ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.free_buffer(ptr)
