"""Device and compute-dtype selection: explicit, never silent."""

from __future__ import annotations

import torch


# --compute_dtype values the port runs
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a --compute_dtype value; raises on others."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"--compute_dtype {name!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def require_cuda() -> torch.device:
    """The first CUDA device; raises where there is none. Also turns TF32
    off for float32 products and convolutions, so float32 means float32
    (cuDNN's default is TF32)."""
    if not torch.cuda.is_available():
        raise RuntimeError("lr2ppo_torch: no CUDA device (torch.cuda."
                           "is_available() is False); this path runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
