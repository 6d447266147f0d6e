"""Device selection: explicit, never silent."""

from __future__ import annotations

import torch


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
