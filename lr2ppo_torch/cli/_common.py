"""MovieNet dataset and loader builders for the port's CLIs (the MovieNet
half of lr2ppo_tpu/cli/_common.py, copied).

The port runs on one GPU, so the loaders take no process shard.
ml_dtypes is imported only where a bfloat16 item dtype asks for it.
"""

from __future__ import annotations

import os

from lr2ppo_torch.config import Config
from lr2ppo_torch.data import EvalLoader, Loader, MovieNetDataset
from lr2ppo_torch.data.pipeline import ProcessLoader


def h5_path_for(json_path: str, cfg: Config) -> str:
    """clean_feat.h5 lives next to the split JSONs (ppo.py:65-66)."""
    root = os.path.dirname(json_path) or cfg.data.embed_root
    cand = os.path.join(root, "clean_feat.h5")
    if os.path.exists(cand):
        return cand
    return os.path.join(cfg.data.embed_root, "clean_feat.h5")


def _item_dtype(cfg: Config):
    if cfg.data.item_dtype in ("bfloat16", "bf16"):
        import ml_dtypes

        return ml_dtypes.bfloat16
    import numpy as np

    return np.dtype(cfg.data.item_dtype)


def _want_preload(cfg: Config, h5_path: str) -> bool:
    """'auto': cache in RAM when the converted embeddings fit in half the
    available memory — on a single-core host the per-item h5 read/convert
    IS the input bottleneck (PARITY.md perf notes)."""
    if cfg.data.preload == "always":
        return True
    if cfg.data.preload == "never" or not os.path.exists(h5_path):
        return False
    import numpy as np

    ratio = np.dtype(_item_dtype(cfg)).itemsize / 4.0
    need = os.path.getsize(h5_path) * ratio
    try:
        import re

        with open("/proc/meminfo") as f:
            avail = int(re.search(r"MemAvailable:\s+(\d+) kB",
                                  f.read()).group(1)) * 1024
    except Exception:
        avail = 8 << 30
    return need < 0.5 * avail


def _use_process_loader(cfg: Config) -> bool:
    if cfg.data.loader == "auto":
        return (os.cpu_count() or 1) >= 4
    return cfg.data.loader == "process"


def movienet_train_loader(cfg: Config, mode: str, seed: int = 0) -> Loader:
    h5p = h5_path_for(cfg.data.train_path, cfg)
    ds = MovieNetDataset(
        cfg.data.train_path, h5p, mode,
        max_tags=cfg.data.max_tags, max_imgs=cfg.data.max_imgs,
        seed=cfg.seed + seed,   # --seed must vary the data sampling too
        item_dtype=_item_dtype(cfg), preload=_want_preload(cfg, h5p))
    if _use_process_loader(cfg):
        # shared-memory worker processes: sidestep the GIL and h5py's
        # global API lock (PPO copies batches out of the shared slots
        # before retaining them — train/ppo.py)
        return ProcessLoader(ds, cfg.batch_size, shuffle=True,
                             seed=cfg.seed + seed,
                             num_workers=cfg.data.num_workers,
                             prefetch_depth=cfg.data.prefetch_depth)
    # reuse_buffers: fresh multi-MB batch allocations page-fault far
    # slower than buffer reuse; the PPO trainer detects
    # loader.reuse_buffers and copies anything it retains across the sweep
    return Loader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed + seed,
                  num_workers=cfg.data.num_workers,
                  prefetch_depth=cfg.data.prefetch_depth,
                  reuse_buffers=True)


def movienet_eval_loader(cfg: Config, mode: str = "eval",
                         path: str = "") -> object:
    path = path or cfg.data.dev_path
    h5p = h5_path_for(path, cfg)
    ds = MovieNetDataset(path, h5p, mode,
                         max_tags=cfg.data.max_tags,
                         max_imgs=cfg.data.max_imgs, seed=cfg.seed,
                         item_dtype=_item_dtype(cfg),
                         preload=_want_preload(cfg, h5p))
    if mode == "eval":
        return EvalLoader(ds, cfg.data.eval_tag_buckets, cfg.batch_size)
    return Loader(ds, cfg.batch_size, shuffle=False,
                  num_workers=cfg.data.num_workers)
