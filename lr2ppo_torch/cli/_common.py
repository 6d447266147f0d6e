"""Dataset and loader builders of the port's CLIs, for both families (the
port's own copy of lr2ppo_tpu/cli/_common.py).

Under dp (--dp above 1, one process per GPU) the training loaders hand each
rank its slice of every global batch (`pod_shard`, from the active mesh,
which the trainer builds first); the eval loaders are whole, and each rank
takes its slice at placement (train/common.py:DeviceCtx.put_eval).
ml_dtypes is imported only where a bfloat16 item dtype asks for it, h5py
only where a grouped LETOR .h5 is read. The LETOR builders take the grouped
queries in memory (`train_q`, `eval_q`) where the caller has them, and read
them from the configured paths otherwise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from lr2ppo_torch.config import Config
from lr2ppo_torch.data import (EvalLoader, LetorQueries, Loader,
                               LTRPointwiseDataset, LTRPPODataset,
                               LTRRewardDataset, MovieNetDataset)
from lr2ppo_torch.data.pipeline import ProcessLoader
from lr2ppo_torch.parallel.mesh import active


def pod_shard():
    """(dp_rank, dp) of the active mesh for a training Loader's `shard`, or
    None at dp 1 (the JAX package's pod_shard, by dp rank: the ranks of one
    tp group read the same rows)."""
    mesh = active()
    return (mesh.dp_rank, mesh.dp) if mesh.dp > 1 else None


def force_family(cfg: Config, family: str) -> Config:
    return cfg.replace(model=dataclasses.replace(cfg.model, family=family))


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
                             prefetch_depth=cfg.data.prefetch_depth,
                             shard=pod_shard())
    # reuse_buffers: fresh multi-MB batch allocations page-fault far
    # slower than buffer reuse; the PPO trainer detects
    # loader.reuse_buffers and copies anything it retains across the sweep
    return Loader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed + seed,
                  num_workers=cfg.data.num_workers,
                  prefetch_depth=cfg.data.prefetch_depth,
                  reuse_buffers=True, shard=pod_shard())


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


def letor_queries(path: str, split: str = "train") -> LetorQueries:
    """`path` is either a grouped .h5 file or a directory holding
    {train,test}.h5 (reference ppo_trad.py:64-68); `split` picks the file
    for directory paths — eval callers MUST pass 'test' or validation
    silently runs on training queries."""
    if os.path.isdir(path):
        return LetorQueries.from_dir(path, split)
    return LetorQueries.from_h5(path)


def letor_eval_loader(cfg: Config, ds_cls, path: str = "",
                      queries: Optional[LetorQueries] = None) -> EvalLoader:
    """Test-split EvalLoader with one bucket sized to the largest query
    (the shared recipe of every tabular evaluator)."""
    evq = queries or letor_queries(
        path or cfg.data.dev_path or cfg.data.test_path, "test")
    docs = max(g.shape[0] for g in evq.groups.values())
    ds = (ds_cls(evq, False) if ds_cls is LTRPPODataset else ds_cls(evq))
    return EvalLoader(ds, buckets=[docs], batch_size=cfg.batch_size)


def letor_pointwise_loaders(cfg: Config,
                            train_q: Optional[LetorQueries] = None,
                            eval_q: Optional[LetorQueries] = None):
    train = Loader(
        LTRPointwiseDataset(train_q or letor_queries(cfg.data.train_path)),
        cfg.batch_size, shuffle=True, seed=cfg.seed,
        num_workers=cfg.data.num_workers, reuse_buffers=True,
        shard=pod_shard())
    ev = letor_eval_loader(cfg, LTRPointwiseDataset, queries=eval_q)
    return train, ev


def letor_two_data_loaders(cfg: Config, train_qs=None, eval_qs=None):
    """The 2-data unification trainer's inputs: domain A (--train_path,
    --dev_path) and domain B (--train_path2, --dev_path2). Returns the
    config with trad_dims set to the two domains' raw feature widths
    (pointwise_2data_trad.py:136-151), a training Loader and a test-split
    EvalLoader of each domain."""
    qs = train_qs or [letor_queries(p) for p in (cfg.data.train_path,
                                                 cfg.data.train_path2)]
    dims = [next(iter(q.groups.values())).shape[1] - 2 for q in qs]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trad_dims=dims))
    # reuse_buffers: fit_two consumes each batch before the next yield
    loaders = [Loader(LTRPointwiseDataset(q), cfg.batch_size, shuffle=True,
                      seed=cfg.seed, num_workers=cfg.data.num_workers,
                      reuse_buffers=True, shard=pod_shard()) for q in qs]
    evs = [letor_eval_loader(cfg, LTRPointwiseDataset, path=p,
                             queries=eval_qs[i] if eval_qs else None)
           for i, p in enumerate((cfg.data.dev_path, cfg.data.dev_path2))]
    return cfg, loaders, evs


def letor_reward_loaders(cfg: Config, relevance_classes: int = 5,
                         train_q: Optional[LetorQueries] = None,
                         eval_q: Optional[LetorQueries] = None):
    train_ds = LTRRewardDataset(
        train_q or letor_queries(cfg.data.train_path),
        max_tags=cfg.data.max_tags, relevance_classes=relevance_classes,
        seed=cfg.seed)
    # eval width is the reference's FIXED 20 pairs/query (its dataset
    # ctor default — reward_trad.py:88 never threads args.max_tags), so
    # reported accuracies are comparable at the same variance
    ev_ds = LTRRewardDataset(
        eval_q or letor_queries(cfg.data.dev_path or cfg.data.test_path,
                                "test"),
        max_tags=20, relevance_classes=relevance_classes,
        seed=cfg.seed + 999)
    return (Loader(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                   num_workers=cfg.data.num_workers, reuse_buffers=True,
                   shard=pod_shard()),
            Loader(ev_ds, cfg.batch_size, shuffle=False,
                   num_workers=cfg.data.num_workers, reuse_buffers=True))


def letor_ppo_loaders(cfg: Config, train_q: Optional[LetorQueries] = None,
                      eval_q: Optional[LetorQueries] = None):
    q = train_q or letor_queries(cfg.data.train_path)

    def make_train_loader(epoch: int) -> Loader:
        ds = LTRPPODataset(q, True, max_tags=cfg.data.max_tags,
                           seed=cfg.seed + epoch)
        return Loader(ds, cfg.batch_size, shuffle=True,
                      seed=cfg.seed + epoch,
                      num_workers=cfg.data.num_workers, shard=pod_shard())

    ev = letor_eval_loader(cfg, LTRPPODataset, queries=eval_q)
    return make_train_loader, ev
