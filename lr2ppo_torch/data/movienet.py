"""LRMovieNet dataset: JSON tag lists + HDF5 precomputed embeddings (the
port's own copy of lr2ppo_tpu/data/movienet.py; h5py is imported at first
read, so the module imports where h5py is missing).

Layout (reference finetune/ppo.py:58-151): JSON items
  {"id": str, "tags": [{"tag": str, "target": 0|1|2}, ...], "index"?: [[i,j]...]}
and clean_feat.h5 with per-item groups holding
  text_emb: (tags, 196, 768) float   img_emb: (1, n_imgs, 768) float.

Four sampling modes matching the three stage dataloaders + shared eval:

  pointwise — truncate/augment tag lists to max_tags favoring non-zero
              targets (pointwise.py:96-119)
  reward    — pre-built pair lists from item['index'], chosen/reject
              4-index patterns with a fair coin swap
              (reward_pair_dataloader.py:127-143); eval mode samples one
              tag per class and orders by target (ibid.:144-166)
  ppo       — max_tags random 2-tag subsets per item, targets ignored
              (ppo.py:92-105)
  eval      — full tag list per item (padded/bucketed by the EvalLoader)

Every mode pads/cycles images to max_imgs with a per-item shuffle
(ppo.py:125-138). All outputs are numpy with static shapes per mode.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


def _pad_images(img: np.ndarray, max_imgs: int, rng: np.random.Generator):
    n = img.shape[0]
    if n == 0:
        # an item with zero decodable keyframes would otherwise die with
        # a bare ZeroDivisionError deep in a prefetch worker hours into
        # a run (the reference's `imgs[i % len]` cycling has the same
        # failure); name the problem instead
        raise ValueError("item has no image embeddings (0 keyframes); "
                         "drop it from the data JSON or re-extract")
    img = img[rng.permutation(n)]
    if n >= max_imgs:
        return np.ascontiguousarray(img[:max_imgs])
    reps = [img[i % n] for i in range(n, max_imgs)]
    return np.concatenate([img, np.stack(reps)], axis=0)


def _reward_eval_pair(tags: List[dict], pick: List[int],
                      rng: np.random.Generator):
    """get_index (reward_pair_dataloader.py:77-84): random 2 of the subset,
    chosen = ordered-correctly 4-index, reject = swapped tail."""
    idx = list(rng.permutation(len(pick))[:2])
    if tags[pick[idx[0]]]["target"] >= tags[pick[idx[1]]]["target"]:
        return idx + idx, idx + [idx[1], idx[0]]
    return idx + [idx[1], idx[0]], idx + idx


class MovieNetDataset:
    """Index-addressable host dataset; `get(i)` returns a dict of numpy
    arrays. Rebuild per epoch for fresh pair sampling (ppo.py:816)."""

    def __init__(self, json_path: str, h5_path: str, mode: str,
                 max_tags: int = 32, max_imgs: int = 16,
                 seed: int = 0, data: Optional[list] = None,
                 h5_file=None, item_dtype=np.float32,
                 preload: bool = False):
        assert mode in ("pointwise", "reward", "reward_eval", "ppo", "eval")
        self.mode = mode
        self.max_imgs = max_imgs
        # emit floats at this dtype per item: bfloat16 halves collate
        # memcpy, host RAM (the PPO memory buffer), and H2D bytes, and
        # the trainers cast to the compute dtype anyway (common.py)
        self.item_dtype = np.dtype(item_dtype)
        self.seed = seed
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        self._ram: Optional[Dict[str, tuple]] = None
        self._want_preload = preload
        import threading as _threading

        # serialize the lazy preload: without it every prefetch thread
        # that sees _ram is None builds its own full RAM copy (N x the
        # multi-GB load + a transient N x RAM spike)
        self._preload_lock = _threading.Lock()
        if data is None:
            with open(json_path) as f:
                data = json.load(f)
        self._h5_path = h5_path
        self._h5_shared = h5_file       # injected handle (tests)
        self._h5_local = None
        if h5_file is None:
            import threading

            # HDF5 serializes every access through one file handle's
            # global lock; per-thread handles let the prefetch pool's
            # workers read concurrently (the reference leaned on 32
            # DataLoader processes for the same reason, ppo.py:689)
            self._h5_local = threading.local()

        # Per-example plan: (item_id, tag_index, chosen_index, reject_index)
        self.examples: List[tuple] = []
        self.targets_of: Dict[str, List[int]] = {}
        self.tag_names: Dict[str, List[str]] = {}
        for item in data:
            iid = item["id"]
            tags = item["tags"]
            t = len(tags)
            if t == 0:
                raise ValueError(
                    f"item {iid!r} has no tags (mode={mode})")
            self.targets_of[iid] = [int(x["target"]) for x in tags]
            self.tag_names[iid] = [str(x.get("tag", j))
                                   for j, x in enumerate(tags)]
            if mode == "pointwise":
                self.examples.append((iid, self._pointwise_plan(tags, max_tags),
                                      None, None))
            elif mode == "reward":
                for pair in item.get("index", []):
                    if self.rng.random() < 0.5:
                        ch, rj = [0, 1, 0, 1], [0, 1, 1, 0]
                    else:
                        ch, rj = [1, 0, 0, 1], [1, 0, 1, 0]
                    self.examples.append((iid, list(pair), ch, rj))
            elif mode == "reward_eval":
                by_cls = {c: [i for i, x in enumerate(tags)
                              if int(x["target"]) == c] for c in range(3)}
                if min(len(v) for v in by_cls.values()) == 0:
                    continue
                for _ in range(max_tags):
                    pick = [by_cls[c][self.rng.integers(len(by_cls[c]))]
                            for c in range(3)]
                    ch, rj = _reward_eval_pair(tags, pick, self.rng)
                    # ch/rj index into the 3-tag subset `pick`
                    self.examples.append((iid, pick, ch, rj))
            elif mode == "ppo":
                if t < 2:
                    # a 1-tag item can't form a pair: the reference's
                    # random.sample(range(tags_num), 2) would raise;
                    # silently broadcasting one tag into a 2-row batch
                    # slot would train on tag-vs-itself. Skip, like
                    # reward_eval skips class-deficient items.
                    continue
                # the pair itself is drawn in get() from the (epoch,
                # item) rng: set_epoch(n) alone gives the fresh per-epoch
                # pair sampling of the reference's per-epoch trainset
                # rebuild (ppo.py:816) without re-reading JSON/h5,
                # re-preloading RAM, or re-forking loader workers
                for _ in range(max_tags):
                    self.examples.append((iid, None, None, None))
            else:  # eval
                self.examples.append((iid, list(range(t)), None, None))

    @staticmethod
    def _pointwise_plan(tags: List[dict], max_tags: int) -> List[int]:
        t = len(tags)
        if t > max_tags:
            return list(range(max_tags))
        idx = list(range(t))
        add = [i for i in range(t) if int(tags[i]["target"]) != 0]
        for i in range(t, max_tags):
            idx.append(add[i % len(add)] if add else i % t)
        return idx

    def reset_handles(self) -> None:
        """Drop inherited HDF5 handles (called by ProcessLoader workers
        right after fork — handles do not survive it)."""
        if self._h5_local is not None:
            import threading

            self._h5_local = threading.local()

    def set_epoch(self, epoch: int) -> None:
        """Reseeds the per-item image shuffle (the reference reshuffles
        every __getitem__ via global RNG, ppo.py:125-138; here it is
        deterministic per (epoch, item) so re-fetches are exact)."""
        self.epoch = epoch

    def preload(self) -> "MovieNetDataset":
        """Cache every item's embeddings in RAM at item_dtype. On this
        class of host (single core, 125 GB RAM) the h5 read + dtype
        convert per item IS the input bottleneck; a one-time pass turns
        `get` into pure slicing + one memcpy."""
        with self._preload_lock:
            if self._ram is None:
                ram: Dict[str, tuple] = {}
                h5 = self.h5
                # only items that produced examples: ppo mode skips
                # 1-tag items and reward_eval skips class-deficient
                # ones AFTER registering them in targets_of — caching
                # those would hold multi-GB of embeddings no example
                # ever reads
                live = {ex[0] for ex in self.examples}
                for iid in (i for i in self.targets_of if i in live):
                    grp = h5[str(iid)]
                    text = np.asarray(grp["text_emb"][:]).astype(
                        self.item_dtype, copy=False)
                    img = np.asarray(grp["img_emb"][:])[0].astype(
                        self.item_dtype, copy=False)
                    ram[iid] = (np.ascontiguousarray(text),
                                np.ascontiguousarray(img))
                self._ram = ram
        return self

    @property
    def h5(self):
        if self._h5_shared is not None:
            return self._h5_shared
        handle = getattr(self._h5_local, "handle", None)
        if handle is None:
            import h5py

            handle = h5py.File(self._h5_path, "r")
            self._h5_local.handle = handle
        return handle

    def __len__(self) -> int:
        return len(self.examples)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        if self._want_preload and self._ram is None:
            self.preload()
        iid, tag_index, ch, rj = self.examples[i]
        # deterministic per (epoch, item): re-fetching an item yields the
        # same tensors (lets PPO re-materialize sweep batches exactly)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        if tag_index is None:      # ppo mode: fresh pair every epoch
            t = len(self.targets_of[iid])
            tag_index = rng.permutation(t)[:2].tolist()
        idx = np.asarray(tag_index)
        dt = self.item_dtype
        if self._ram is not None:
            text_all, img_all = self._ram[iid]
            text = text_all[idx]
        else:
            grp = self.h5[str(iid)]
            # partial-row read: a 2-tag PPO sample must not pull the whole
            # (tags, 196, 768) matrix (~12MB) off disk to use 2 rows —
            # this was a 100x host-pipeline bottleneck at real LRMovieNet
            # shapes. h5py fancy selection needs increasing unique indices.
            if (len(idx) == grp["text_emb"].shape[0]
                    and np.array_equal(idx, np.arange(len(idx)))):
                text = np.asarray(grp["text_emb"][:]).astype(dt, copy=False)
            else:
                uniq, inverse = np.unique(idx, return_inverse=True)
                rows = np.asarray(grp["text_emb"][uniq.tolist()]).astype(
                    dt, copy=False)
                text = rows[inverse]
            img_all = np.asarray(grp["img_emb"][:])[0].astype(dt,
                                                             copy=False)
        img = _pad_images(img_all, self.max_imgs, rng)
        tgts = np.asarray(
            [self.targets_of[iid][j] for j in tag_index], dtype=np.int32)
        out = {"text": text, "img": img, "tgts": tgts}
        if ch is not None:
            out["chosen_index"] = np.asarray(ch, dtype=np.int32)
            out["reject_index"] = np.asarray(rj, dtype=np.int32)
        return out
