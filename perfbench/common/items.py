"""The stage-3 item store: LRMovieNet-shaped items made from the seed, held
in host memory behind the interface of the MovieNet HDF5 store, so the
program's own dataset (`data/movienet.py`) samples them.

Each item has 2-32 tags (uniform) with targets 0-2. A tag's text feature
(196 x 768, XLM-R's) is one of a pool of embeddings, and each item has 16
image features (ViT-B/16's); all are N(0, 1), drawn on the device in bulk
and copied to the host once. `identify` maps a collated batch back to pool
and image rows, which checks that the loader delivered the store's rows and
lets the reference rebuild them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def np_dtype(name: str):
    if name in ("bfloat16", "bf16"):
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _to_host(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    if dtype.name == "bfloat16":
        return t.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(
            dtype)
    return t.float().cpu().numpy().astype(dtype, copy=False)


class _Rows:
    """One item's `text_emb` or `img_emb` dataset: rows of a pool."""

    def __init__(self, pool: np.ndarray, rows: np.ndarray, lead: bool):
        self.pool, self.rows, self.lead = pool, rows, lead
        self.shape = ((1,) if lead else ()) + (len(rows),) + pool.shape[1:]

    def __getitem__(self, sel):
        if isinstance(sel, slice):
            out = self.pool[self.rows[sel]]
        else:
            out = self.pool[self.rows[np.asarray(sel)]]
        return out[None] if self.lead else out


class ItemStore:
    """`train` and `eval` are the items as the data JSON lists them; the
    store answers `store[item_id]["text_emb" | "img_emb"]` as the HDF5 file
    does."""

    def __init__(self, seed: int, spec: dict, seq: int, dim: int,
                 item_dtype: str, device):
        rng = np.random.default_rng(seed)
        self.dtype = np_dtype(item_dtype)
        n_train, n_eval = spec["items"], spec["eval_items"]
        lo, hi = spec["tags"]
        n_img = spec["images"]
        gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
        text = torch.randn((spec["pool"], seq, dim), generator=gen,
                           device=device)
        self.text = _to_host(text, self.dtype)
        del text
        n = n_train + n_eval
        img = torch.randn((n * n_img, dim), generator=gen, device=device)
        self.img = _to_host(img, self.dtype)
        del img
        self.n_img = n_img
        self.tags: Dict[str, np.ndarray] = {}
        items = []
        for i in range(n):
            t = int(rng.integers(lo, hi + 1))
            iid = str(i)
            self.tags[iid] = rng.integers(0, spec["pool"], size=t)
            items.append({"id": iid, "tags": [
                {"tag": f"t{j}", "target": int(x)}
                for j, x in enumerate(rng.integers(0, 3, size=t))]})
        self.train: List[dict] = items[:n_train]
        self.eval: List[dict] = items[n_train:]
        self._text_key = {self.text[k, 0, :4].tobytes(): k
                          for k in range(self.text.shape[0])}
        self._img_key = {self.img[k, :4].tobytes(): k
                         for k in range(self.img.shape[0])}

    def __getitem__(self, iid: str):
        i = int(iid)
        return {"text_emb": _Rows(self.text, self.tags[iid], False),
                "img_emb": _Rows(self.img, np.arange(i * self.n_img,
                                                     (i + 1) * self.n_img),
                                 True)}

    def identify(self, batch: dict) -> Dict[str, np.ndarray]:
        """Pool rows of each tag and image rows of each item of a collated
        ppo batch: {"text": (B, T) int, "img": (B, I) int}; raises where a
        row is not the store's, or a row's tags or images are not one
        item's."""
        text, img = np.asarray(batch["text"]), np.asarray(batch["img"])
        b, t = text.shape[:2]
        tid = np.empty((b, t), np.int64)
        iid = np.empty(img.shape[:2], np.int64)
        for r in range(b):
            for j in range(img.shape[1]):
                iid[r, j] = self._img_key[img[r, j, :4].tobytes()]
            item = iid[r, 0] // self.n_img
            if np.any(iid[r] // self.n_img != item):
                raise AssertionError(f"row {r}: images of several items")
            own = list(self.tags[str(item)])
            for j in range(t):
                k = self._text_key[text[r, j, 0, :4].tobytes()]
                if k not in own:
                    raise AssertionError(f"row {r}: tag {j} is not one of "
                                         f"item {item}'s")
                own.remove(k)
                tid[r, j] = k
        # the whole rows of a few of them, against the store
        for r in (0, b // 2, b - 1):
            if not (np.array_equal(text[r], self.text[tid[r]])
                    and np.array_equal(img[r], self.img[iid[r]])):
                raise AssertionError(f"row {r} differs from the store's")
        return {"text": tid, "img": iid}

    def rebuild(self, ids: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
        """The float32 rows of `identify`'s ids, on `device`."""
        def dev(a):
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16).to(device).float()
            return torch.from_numpy(np.ascontiguousarray(a)).to(device).float()

        return {"text": dev(self.text[ids["text"]]),
                "img": dev(self.img[ids["img"]])}
