"""Pretraining data of the text processors, vit and clip (the port's own
copy of lr2ppo_tpu/data/pretrain_data.py: mask_tokens, MlmCorpusDataset,
LmCorpusDataset, ClsTsvDataset, VitImageDataset and ClipPairDataset): corpus
-> packed (N, S) int32 token instances -> BERT-style dynamic masking with a
seeded numpy generator, per epoch; (image file, label) pairs -> pixels and
the label; (caption, image file) pairs -> a framed caption and the image's
pixels. numpy, and PIL imported where an image is read; the same seed and
epoch give the JAX package's arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def mask_tokens(ids: np.ndarray, seg: np.ndarray, vocab_size: int,
                mask_id: int, rng: np.random.Generator,
                mlm_prob: float = 0.15, keep_prob: float = 0.1,
                random_prob: float = 0.1,
                special_limit: int = 5,
                exclude_ids: tuple = ()) -> tuple:
    """BERT-style dynamic masking (reference utils/mask.py): select
    ~mlm_prob of real tokens; 80% -> [MASK], 10% -> random id,
    10% -> unchanged. Returns (src, tgt) with tgt=0 on unselected.

    `exclude_ids` are the frame/special ids the reference excludes by
    IDENTITY (CLS/SEP/MASK/PAD, mask.py:40,113) — required when the
    active vocab's specials don't sit below `special_limit` (e.g. a
    BERT layout with [CLS]=101/[SEP]=102): such positions must be
    neither maskable nor drawable as random replacements."""
    src = ids.copy()
    tgt = np.zeros_like(ids)
    ex = np.asarray(sorted(set(exclude_ids)), ids.dtype)
    real = (seg > 0) & (ids >= special_limit)
    if ex.size:
        real &= ~np.isin(ids, ex)
    sel = real & (rng.random(ids.shape) < mlm_prob)
    tgt[sel] = ids[sel]
    r = rng.random(ids.shape)
    to_mask = sel & (r < 1.0 - keep_prob - random_prob)
    to_rand = sel & (r >= 1.0 - random_prob)
    src[to_mask] = mask_id
    # uniform over the ALLOWED ids, like the reference's rejection
    # redraw (mask.py:38-41): draw from the reduced range, then shift
    # past each excluded value in ascending order — every allowed id
    # keeps equal probability (a nudge-to-neighbor remap would pile the
    # whole excluded mass onto the id after each excluded run)
    ex_in = ex[(ex >= special_limit) & (ex < vocab_size)]
    n_allowed = (vocab_size - special_limit) - ex_in.size
    n_draw = int(to_rand.sum())
    if n_draw:
        if n_allowed <= 0:
            raise ValueError(
                f"no drawable ids: exclude_ids covers the whole "
                f"[{special_limit}, {vocab_size}) range")
        draws = rng.integers(special_limit, special_limit + n_allowed,
                             size=n_draw)
        for e in ex_in:                      # ex is sorted
            draws[draws >= e] += 1
        src[to_rand] = draws
    return src, tgt


class MlmCorpusDataset:
    """Pack a line-per-document corpus into fixed (S,) instances; fresh
    masks every epoch (set_epoch reseeds, like DistributedSampler)."""

    def __init__(self, corpus_path: str, tokenizer, seq_length: int,
                 vocab_size: int, mask_id: int, cls_id: int = 0,
                 sep_id: int = 2, pad_id: int = 1, seed: int = 7,
                 mlm_prob: float = 0.15, special_limit: int = 5):
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.mask_id = mask_id
        self.pad_id = pad_id
        self.seed = seed
        self.epoch = 0
        self.mlm_prob = mlm_prob
        self.special_limit = special_limit
        # frame ids are excluded from masking by identity, not only by
        # the low-id heuristic (reference mask.py:40,113)
        self.exclude_ids = (cls_id, sep_id, pad_id, mask_id)

        rows, lens = [], []
        with open(corpus_path, encoding="utf-8") as f:
            buf = [cls_id]
            for line in f:
                ids = tokenizer.encode(line.strip())
                if not ids:
                    continue
                buf.extend(ids + [sep_id])
                while len(buf) >= seq_length:
                    rows.append(buf[:seq_length])
                    lens.append(seq_length)
                    buf = [cls_id] + buf[seq_length:]
            if len(buf) > 1:
                rows.append(buf + [pad_id] * (seq_length - len(buf)))
                lens.append(len(buf))
        self.ids = np.asarray(rows, np.int32)
        # seg from the TRUE lengths, never by value-matching pad_id: a
        # real token whose id equals pad_id (e.g. GPT-2 BPE id 1 = '"')
        # must not be masked out of attention/targets mid-sequence
        self.seg = (np.arange(seq_length)[None, :]
                    < np.asarray(lens, np.int32)[:, None]).astype(np.int32)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.ids.shape[0]

    def get(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        src, tgt = mask_tokens(self.ids[i], self.seg[i], self.vocab_size,
                               self.mask_id, rng, self.mlm_prob,
                               special_limit=self.special_limit,
                               exclude_ids=self.exclude_ids)
        return {"src": src, "tgt": tgt, "seg": self.seg[i]}


class LmCorpusDataset(MlmCorpusDataset):
    """Causal-LM processor (reference utils/dataset.py lm variant):
    src = tokens[:-1], tgt = tokens[1:] (pad positions -> tgt 0)."""

    def get(self, i: int) -> Dict[str, np.ndarray]:
        ids, seg = self.ids[i], self.seg[i]
        src = ids[:-1]
        tgt = np.where(seg[1:] > 0, ids[1:], 0).astype(ids.dtype)
        return {"src": src, "tgt": tgt, "seg": seg[:-1]}

    def set_epoch(self, epoch: int) -> None:  # no per-epoch randomness
        self.epoch = epoch


class ClsTsvDataset:
    """Classification processor (utils/dataset.py cls variant): tsv rows
    'label<TAB>text' -> (src, scalar tgt, seg)."""

    def __init__(self, tsv_path: str, tokenizer, seq_length: int,
                 cls_id: int = 0, sep_id: int = 2, pad_id: int = 1):
        self.rows = []
        with open(tsv_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t", 1)
                if len(parts) != 2:
                    continue
                label, text = parts
                ids = [cls_id] + tokenizer.encode(text)[: seq_length - 2] \
                    + [sep_id]
                src = np.full(seq_length, pad_id, np.int32)
                seg = np.zeros(seq_length, np.int32)
                src[: len(ids)] = ids
                seg[: len(ids)] = 1
                self.rows.append((src, np.int32(int(label)), seg))

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.rows)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        src, tgt, seg = self.rows[i]
        return {"src": src, "tgt": tgt, "seg": seg}


class VitImageDataset:
    """ViT classification processor (utils/dataset.py vit variant): (image
    file, label) pairs -> (pixels in [0, 1] CHW, label, an all-ones seg
    over the [CLS] + patch sequence). `_pixels` reads an image (PIL, at
    first use)."""

    def __init__(self, items, image_height: int = 224,
                 image_width: int = 224, patch_size: int = 16):
        self.items = list(items)          # [(path, label), ...]
        self.h, self.w = image_height, image_width
        self.seq = (image_height // patch_size) * (
            image_width // patch_size) + 1

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.items)

    def _pixels(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((self.w, self.h))
        return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        path, label = self.items[i]
        return {"src": self._pixels(path), "tgt": np.int32(label),
                "seg": np.ones(self.seq, np.int32)}


class ClipPairDataset:
    """CLIP contrastive processor (utils/dataset.py clip variant): (text,
    image path) pairs for the dual encoder and the clr target. An item is
    the caption framed [cls] ... [sep] and padded to seq_length, its seg,
    the image resized to (image_height, image_width) as float32 pixels in
    [0, 1], channels first, an all-ones seg over [CLS] + patches, and tgt =
    the row index (clr's labels are positional)."""

    def __init__(self, pairs, tokenizer, seq_length: int,
                 image_height: int = 224, image_width: int = 224,
                 patch_size: int = 16, cls_id: int = 0, sep_id: int = 2,
                 pad_id: int = 1):
        self.pairs = list(pairs)          # [(text, image_path), ...]
        self.tok = tokenizer
        self.seq_length = seq_length
        self.h, self.w = image_height, image_width
        self.img_seq = (image_height // patch_size) * (
            image_width // patch_size) + 1
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.pairs)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        text, img_path = self.pairs[i]
        ids = [self.cls_id] + self.tok.encode(text)[: self.seq_length - 2] \
            + [self.sep_id]
        src = np.full(self.seq_length, self.pad_id, np.int32)
        seg = np.zeros(self.seq_length, np.int32)
        src[: len(ids)] = ids
        seg[: len(ids)] = 1
        img = Image.open(img_path).convert("RGB").resize((self.w, self.h))
        pixels = (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)
        return {"src_text": src, "seg_text": seg, "src_image": pixels,
                "seg_image": np.ones(self.img_seq, np.int32),
                "tgt": np.int32(i)}
