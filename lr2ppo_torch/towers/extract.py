"""Feature extraction with the towers (counterpart of
lr2ppo_tpu/towers/extract.py): the offline pipeline that writes
clean_feat.h5, per item text_emb (tags, 196, 768) from the XLM-R tower and
img_emb (1, frames, 768) from the ViT-B/16 tower.

Both extractors pad every chunk to `batch` rows, as the JAX package pads to
one compiled shape: each encode sees the same (batch, S) input, so each
launches the attention kernel once per layer. They run under
torch.inference_mode() on `device` (the GPU unless the caller names
another) in the compute `dtype` (float32 by default, which is what the JAX
CLI runs).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from lr2ppo_torch.device import require_cuda
from lr2ppo_torch.towers.model import TowerConfig, TowerModel


def _tower(cfg: TowerConfig, state: Dict[str, torch.Tensor], dtype,
           device: torch.device) -> TowerModel:
    """A TowerModel holding `state` on `device` (strict keys); float32
    compute is the modules' default (dtype None)."""
    dtype = None if dtype == torch.float32 else dtype
    model = TowerModel(cfg, dtype, device="meta")
    model.load_state_dict({k: v.to(device) for k, v in state.items()},
                          strict=True, assign=True)
    return model.eval()


class TextFeatureExtractor:
    """Tokenize tags and return the last hidden states (tags, seq_length,
    hidden) as float32 numpy."""

    def __init__(self, cfg: TowerConfig, state, tokenizer,
                 seq_length: int = 196, cls_id: int = 0, sep_id: int = 2,
                 pad_id: int = 1, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = require_cuda() if device is None else torch.device(
            device)
        self.model = _tower(cfg, state, dtype, self.device)
        self.tokenizer = tokenizer
        self.seq_length = seq_length
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id

    def prepare(self, texts: List[str]) -> tuple:
        n, s = len(texts), self.seq_length
        src = np.full((n, s), self.pad_id, np.int64)
        seg = np.zeros((n, s), np.int64)
        for i, t in enumerate(texts):
            ids = [self.cls_id] + self.tokenizer.encode(t)[: s - 2] + [
                self.sep_id]
            src[i, : len(ids)] = ids
            seg[i, : len(ids)] = 1
        return src, seg

    def encode(self, src: np.ndarray, seg: np.ndarray) -> np.ndarray:
        """One padded chunk through the tower."""
        with torch.inference_mode():
            out = self.model.encode(torch.from_numpy(src).to(self.device),
                                    torch.from_numpy(seg).to(self.device))
            return out.float().cpu().numpy()

    def __call__(self, texts: List[str], batch: int = 32) -> np.ndarray:
        if not texts:   # items with empty tag lists exist in the wild
            return np.zeros((0, self.seq_length, self.cfg.hidden_size),
                            np.float32)
        src, seg = self.prepare(texts)
        outs = []
        for s0 in range(0, len(texts), batch):
            chunk_src = src[s0: s0 + batch]
            chunk_seg = seg[s0: s0 + batch]
            pad = batch - chunk_src.shape[0]
            if pad > 0:  # one input shape for every encode
                chunk_src = np.pad(chunk_src, ((0, pad), (0, 0)),
                                   constant_values=self.pad_id)
                chunk_seg = np.pad(chunk_seg, ((0, pad), (0, 0)))
            out = self.encode(chunk_src, chunk_seg)
            outs.append(out[: batch - pad] if pad > 0 else out)
        return np.concatenate(outs, axis=0)


class ImageFeatureExtractor:
    """ViT tower -> per-frame feature = the [CLS] row of the last hidden
    states (hidden,). A BEiT tower (masked_patch) encodes with an empty
    mask: no patch is replaced."""

    def __init__(self, cfg: TowerConfig, state, dtype: torch.dtype =
                 torch.float32, device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = require_cuda() if device is None else torch.device(
            device)
        self.model = _tower(cfg, state, dtype, self.device)
        self.seq = (cfg.image_height // cfg.patch_size) * (
            cfg.image_width // cfg.patch_size) + 1

    def encode(self, pixels: np.ndarray) -> np.ndarray:
        """One padded chunk (batch, C, H, W) through the tower."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(pixels, np.float32))
            x = x.to(self.device)
            seg = torch.ones((x.shape[0], self.seq), dtype=torch.int64,
                             device=self.device)
            src = x
            if "masked_patch" in self.cfg.embedding:
                src = (x, torch.zeros((x.shape[0], 0), dtype=torch.int64,
                                      device=self.device))
            return self.model.encode(src, seg)[:, 0].float().cpu().numpy()

    def __call__(self, pixels: np.ndarray, batch: int = 32) -> np.ndarray:
        """pixels: (N, C, H, W) float in [0, 1] (ZeroOneNormalize)."""
        outs = []
        n = pixels.shape[0]
        for s0 in range(0, n, batch):
            chunk = pixels[s0: s0 + batch]
            pad = batch - chunk.shape[0]
            if pad > 0:
                chunk = np.pad(chunk, ((0, pad),) + ((0, 0),) * 3)
            out = self.encode(chunk)
            outs.append(out[: batch - pad] if pad > 0 else out)
        return np.concatenate(outs, axis=0)


def write_clean_feat(h5_path: str, item_id: str, text_emb: np.ndarray,
                     img_emb: np.ndarray, h5_file=None) -> None:
    """Append one item in the reference layout (ppo.py:120-127):
    <id>/text_emb (tags, S, D) and <id>/img_emb (1, n_imgs, D)."""
    import h5py

    own = h5_file is None
    hf = h5_file or h5py.File(h5_path, "a")
    try:
        g = hf.create_group(str(item_id))
        g.create_dataset("text_emb", data=text_emb.astype(np.float32))
        g.create_dataset("img_emb",
                         data=img_emb[None].astype(np.float32))
    finally:
        if own:
            hf.close()
