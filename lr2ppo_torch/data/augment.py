"""SpecAugment (the port's own copy of lr2ppo_tpu/data/augment.py; reference
tencentpretrain/utils/augment.py, from arXiv 1904.08779): frequency masks,
time masks (optionally capped at a fraction p of the frames), and time
warping. A host-side numpy transform of the data pipeline, drawing from its
own numpy generator, so a seed gives the JAX package's masks byte for
byte."""

from __future__ import annotations

from typing import Optional

import numpy as np


class SpecAugment:
    def __init__(self, time_warp_W: int = 0, freq_mask_N: int = 0,
                 freq_mask_F: int = 0, time_mask_N: int = 0,
                 time_mask_T: int = 0, time_mask_p: float = 0.0,
                 mask_value: Optional[float] = None, seed: int = 0):
        if freq_mask_N > 0:
            assert freq_mask_F > 0
        if time_mask_N > 0:
            assert time_mask_T > 0
        self.W, self.fN, self.fF = time_warp_W, freq_mask_N, freq_mask_F
        self.tN, self.tT, self.tp = time_mask_N, time_mask_T, time_mask_p
        self.mask_value = mask_value
        self.rng = np.random.default_rng(seed)

    def __call__(self, spec: np.ndarray) -> np.ndarray:
        assert spec.ndim == 2, "spectrogram must be (frames, freqs)"
        frames, freqs = spec.shape
        if frames == 0 or freqs == 0:
            return spec
        out = spec.copy()
        value = (self.mask_value if self.mask_value is not None
                 else spec.mean())

        if self.W > 0 and 2 * self.W < frames:
            center = self.rng.integers(self.W, frames - self.W)
            warped = int(center + self.rng.integers(-self.W, self.W + 1))
            left = np.interp(np.linspace(0, center, warped, endpoint=False),
                             np.arange(frames), np.arange(frames))
            right = np.interp(
                np.linspace(center, frames - 1, frames - warped),
                np.arange(frames), np.arange(frames))
            idx = np.concatenate([left, right]).astype(int)
            out = out[np.clip(idx, 0, frames - 1)]

        # clamp the mask width to the spectrogram — a too-large F must
        # not disable the (independent) time masks and warp
        for _ in range(self.fN):
            f = int(self.rng.integers(0, min(self.fF, freqs) + 1))
            f0 = int(self.rng.integers(0, freqs - f + 1))
            out[:, f0: f0 + f] = value

        max_t = self.tT
        if self.tp > 0:
            max_t = min(max_t, int(self.tp * frames))
        for _ in range(self.tN):
            t = int(self.rng.integers(0, max(max_t, 0) + 1))
            t0 = int(self.rng.integers(0, max(frames - t, 0) + 1))
            out[t0: t0 + t, :] = value
        return out
