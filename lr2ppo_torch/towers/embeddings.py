"""Tower embeddings (counterpart of lr2ppo_tpu/towers/embeddings.py): word,
pos, seg, sinusoidal positions and the ViT patch embedding, summed, then an
optional RefLayerNorm (embedding.py:19-34).

The patch projection keeps the reference Conv2d's key and shape,
`embedding.patch.projection.weight` (E, C, P, P) without a bias, but is
computed as the JAX package computes it: the image is cut into patches by a
reshape and a transpose to (c, ph, pw) order, then one matmul. (A float32
convolution would also run through cuDNN in TF32 unless that is turned off.)

The sinusoidal table is a constant, computed once on the host in float32 by
the reference's own torch recipe (sinusoidalpos_embedding.py:26-44) and
copied to each device it is read on; JAX's float32 exp, sin and cos round
some entries differently (within one ulp of the largest angle). The
constructors' gates read the global embedding list (`gate_embedding`, which
TowerModel threads into the decoder side's config), as in JAX.

Three kinds read a tuple or a sequence that is not text: word_patch
(ViLT: the text's tokens, then [CLS] and the patches of the image, from a
(tokens, pixels) pair), masked_patch (BEiT: [CLS] and the patches, those at
the mask's indices replaced by the learned `mask_emb`, from a (pixels, mask)
pair) and speech (S2T: a stack of stride-2 GLU convolutions over filterbank
frames, computed as windows taken by `unfold` and one matmul, as the JAX
package computes them; the weights keep nn.Conv1d's (out, in, k) layout).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.ops.hash_dropout import module_dropout
from lr2ppo_torch.towers.layers import RefLayerNorm


class _Table(nn.Module):
    """A lookup table under the key `embedding.weight`, N(0, 1) at init."""

    def __init__(self, rows: int, emb_size: int, device=None):
        super().__init__()
        self.embedding = nn.Embedding(rows, emb_size, device=device)


class WordEmbedding(_Table):
    """Token lookup, times sqrt(emb_size) under sinusoidal positions
    (word_embedding.py)."""

    def __init__(self, vocab_size: int, emb_size: int,
                 sinusoidalpos: bool = False, device=None):
        super().__init__(vocab_size, emb_size, device)
        self.scale = math.sqrt(emb_size) if sinusoidalpos else None

    def forward(self, src: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        emb = self.embedding.weight[src]
        return emb if self.scale is None else emb * self.scale


class PosEmbedding(_Table):
    """Learned absolute positions 0..S-1, no padding offset
    (pos_embedding.py)."""

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        b, s = seg.shape
        return self.embedding.weight[:s][None].expand(b, s, -1)


class SegEmbedding(_Table):
    """Three-way segment lookup (seg_embedding.py)."""

    def __init__(self, emb_size: int, device=None):
        super().__init__(3, emb_size, device)

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        return self.embedding.weight[seg]


def sinusoid_table(rows: int, emb_size: int,
                   interleaved: bool = True) -> torch.Tensor:
    """(rows, emb_size) float32 sin/cos table on the host: interleaved sin
    and cos channels, or [sin || cos] (the speech layout); an odd width ends
    in a zero column."""
    half = emb_size // 2
    value = math.log(10000.0) / (half - 1)
    half_exp = torch.exp(torch.arange(half, dtype=torch.float32) * -value)
    half_mat = (torch.arange(rows, dtype=torch.float32)[:, None]
                * half_exp[None, :])
    if interleaved:
        emb = torch.stack([torch.sin(half_mat), torch.cos(half_mat)],
                          dim=-1).reshape(rows, 2 * half)
    else:
        emb = torch.cat([torch.sin(half_mat), torch.cos(half_mat)], dim=1)
    if emb_size % 2:
        emb = torch.cat([emb, torch.zeros(rows, 1)], dim=1)
    return emb


class SinusoidalposEmbedding(nn.Module):
    """Fixed sin/cos positions (sinusoidalpos_embedding.py:26-68): token i
    reads row i + 2 of a max_seq_length + 2 row table, zero past the first
    seg.sum(-1) tokens (the reference's no_pad count, which counts a
    segment-2 token twice). No parameters."""

    def __init__(self, max_seq_length: int, emb_size: int,
                 interleaved: bool = True):
        super().__init__()
        self.table = sinusoid_table(max_seq_length + 2, emb_size,
                                    interleaved)
        self._on = {}

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        table = self._on.get(seg.device)
        if table is None:
            table = self._on[seg.device] = self.table.to(seg.device)
        s = seg.shape[1]
        no_pad = seg.sum(-1)
        pos = torch.arange(s, device=seg.device)[None, :]
        keep = (pos < no_pad[:, None])[..., None]
        return torch.where(keep, table[2:s + 2][None], 0.0)


class PatchEmbedding(nn.Module):
    """ViT patchify: (B, C, H, W) -> [CLS] ++ patch tokens
    (patch_embedding.py:5-31), as reshape + matmul. `projection` is an
    nn.Conv2d only for its key and layout; forward never convolves."""

    def __init__(self, emb_size: int, image_height: int = 224,
                 image_width: int = 224, patch_size: int = 16,
                 channels_num: int = 3, device=None):
        super().__init__()
        self.image_height, self.image_width = image_height, image_width
        self.patch_size, self.channels_num = patch_size, channels_num
        self.projection = nn.Conv2d(channels_num, emb_size, patch_size,
                                    stride=patch_size, bias=False,
                                    device=device)
        self.cls_emb = nn.Parameter(torch.zeros(1, 1, emb_size,
                                                device=device))

    def forward(self, src: torch.Tensor, seg) -> torch.Tensor:
        p, c = self.patch_size, self.channels_num
        b, _, h, w = src.shape
        if (h, w) != (self.image_height, self.image_width):
            raise ValueError(f"input {h}x{w} != model "
                             f"{self.image_height}x{self.image_width}")
        gh, gw = h // p, w // p
        x = src.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, gh * gw, c * p * p)
        weight = self.projection.weight
        kernel = weight.reshape(weight.shape[0], -1).t().to(x.dtype)
        tokens = torch.matmul(x, kernel)
        cls_tok = self.cls_emb.to(x.dtype).expand(b, 1, -1)
        return torch.cat([cls_tok, tokens], dim=1)


# the speech subsampler's convolution width (the JAX module's default, which
# no config overrides)
SPEECH_KERNEL = 5


class WordPatchEmbedding(nn.Module):
    """Text tokens, then [CLS] and the image's patches
    (word_patch_embedding.py): `src` is a (tokens, pixels) pair, and the
    sub-modules are `word` (never scaled, as in JAX) and `patch`."""

    def __init__(self, vocab_size: int, emb_size: int,
                 image_height: int = 224, image_width: int = 224,
                 patch_size: int = 16, channels_num: int = 3, device=None):
        super().__init__()
        self.word = WordEmbedding(vocab_size, emb_size, device=device)
        self.patch = PatchEmbedding(emb_size, image_height, image_width,
                                    patch_size, channels_num, device)

    def forward(self, src, seg: torch.Tensor) -> torch.Tensor:
        tokens, pixels = src
        return torch.cat([self.word(tokens, seg), self.patch(pixels, seg)],
                         dim=1)


class MaskedPatchEmbedding(nn.Module):
    """BEiT's masked patchify (masked_patch_embedding.py:7-38): [CLS] and
    the patches, the positions at `mask` (B, M) indices into that sequence
    replaced by `mask_emb` (1, E). A repeated index counts once (the
    reference's scatter_ overwrites), and the replacement is the JAX
    package's arithmetic, emb * (1 - hit) + hit * mask_emb, so values and
    gradients match."""

    def __init__(self, emb_size: int, image_height: int = 224,
                 image_width: int = 224, patch_size: int = 16,
                 channels_num: int = 3, device=None):
        super().__init__()
        self.patch = PatchEmbedding(emb_size, image_height, image_width,
                                    patch_size, channels_num, device)
        self.mask_emb = nn.Parameter(torch.zeros(1, emb_size, device=device))

    def forward(self, src, seg) -> torch.Tensor:
        pixels, mask = src
        emb = self.patch(pixels, seg)
        b, s, _ = emb.shape
        hit = torch.zeros(b, s, dtype=emb.dtype, device=emb.device)
        hit.scatter_(1, mask.long(), 1.0)
        hit = hit[..., None]
        return emb * (1 - hit) + hit * self.mask_emb.to(emb.dtype)


class SpeechEmbedding(nn.Module):
    """The convolutional subsampler of speech_embedding.py:6-27: `conv_layers`
    stride-2 convolutions of width `kernel_size` with GLU gating, padded
    ((k-1)//2, k-1-(k-1)//2) frames, so T frames give ceil(T/2). The first
    layer's input width comes from the data (x.shape[-1]); every later one
    is emb_size wide. `conv_0` is built for `in_dim` features (80, the
    filterbank's bins, which the S2T processor writes) and another width
    raises, where JAX sizes its first kernel from the first batch. Each
    window is flattened offset-major and multiplied by the weight read as
    the JAX package's (k * in, 2 * emb) kernel. Times sqrt(emb_size) under
    sinusoidal positions."""

    def __init__(self, emb_size: int, conv_layers: int = 2,
                 kernel_size: int = SPEECH_KERNEL, in_dim: int = 80,
                 sinusoidalpos: bool = False, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.n_layers = conv_layers
        for i in range(conv_layers):
            conv = nn.Conv1d(in_dim if i == 0 else emb_size, 2 * emb_size,
                             kernel_size, stride=2, device=device)
            conv.decay_bias = True     # JAX's leaf is `conv_<i>_bias`
            self.add_module(f"conv_{i}", conv)
        self.scale = math.sqrt(emb_size) if sinusoidalpos else None

    def forward(self, src: torch.Tensor, seg) -> torch.Tensor:
        x, k = src, self.kernel_size
        pad = (k - 1) // 2
        for i in range(self.n_layers):
            conv = getattr(self, f"conv_{i}")
            b, s, dim = x.shape
            if dim != conv.in_channels:
                raise ValueError(f"speech conv_{i} takes {conv.in_channels} "
                                 f"features a frame, got {dim}")
            xp = F.pad(x, (0, 0, pad, k - 1 - pad))
            # (B, ceil(s/2), dim, k) -> offset-major (B, n, k * dim)
            windows = xp.unfold(1, k, 2).transpose(-1, -2)
            windows = windows.reshape(b, windows.shape[1], k * dim)
            kernel = conv.weight.permute(2, 1, 0).reshape(k * dim, -1)
            y = torch.matmul(windows, kernel.to(x.dtype)) + conv.bias.to(
                x.dtype)
            a, g = y.chunk(2, dim=-1)
            x = a * torch.sigmoid(g)
        return x if self.scale is None else x * self.scale


def _gates(cfg) -> Sequence[str]:
    """The embedding list the constructors' gates read: the global one
    (`gate_embedding`, set on the decoder side's config), else the side's
    own."""
    return cfg.gate_embedding or cfg.embedding


def _pos_rows(cfg) -> int:
    """Position tables' rows: speech configs count audio frames too."""
    if "speech" in _gates(cfg):
        return max(cfg.max_seq_length, cfg.max_audio_frames)
    return cfg.max_seq_length


_EMB_KINDS = {
    "word": lambda cfg, device: WordEmbedding(
        cfg.vocab_size, cfg.emb_size, "sinusoidalpos" in _gates(cfg),
        device),
    "pos": lambda cfg, device: PosEmbedding(_pos_rows(cfg), cfg.emb_size,
                                            device),
    "seg": lambda cfg, device: SegEmbedding(cfg.emb_size, device),
    "sinusoidalpos": lambda cfg, device: SinusoidalposEmbedding(
        _pos_rows(cfg), cfg.emb_size,
        interleaved="speech" not in _gates(cfg)),
    "patch": lambda cfg, device: PatchEmbedding(
        cfg.emb_size, cfg.image_height, cfg.image_width, cfg.patch_size,
        cfg.channels_num, device),
    "word_patch": lambda cfg, device: WordPatchEmbedding(
        cfg.vocab_size, cfg.emb_size, cfg.image_height, cfg.image_width,
        cfg.patch_size, cfg.channels_num, device),
    "masked_patch": lambda cfg, device: MaskedPatchEmbedding(
        cfg.emb_size, cfg.image_height, cfg.image_width, cfg.patch_size,
        cfg.channels_num, device),
    "speech": lambda cfg, device: SpeechEmbedding(
        cfg.emb_size, sinusoidalpos="sinusoidalpos" in _gates(cfg),
        device=device),
}


class CompositeEmbedding(nn.Module):
    """The sum of the configured kinds, each a submodule named by its kind
    (`embedding.word...`, `embedding.patch...`), each as long as seg (a
    speech input whose subsampled frames are not raises), then `layer_norm`
    unless `remove_embedding_layernorm`, then the dropout site of
    embedding.py:19-34 in training mode (its seed drawn from the caller's
    generator)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.kinds = list(cfg.embedding)
        self.dropout, self.hash_dropout = cfg.dropout, cfg.hash_dropout
        for kind in self.kinds:
            self.add_module(kind, _EMB_KINDS[kind](cfg, device))
        self.layer_norm: Optional[RefLayerNorm] = (
            None if cfg.remove_embedding_layernorm
            else RefLayerNorm(cfg.emb_size, device=device))

    def forward(self, src, seg: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = None
        for kind in self.kinds:
            cur = getattr(self, kind)(src, seg)
            if cur.shape[1] != seg.shape[1]:
                # JAX fails on the shapes too (the sum, or the mask)
                raise ValueError(
                    f"the {kind} embedding gives {cur.shape[1]} positions, "
                    f"seg has {seg.shape[1]} (speech: the frames must be a "
                    "multiple of 4 for the two stride-2 convolutions)")
            emb = cur if emb is None else emb + cur
        if self.layer_norm is not None:
            emb = self.layer_norm(emb)
        return module_dropout(emb, self.dropout, deterministic, generator,
                              self.hash_dropout)
