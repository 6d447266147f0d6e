"""The VQGAN image tokenizer (counterpart of lr2ppo_tpu/towers/vqgan.py): the
encode path of taming-transformers' VQModel that the BEiT and DALL-E
processors read (tencentpretrain/utils/image_tokenizer.py:1-80).

The modules are NCHW `nn.Conv2d` and `nn.GroupNorm(min(32, C), eps=1e-6)`
named after taming's own keys, so a taming state dict loads by name with no
transpose: `encoder.conv_in`, `encoder.down.<i>.block.<j>.{norm1,conv1,
norm2,conv2,nin_shortcut}`, `encoder.down.<i>.attn.<j>.{norm,q,k,v,
proj_out}`, `encoder.down.<i>.downsample.conv`, `encoder.mid.{block_1,
attn_1,block_2}`, `encoder.norm_out`, `encoder.conv_out`, `quant_conv` and
`quantize.embedding.weight`. Three details follow the JAX package exactly:
an attention block follows each resnet block of a level whose resolution,
counted down from `cfg.resolution` and not from the input, is in
`attn_resolutions`; the downsample pads the bottom and the right by one
before its stride-2 convolution; and the nearest code is the argmin (first
index on a tie) of the expanded |z|^2 - 2 z.e^T + |e|^2 in float32, not
`torch.cdist`, whose formula differs. The attention block is one head of
the level's width in plain math, as in JAX. Without weights the encoder
starts from a seeded torch.Generator (flax's init styles, taming's
symmetric U(-1/n, 1/n) codebook), not from JAX's threefry draws.
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class VQGANConfig:
    """Taming's ddconfig and quantizer sizes (vqgan.yaml model.params).
    Defaults: the published imagenet f16-1024 model."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resolution: int = 256
    in_channels: int = 3
    z_channels: int = 256
    n_embed: int = 1024
    embed_dim: int = 256
    dropout: float = 0.0

    @property
    def tokens_per_image(self) -> int:
        f = 2 ** (len(self.ch_mult) - 1)
        return (self.resolution // f) ** 2


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _gn(channels: int, device=None) -> nn.GroupNorm:
    """taming's GroupNorm(32, C); C groups below 32 channels (the tiny test
    configs)."""
    return nn.GroupNorm(min(32, channels), channels, eps=1e-6, device=device)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1 = _gn(cin, device)
        self.conv1 = _conv(cin, cout, 3, padding=1, device=device)
        self.norm2 = _gn(cout, device)
        self.conv2 = _conv(cout, cout, 3, padding=1, device=device)
        if cin != cout:
            self.nin_shortcut = _conv(cin, cout, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_swish(self.norm1(x)))
        # taming's dropout is 0 on the encode path (JAX: deterministic)
        h = self.conv2(_swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """One head of width C over the H x W positions."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.norm = _gn(c, device)
        self.q = _conv(c, c, 1, device=device)
        self.k = _conv(c, c, 1, device=device)
        self.v = _conv(c, c, 1, device=device)
        self.proj_out = _conv(c, c, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = self.norm(x)
        q = self.q(n).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(n).reshape(b, c, h * w)
        v = self.v(n).reshape(b, c, h * w).transpose(1, 2)
        attn = torch.softmax(torch.bmm(q, k) * (c ** -0.5), dim=-1)
        out = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Pad the bottom and the right by one, then a stride-2 3x3 valid
    convolution (taming's Downsample with_conv)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv = _conv(c, c, 3, stride=2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Level(nn.Module):
    """One resolution of the encoder: `block`, `attn` (where the level's
    resolution asks for it) and `downsample` (all but the last)."""

    def __init__(self, cin: int, cout: int, n_blocks: int, attend: bool,
                 downsample: bool, device=None):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, device)
            for j in range(n_blocks))
        self.attn = nn.ModuleList(AttnBlock(cout, device)
                                  for _ in range(n_blocks if attend else 0))
        if downsample:
            self.downsample = Downsample(cout, device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for j, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[j](h)
        if hasattr(self, "downsample"):
            h = self.downsample(h)
        return h


class _Mid(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, device)
        self.attn_1 = AttnBlock(c, device)
        self.block_2 = ResnetBlock(c, c, device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """conv_in -> the levels -> mid -> norm_out -> swish -> conv_out."""

    def __init__(self, cfg: VQGANConfig, device=None):
        super().__init__()
        self.conv_in = _conv(cfg.in_channels, cfg.ch, 3, padding=1,
                             device=device)
        res, cin = cfg.resolution, cfg.ch
        levels = []
        for i, mult in enumerate(cfg.ch_mult):
            cout = cfg.ch * mult
            last = i == len(cfg.ch_mult) - 1
            levels.append(_Level(cin, cout, cfg.num_res_blocks,
                                 res in cfg.attn_resolutions, not last,
                                 device))
            cin = cout
            if not last:
                res //= 2
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(cin, device)
        self.norm_out = _gn(cin, device)
        self.conv_out = _conv(cin, cfg.z_channels, 3, padding=1,
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(_swish(self.norm_out(h)))


class _Quantize(nn.Module):
    def __init__(self, cfg: VQGANConfig, device=None):
        super().__init__()
        self.embedding = nn.Embedding(cfg.n_embed, cfg.embed_dim,
                                      device=device)


class VQGANEncoder(nn.Module):
    """The encode path: pixels in [0, 1] (B, C, H, W) -> (indices (B, N)
    int64, z_q (B, N, embed_dim)), N = (H / f) * (W / f) in row-major
    order."""

    def __init__(self, cfg: VQGANConfig = VQGANConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.quant_conv = _conv(cfg.z_channels, cfg.embed_dim, 1,
                                device=device)
        self.quantize = _Quantize(cfg, device)

    def features(self, pixels01: torch.Tensor) -> torch.Tensor:
        """quant_conv's output (B, N, embed_dim): what the codes are chosen
        for."""
        z = self.quant_conv(self.encoder(2.0 * pixels01 - 1.0))
        return z.flatten(2).transpose(1, 2)

    def quantize_features(self, z: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The nearest code of each row of z (B, N, C), in float32."""
        codebook = self.quantize.embedding.weight.float()
        z = z.float()
        d = (z.pow(2).sum(-1, keepdim=True)
             - 2.0 * torch.matmul(z, codebook.t())
             + codebook.pow(2).sum(-1)[None, None])
        idx = torch.argmin(d, dim=-1)
        return idx, codebook[idx]

    def forward(self, pixels01: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.quantize_features(self.features(pixels01))


@torch.no_grad()
def init_vqgan(model: VQGANEncoder, generator: torch.Generator) -> None:
    """Seeded weights in flax's init styles: convolution kernels lecun
    normal (truncated at two deviations of 1 / fan_in), biases zero, group
    norms at one and zero; the codebook taming's U(-1/n, 1/n)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    n = model.cfg.n_embed
    nn.init.uniform_(model.quantize.embedding.weight, -1.0 / n, 1.0 / n,
                     generator=generator)


# the state dict's roots on the encode path
_ENCODE_ROOTS = ("encoder.", "quant_conv.", "quantize.embedding.weight")


def _codebook_fits(sd: Dict[str, torch.Tensor], cfg: VQGANConfig) -> None:
    cb = sd.get("quantize.embedding.weight")
    if cb is not None and tuple(cb.shape) != (cfg.n_embed, cfg.embed_dim):
        raise ValueError(
            f"VQGAN checkpoint codebook {tuple(cb.shape)} does not match "
            f"config (n_embed={cfg.n_embed}, "
            f"embed_dim={cfg.embed_dim}) — pass the VQGANConfig the "
            f"checkpoint was trained with (e.g. f16_1024 vs f16_16384)")


def load_taming_checkpoint(path: str, cfg: Optional[VQGANConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """The encode path's keys of a taming-transformers VQModel checkpoint
    (the published vqgan_imagenet_f16_*.ckpt, or a state dict): the
    decoder and loss weights are dropped. Raises where the codebook does
    not fit `cfg`. A Lightning checkpoint that pickles more than tensors
    is read as the JAX package reads it (weights_only=False)."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)
    sd = {k: v for k, v in sd.items() if k.startswith(_ENCODE_ROOTS)}
    if cfg is not None:
        _codebook_fits(sd, cfg)
    return sd


def vqgan_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX VQGANEncoder's param tree (optionally under "params") of
    numpy arrays -> the taming-keyed state dict: HWIO kernels to OIHW,
    GroupNorm scales to `weight`, the codebook to
    `quantize.embedding.weight`."""
    tree = tree.get("params", tree)
    out = {}
    for name, node in tree.items():
        if name == "codebook":
            out["quantize.embedding.weight"] = torch.from_numpy(
                np.array(node, np.float32, copy=True))
            continue
        parts = name.split("_")
        if name == "quant_conv":
            prefix = "quant_conv"
        elif parts[0] == "down":
            prefix = (f"encoder.down.{parts[1]}.downsample.conv"
                      if parts[2] == "downsample"
                      else f"encoder.down.{parts[1]}.{parts[2]}.{parts[3]}")
        elif parts[0] == "mid":
            prefix = "encoder.mid." + name[4:]
        else:                       # conv_in, norm_out, conv_out
            prefix = "encoder." + name
        for sub, leaves in _leaves(node):
            key = ".".join([prefix] + list(sub))
            for leaf, arr in leaves.items():
                arr = np.asarray(arr, np.float32)
                if leaf == "kernel":
                    arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
                elif leaf == "scale":
                    leaf = "weight"
                out[f"{key}.{leaf}"] = torch.from_numpy(
                    np.array(arr, copy=True, order="C"))
    return out


def _leaves(node, path=()):
    """(sub-module path, {leaf: array}) of a flax module's subtree."""
    arrays = {k: v for k, v in node.items() if not isinstance(v, dict)}
    if arrays:
        yield path, arrays
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))


def make_image_tokenizer(cfg: Optional[VQGANConfig] = None,
                         weights_path: Optional[str] = None,
                         seed: int = 0, device=None):
    """(tokenize, cfg): tokenize(pixels01 (B, C, H, W), a numpy array or a
    tensor) -> (B, N) int32 codebook indices as numpy, encoded on `device`
    (the GPU unless the caller names another). The weights come from a
    taming checkpoint (strict), else from a generator seeded with `seed`."""
    from lr2ppo_torch.device import require_cuda

    cfg = cfg or VQGANConfig()
    device = require_cuda() if device is None else torch.device(device)
    model = VQGANEncoder(cfg)
    if weights_path:
        model.load_state_dict(load_taming_checkpoint(weights_path, cfg),
                              strict=True)
    else:
        init_vqgan(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()

    def tokenize(pixels01) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(pixels01, np.float32)
                                if not torch.is_tensor(pixels01)
                                else pixels01, dtype=torch.float32)
            idx, _ = model(x.to(device))
            return idx.to(torch.int32).cpu().numpy()

    tokenize.model = model
    return tokenize, cfg
