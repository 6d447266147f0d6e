"""Tower weights (counterpart of lr2ppo_tpu/towers/torch_import.py).

The port's tower modules carry the TencentPretrain key layout, so a
reference tower `.bin` needs no conversion: `load_tower_checkpoint` reads it
(or a JAX package pickle checkpoint of a tower, through the bridge) and
`encoder_state` keeps what `encode` reads. `tower_params_from_flax` is the
weight bridge from the JAX package: a flax tower tree of numpy arrays into
that layout, the inverse of the JAX package's `torch_tower_to_flax` for the
embedding, encoder, decoder and target keys:

  flax                                      torch
  embedding/<kind>/embedding                embedding.<kind>.embedding.weight
  embedding_{0,1}/...                       embedding_{0,1}.... (dual towers)
  tgt_embedding/<kind>/embedding            tgt_embedding.<kind>.embedding.weight
  embedding/patch/projection (C*P*P, E)     embedding.patch.projection.weight
                                            (E, C, P, P)
  embedding/masked_patch/mask_emb (1, E)    embedding.masked_patch.mask_emb
  embedding/{word_patch,masked_patch}/{word,patch}/...
                                            embedding.{word_patch,
                                            masked_patch}.{word,patch}....
  embedding/speech/conv_<i> (k*dim, out)    embedding.speech.conv_<i>.weight
                                            (out, dim, k)
  embedding/speech/conv_<i>_bias            embedding.speech.conv_<i>.bias
  encoder/transformer_<i>/.../kernel (in, out)
                                            encoder.transformer.<i>...weight
                                            (out, in)
  .../linear_layers_<j>/...                 ...linear_layers.<j>...
  .../relative_attention_bias (buckets, H)  ...relative_attention_bias.weight
  decoder_mod/transformer_decoder_<i>_<sub>/...
                                            decoder.transformer_decoder.<i>.
                                            <sub>...
  decoder_mod/{self_pos_emb,layer_norm}/... decoder.{self_pos_emb,layer_norm}...
  target/<kind>/<linear>/kernel             target.<kind>.<linear>.weight
  encoder/weight_ih_l0 (the RNN family)     encoder.rnn.weight_ih_l0
  encoder/rnn_{forward,backward}/weight_ih_l0
                                            encoder.rnn_{forward,backward}.
                                            weight_ih_l0 (bi-stacks)
  encoder/conv_stem_w (k*emb, hs)           encoder.conv_1.weight (hs, 1, k,
                                            emb)
  encoder/conv_layer_<i>_w (k*hs, hs)       encoder.conv.<i>.weight (hs, hs,
                                            k, 1)
  encoder/{conv,gate}_{stem,layer_<i>}_b    encoder.{conv_1,conv.<i>,...}.bias
  encoder/encoder_{0,1}/...                 encoder.encoder_{0,1}.... (dual)
  gamma, beta, bias, cls_emb, logit_scale, encoder_{0,1}_projection, 1-d
  weight                                    as they are

A reference `.bin` of a gated CNN carries two biases a convolution (the
Conv2d's and a per-channel `conv_b1` / `conv_b.<i>` / `gate_b1` /
`gate_b.<i>`); `load_tower_checkpoint` folds the second into the first, as
the JAX importer does (lr2ppo_tpu/towers/torch_import.py:_fold_gatedcnn).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch

from lr2ppo_torch.towers.embeddings import SPEECH_KERNEL
from lr2ppo_torch.towers.targets import TARGET_KINDS

_INDEXED = re.compile(r"^(transformer|linear_layers)_(\d+)$")
# the JAX decoder's flat layer names: transformer_decoder_<i>_<sub>
_DECODER_LAYER = re.compile(r"^(transformer_decoder)_(\d+)_(.+)$")
_ROOTS = {"embedding": "embedding", "encoder": "encoder",
          "target": "target", "tgt_embedding": "tgt_embedding",
          "decoder_mod": "decoder", "embedding_0": "embedding_0",
          "embedding_1": "embedding_1"}
# torch's flat RNN names, which JAX declares on the encoder itself
_RNN_LEAF = re.compile(r"^(weight|bias)_(ih|hh)_l\d+(_reverse)?$")
_BI_STACKS = ("rnn_forward", "rnn_backward")
# the JAX gated CNN's matmul kernels and biases
_GATEDCNN_LEAF = re.compile(r"^(conv|gate)_(stem|layer_(\d+))_([wb])$")
# the JAX speech embedding's convolutions: offset-major (k*dim, out) kernels
_SPEECH_LEAF = re.compile(r"^conv_(\d+)(_bias)?$")
# a reference gated CNN's second bias of each convolution
_SPLIT_BIAS = re.compile(r"^((?:.*\.)?)(conv|gate)_b(1|\.(\d+))$")

# the module prefixes encode reads; a reference .bin also holds the target
# heads (`target.*`), which only pretraining reads
ENCODE_PREFIXES = ("embedding.", "encoder.")


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, node


def _tensor(arr) -> torch.Tensor:
    """A row-major copy that does not alias the caller's buffer."""
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def _gatedcnn_leaf(path, m, arr, parent: dict,
                   kernel_size: Optional[int]) -> Dict[str, torch.Tensor]:
    """One JAX gated-CNN leaf under its reference Conv2d key: a (k*in, hs)
    kernel, offset-major, back to (hs, 1, k, emb) (the stem) or (hs, hs, k,
    1) (a layer); a bias as it is. The stem's k is `kernel_size`, else read
    off the first layer's kernel."""
    tag, _, index, kind = m.groups()
    prefix = ".".join(["encoder"] + list(path[1:-1]))
    name = f"{tag}_1" if index is None else f"{tag}.{index}"
    if kind == "b":
        return {f"{prefix}.{name}.bias": _tensor(arr)}
    rows, hs = arr.shape
    if index is None:
        if kernel_size is None:
            if f"{tag}_layer_0_w" not in parent:
                raise ValueError("a one-layer gated CNN's stem kernel needs "
                                 "kernel_size to split its rows")
            first = parent[f"{tag}_layer_0_w"].shape
            kernel_size = first[0] // first[1]
        w = arr.T.reshape(hs, kernel_size, rows // kernel_size)[:, None]
    else:
        w = arr.T.reshape(hs, rows // hs, hs).transpose(0, 2, 1)[..., None]
    return {f"{prefix}.{name}.weight": _tensor(w)}


def tower_params_from_flax(tree: dict, channels_num: int = 3,
                           kernel_size: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """A JAX TowerModel param tree (optionally under "params") of numpy
    arrays -> the port's reference-keyed state_dict. `channels_num` splits
    the patch kernel's C*P*P rows back into (C, P, P); `kernel_size` splits
    a gated CNN's stem kernel (read off its first layer where omitted). A
    speech convolution's rows split at SPEECH_KERNEL, the width JAX always
    builds."""
    tree = tree.get("params", tree)
    out = {}
    for path, arr in _flatten(tree):
        gated = _GATEDCNN_LEAF.match(path[-1])
        if path[0] == "encoder" and gated:
            parent = tree
            for p in path[:-1]:
                parent = parent[p]
            out.update(_gatedcnn_leaf(path, gated, np.asarray(arr), parent,
                                      kernel_size))
            continue
        if path[0] not in _ROOTS or (
                path[0] == "target" and path[1] not in TARGET_KINDS):
            raise KeyError(f"flax path {path} is outside the embeddings, "
                           "encoder, decoder and targets the port has")
        arr = np.asarray(arr)
        speech = _SPEECH_LEAF.match(path[-1])
        if len(path) > 1 and path[-2] == "speech" and speech:
            prefix = ".".join([_ROOTS[path[0]]] + list(path[1:-1]))
            name = f"{prefix}.conv_{speech.group(1)}"
            if speech.group(2):
                out[f"{name}.bias"] = _tensor(arr)
                continue
            k = SPEECH_KERNEL
            rows, width = arr.shape
            out[f"{name}.weight"] = _tensor(
                arr.reshape(k, rows // k, width).transpose(2, 1, 0))
            continue
        parts = [_ROOTS[path[0]]]
        for p in path[1:-1]:
            m = _INDEXED.match(p) or _DECODER_LAYER.match(p)
            parts += list(m.groups()) if m else [p]
        leaf = path[-1]
        if _RNN_LEAF.match(leaf) and path[-2] not in _BI_STACKS:
            parts.append("rnn")            # the reference's nn.RNN holder
        if leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf in ("embedding", "relative_attention_bias"):   # a table
            parts, leaf = parts + [leaf], "weight"
        elif leaf == "projection":                 # the patch kernel
            rows, e = arr.shape
            p = math.isqrt(rows // channels_num)
            if channels_num * p * p != rows:
                raise ValueError(f"patch kernel {arr.shape} does not split "
                                 f"into {channels_num} channels of P x P")
            arr = arr.T.reshape(e, channels_num, p, p)
            parts, leaf = parts + ["projection"], "weight"
        out[".".join(parts + [leaf])] = _tensor(arr)
    return out


def fold_split_biases(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A reference gated CNN's second bias of each convolution (`conv_b1`,
    `conv_b.<i>`, `gate_b1`, `gate_b.<i>`, any shape of hs elements) added
    into its Conv2d's `.bias`: one bias, as JAX folds them. Other keys pass
    as they are."""
    out = dict(state)
    for key in state:
        m = _SPLIT_BIAS.match(key)
        if m is None:
            continue
        prefix, tag, _, index = m.groups()
        conv = prefix + (f"{tag}_1" if index is None else f"{tag}.{index}")
        extra = out.pop(key)
        out[f"{conv}.bias"] = out[f"{conv}.bias"] + extra.reshape(-1).to(
            out[f"{conv}.bias"].dtype)
    return out


def load_tower_checkpoint(path: str, channels_num: int = 3,
                          kernel_size: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """A tower's reference-keyed state_dict: a reference `.bin` or the
    port's (a torch state_dict, a gated CNN's split biases folded; or the
    port's sharded directory), or a JAX package pickle checkpoint
    (save_checkpoint's {"tree", ...}, e.g. the JAX pretrainer's `-best`)
    through `tower_params_from_flax`."""
    import os

    from lr2ppo_torch.train.checkpoints import jax_pickle_tree, load_any

    if os.path.isdir(path):
        return fold_split_biases(load_any(path))
    tree = jax_pickle_tree(path)
    if tree is not None:
        return tower_params_from_flax(tree, channels_num, kernel_size)
    return fold_split_biases(torch.load(path, map_location="cpu",
                                        weights_only=True))


def encoder_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The keys `TowerModel` holds: a reference checkpoint's target heads
    are dropped, everything else must load with strict=True."""
    return {k: v for k, v in state.items() if k.startswith(ENCODE_PREFIXES)}
