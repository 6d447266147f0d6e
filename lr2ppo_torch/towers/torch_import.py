"""Tower weights (counterpart of lr2ppo_tpu/towers/torch_import.py).

The port's tower modules carry the TencentPretrain key layout, so a
reference tower `.bin` needs no conversion: `load_tower_checkpoint` reads it
(or a JAX package pickle checkpoint of a tower, through the bridge) and
`encoder_state` keeps what `encode` reads. `tower_params_from_flax` is the
weight bridge from the JAX package: a flax tower tree of numpy arrays into
that layout, the inverse of the JAX package's `torch_tower_to_flax` for the
embedding, transformer-encoder, decoder and target keys:

  flax                                      torch
  embedding/<kind>/embedding                embedding.<kind>.embedding.weight
  tgt_embedding/<kind>/embedding            tgt_embedding.<kind>.embedding.weight
  embedding/patch/projection (C*P*P, E)     embedding.patch.projection.weight
                                            (E, C, P, P)
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
  gamma, beta, bias, cls_emb, 1-d weight    as they are
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

from lr2ppo_torch.towers.targets import TARGET_KINDS

_INDEXED = re.compile(r"^(transformer|linear_layers)_(\d+)$")
# the JAX decoder's flat layer names: transformer_decoder_<i>_<sub>
_DECODER_LAYER = re.compile(r"^(transformer_decoder)_(\d+)_(.+)$")
_ROOTS = {"embedding": "embedding", "encoder": "encoder",
          "target": "target", "tgt_embedding": "tgt_embedding",
          "decoder_mod": "decoder"}

# the module prefixes encode reads; a reference .bin also holds the target
# heads (`target.*`), which only pretraining reads
ENCODE_PREFIXES = ("embedding.", "encoder.")


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, node


def tower_params_from_flax(tree: dict,
                           channels_num: int = 3) -> Dict[str, torch.Tensor]:
    """A JAX TowerModel param tree (optionally under "params") of numpy
    arrays -> the port's reference-keyed state_dict. `channels_num` splits
    the patch kernel's C*P*P rows back into (C, P, P)."""
    tree = tree.get("params", tree)
    out = {}
    for path, arr in _flatten(tree):
        if path[0] not in _ROOTS or (
                path[0] == "target" and path[1] not in TARGET_KINDS):
            raise KeyError(f"flax path {path} is outside the embeddings, "
                           "encoder, decoder and targets the port has")
        arr = np.asarray(arr)
        parts = [_ROOTS[path[0]]]
        for p in path[1:-1]:
            m = _INDEXED.match(p) or _DECODER_LAYER.match(p)
            parts += list(m.groups()) if m else [p]
        leaf = path[-1]
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
        # a row-major copy that does not alias the caller's buffer
        out[".".join(parts + [leaf])] = torch.from_numpy(
            np.array(arr, copy=True, order="C"))
    return out


def load_tower_checkpoint(path: str,
                          channels_num: int = 3) -> Dict[str, torch.Tensor]:
    """A tower's reference-keyed state_dict: a reference `.bin` or the
    port's (a torch state_dict) as it is, or a JAX package pickle checkpoint
    (save_checkpoint's {"tree", ...}, e.g. the JAX pretrainer's `-best`)
    through `tower_params_from_flax`."""
    from lr2ppo_torch.train.checkpoints import jax_pickle_tree

    tree = jax_pickle_tree(path)
    if tree is not None:
        return tower_params_from_flax(tree, channels_num)
    return torch.load(path, map_location="cpu", weights_only=True)


def encoder_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The keys `TowerModel` holds: a reference checkpoint's target heads
    are dropped, everything else must load with strict=True."""
    return {k: v for k, v in state.items() if k.startswith(ENCODE_PREFIXES)}
