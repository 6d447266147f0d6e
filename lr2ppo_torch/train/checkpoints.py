"""The weight bridge: JAX package checkpoints and reference `.bin` files
into reference-keyed state_dicts, in numpy and torch only; the save side of
the trainers' best checkpoints; and the port's own resumable `.state`
payload (counterpart of lr2ppo_tpu/train/checkpoints.py).

The key map is the JAX package's (checkpoints.py:42-63, 148-187): flax
`kernel` (in, out) becomes torch `weight` (out, in), `scale` becomes
`weight`, and the flax `trunk` scope is dropped. The port's modules use the
reference layout, so every load is `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Dict

import numpy as np
import torch

# torch tail -> flax tail inside one XiT block (checkpoints.py:_XIT_TAILS)
_XIT_TAILS = {
    "0.0.0.fn.0.ln_x.weight": ("ln_x", "scale"),
    "0.0.0.fn.0.ln_x.bias": ("ln_x", "bias"),
    "0.0.0.fn.0.ln_y.weight": ("ln_y", "scale"),
    "0.0.0.fn.0.ln_y.bias": ("ln_y", "bias"),
    "0.0.0.fn.1.queries.weight": ("attn", "queries", "kernel"),
    "0.0.0.fn.1.queries.bias": ("attn", "queries", "bias"),
    "0.0.0.fn.1.keys.weight": ("attn", "keys", "kernel"),
    "0.0.0.fn.1.keys.bias": ("attn", "keys", "bias"),
    "0.0.0.fn.1.values.weight": ("attn", "values", "kernel"),
    "0.0.0.fn.1.values.bias": ("attn", "values", "bias"),
    "0.0.0.fn.1.projection.weight": ("attn", "projection", "kernel"),
    "0.0.0.fn.1.projection.bias": ("attn", "projection", "bias"),
    "0.0.1.fn.0.weight": ("ln_ffn", "scale"),
    "0.0.1.fn.0.bias": ("ln_ffn", "bias"),
    "0.0.1.fn.1.0.weight": ("ffn_fc1", "kernel"),
    "0.0.1.fn.1.0.bias": ("ffn_fc1", "bias"),
    "0.0.1.fn.1.3.weight": ("ffn_fc2", "kernel"),
    "0.0.1.fn.1.3.bias": ("ffn_fc2", "bias"),
    "1.0.weight": ("ln_out", "scale"),
    "1.0.bias": ("ln_out", "bias"),
}
_INV_TAILS = {v: k for k, v in _XIT_TAILS.items()}


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, node


def params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A flax param tree of numpy arrays (optionally under "params") ->
    reference-keyed state_dict of torch tensors (flax_to_torch's map)."""
    tree = tree.get("params", tree)
    out = {}
    for path, arr in _flatten(tree):
        arr = np.asarray(arr)
        if path[-1] == "kernel":
            arr = arr.T
        if path[0] == "trunk" and path[1] == "xit":
            key = f"xit.{_INV_TAILS[path[2:]]}"
        elif path[0] == "trunk":
            leaf = "weight" if path[-1] == "kernel" else "bias"
            key = f"{path[1]}.{path[2]}.{leaf}"
        elif path[0] == "xitt":
            key = f"xitt.{_INV_TAILS[path[1:]]}"
        elif path[0] == "pos_emb":
            key = "pos_emb.weight"
        elif path[0] == "head":
            key = "head.weight" if path[-1] == "kernel" else "head.bias"
        elif path[0].startswith("text_proj"):    # 2-data projections
            leaf = "weight" if path[-1] == "kernel" else "bias"
            key = f"{path[0]}.{path[1]}.{leaf}"
        else:
            raise KeyError(f"unmapped flax path {path}")
        # a row-major copy: the tensor must not alias the caller's numpy
        # buffer, and a transposed kernel must not stay column-major
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def trad_dims_from_state_dict(state_dict: dict) -> list:
    """The raw feature dims of a 2-data checkpoint's projections, from the
    in-dim of their fc1 weights (out, in): text_proj for trad_dims[0],
    text_proj3 for trad_dims[1] (the reference naming,
    pointwise_2data_trad.py:136-137; lr2ppo_tpu/cli/
    pointwise_2data_infer_trad.py:_dims_from_params). Empty where the
    checkpoint has neither."""
    return [int(state_dict[f"{name}.fc1.weight"].shape[1])
            for name in ("text_proj", "text_proj3")
            if f"{name}.fc1.weight" in state_dict]


def split_actor_critic(state_dict: dict):
    """Split an ActorCritic checkpoint ('actor.'/'critic.' prefixes,
    reference ppo_eval.py:336-343) into two single-model state_dicts."""
    actor, critic = {}, {}
    for k, v in state_dict.items():
        if k.startswith("actor."):
            actor[k[len("actor."):]] = v
        elif k.startswith("critic."):
            critic[k[len("critic."):]] = v
        else:
            raise KeyError(f"unexpected ActorCritic key: {k}")
    return actor, critic


def _save(obj, path: str) -> None:
    """torch.save through a temporary file and a rename, so a crash
    mid-write leaves the previous file in place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _host(sd) -> dict:
    """A state_dict (or a module's) on the host."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_model(path: str, model) -> None:
    """Write one model's reference-keyed state_dict (a module, or a
    full-width state_dict gathered under a mesh) as a `.bin`, as the
    reference's model_saver.py does for stages 1 and 2; `load_any(path)`
    reads it back, the JAX package's load_any too."""
    _save(_host(model), path)


def save_actor_critic(path: str, actor, critic) -> None:
    """Write both models as one reference-keyed ActorCritic `.bin`
    ('actor.'/'critic.' prefixes, reference ppo_eval.py:336-343).
    `load_any(path, kind="actor_critic")` reads it back."""
    _save({f"{prefix}.{k}": v
           for prefix, model in (("actor", actor), ("critic", critic))
           for k, v in _host(model).items()}, path)


# the `format` entry of the port's .state payload
STATE_FORMAT = "lr2ppo_torch.state/1"


def check_backend(backend: str) -> None:
    """The port writes every checkpoint with torch.save; the JAX package's
    orbax backends raise, as load_any does for orbax directories."""
    if backend != "pickle":
        raise ValueError(
            f"ckpt_backend {backend!r}: lr2ppo_torch writes torch.save "
            "files only; the orbax backends are the JAX package's")


def save_state(path: str, models: dict, optims: dict, generator, **counters
               ) -> None:
    """The resumable `.state` payload, the port's own format: each model's
    state_dict and each optimizer's state_dict (AdamW's moments and count,
    Adafactor's second moments and count; by the same names), the
    dropout generator's state and the counters (step, best, ...). Models
    and optimizers may be given as their state_dicts."""
    def host_tree(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu()
        if isinstance(node, dict):
            return {k: host_tree(v) for k, v in node.items()}
        return node

    _save({"format": STATE_FORMAT,
           "models": {k: _host(m) for k, m in models.items()},
           "optims": {k: host_tree(o if isinstance(o, dict)
                                   else o.state_dict())
                      for k, o in optims.items()},
           "generator": generator.get_state(), **counters}, path)


def load_state(path: str) -> dict:
    """Read a `.state` written by save_state. A JAX package `.state` (an
    orbax directory, or a pickle of optax trees) raises: the port cannot
    resume it, and loads nothing of it."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory, a JAX package .state; "
            "lr2ppo_torch resumes only its own .state files")
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a .state of lr2ppo_torch (a torch.save file); a "
            "JAX package .state is a pickle of optax trees, which the port "
            "cannot resume. Resume it with lr2ppo_tpu, or start the port "
            "from its best checkpoint with --pretrained_model_path")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != STATE_FORMAT:
        raise ValueError(f"{path} is a torch file but not a .state of "
                         f"lr2ppo_torch (format {STATE_FORMAT!r})")
    return payload


def jax_pickle_tree(path: str):
    """The param tree of a JAX package pickle checkpoint (save_checkpoint's
    {"tree": ..., "metadata": ...}, numpy leaves), or None where `path` is
    not one (a torch file)."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)["tree"]
    except (pickle.UnpicklingError, EOFError, KeyError, UnicodeDecodeError,
            TypeError):
        return None


def load_any(path: str, kind: str = "single"):
    """Load a JAX package pickle checkpoint (save_checkpoint: its leaves are
    numpy arrays) or a reference torch `.bin`, as reference-keyed
    state_dicts.

    A pickle of one model gives one state_dict; a pickle holding
    {"actor", "critic"} subtrees, or a `.bin` read with
    kind="actor_critic", gives {"actor": ..., "critic": ...}. Orbax
    checkpoint directories are JAX-only and raise."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory, which only the JAX "
            "package reads; save with the 'pickle' backend to serve it here")
    tree = jax_pickle_tree(path)
    if tree is None:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if kind == "actor_critic":
            actor, critic = split_actor_critic(sd)
            return {"actor": actor, "critic": critic}
        return sd
    if "actor" in tree or "critic" in tree:
        return {k: params_from_flax(v) for k, v in tree.items()}
    return params_from_flax(tree)
