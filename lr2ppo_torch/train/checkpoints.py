"""The weight bridge: JAX package checkpoints and reference `.bin` files
into reference-keyed state_dicts, in numpy and torch only; the save side of
the trainers' best checkpoints; the port's own resumable `.state` payload;
and the three checkpoint backends (counterpart of
lr2ppo_tpu/train/checkpoints.py).

The backends keep the JAX package's names. 'pickle' writes one torch.save
file from rank 0 (a mesh gathers every tensor to full width first).
'orbax' and 'orbax_async' write the port's own sharded directory, not an
orbax one:

  <path>/manifest.json      {"format": SHARDED_FORMAT, "kind", "version",
                             "world", "files"}
  <path>/v<version>/rank_<r>.pt
                            what rank r holds: each tensor it owns with its
                            place in the whole, [(dim, index, parts), ...]
                            outermost first, and on rank 0 the plain values

A tensor split over a mesh axis is written by every rank of that axis as its
part; one replicated over an axis by the rank at index 0 there, so the
files hold one state between them and no rank gathers anything. The reader
puts each tensor together from its parts, refusing a part missing or held
twice, and gives the payload the pickle backend would have written. The
manifest is replaced atomically once every rank's file is in, so a crash
mid-write leaves the previous version loadable. 'orbax_async' copies this
rank's tensors to the host before `save` returns and writes them from a
background thread; at most one save is in flight, and every load, the end
of every fit and the process's exit settle it (wait_for_async_saves), which
re-raises a failure of the write.

The key map is the JAX package's (checkpoints.py:42-63, 148-187): flax
`kernel` (in, out) becomes torch `weight` (out, in), `scale` becomes
`weight`, and the flax `trunk` scope is dropped. The port's modules use the
reference layout, so every load is `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import atexit
import json
import os
import pickle
import re
import shutil
import threading
import zipfile
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

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
    mid-write leaves the previous file in place (a sharded directory at
    `path` is removed first)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    if is_sharded(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _host(sd) -> dict:
    """A state_dict (or a module's) on the host."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_model(path: str, model, backend: str = "pickle") -> None:
    """Write one model's reference-keyed state_dict as a `.bin`, as the
    reference's model_saver.py does for stages 1 and 2 (pickle: a module,
    or a full-width state_dict gathered under a mesh), or as a sharded
    directory (a module, or DeviceCtx.local_state_dict's Parts);
    `load_any(path)` reads either back, the JAX package's load_any the
    `.bin`."""
    check_backend(backend)
    if backend == "pickle":
        _save(_host(model), path)
    else:
        save_sharded(path, _parts(model), "model",
                     backend == "orbax_async")


def save_actor_critic(path: str, actor, critic,
                      backend: str = "pickle") -> None:
    """Write both models as one reference-keyed ActorCritic `.bin`
    ('actor.'/'critic.' prefixes, reference ppo_eval.py:336-343), or as a
    sharded directory of the same keys. `load_any(path,
    kind="actor_critic")` reads it back."""
    check_backend(backend)
    if backend == "pickle":
        _save({f"{prefix}.{k}": v
               for prefix, model in (("actor", actor), ("critic", critic))
               for k, v in _host(model).items()}, path)
    else:
        save_sharded(path, {f"{prefix}.{k}": v
                            for prefix, model in (("actor", actor),
                                                  ("critic", critic))
                            for k, v in _parts(model).items()},
                     "model", backend == "orbax_async")


# the `format` entry of the port's .state payload
STATE_FORMAT = "lr2ppo_torch.state/1"


BACKENDS = ("pickle", "orbax", "orbax_async")


def check_backend(backend: str) -> None:
    """An unknown backend raises; it must not fall through to pickle."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown ckpt_backend {backend!r}; expected one of {BACKENDS}")


# -- the sharded directory ('orbax', 'orbax_async') --------------------------
SHARDED_FORMAT = "lr2ppo_torch.sharded/1"
MANIFEST = "manifest.json"
# what a sharded directory holds, committed or not
_STAGED = re.compile(r"^(v\d+|manifest\.json(\.tmp)?)$")


class Part(NamedTuple):
    """A tensor this rank writes, and its place in the whole: (dim, index,
    parts) for each split, outermost first ((), the whole tensor)."""
    tensor: torch.Tensor
    splits: tuple = ()


def local_part(t: torch.Tensor, splits: list, mesh) -> Optional[Part]:
    """The Part of a sharded checkpoint that this rank writes for `t`: its
    splits [(dim, index, parts, axis)] over the "tp" and "dp" axes; None
    where another rank writes it (a tensor whole along an axis is written
    by the rank at index 0 there)."""
    axes = {axis for *_, axis in splits}
    if ("tp" not in axes and mesh.tp_rank) or ("dp" not in axes
                                               and mesh.dp_rank):
        return None
    return Part(t, tuple((d, i, n) for d, i, n, _ in splits))


def is_sharded(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST))


def _manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(f"{path}: manifest format {manifest.get('format')!r}"
                         f", lr2ppo_torch reads {SHARDED_FORMAT!r}")
    return manifest


def _refuse_directory(path: str) -> None:
    """A directory that is not the port's sharded checkpoint: an orbax
    directory of the JAX package, or something else."""
    if not is_sharded(path):
        raise ValueError(
            f"{path} is a directory but not a sharded checkpoint of "
            "lr2ppo_torch (no manifest.json); an orbax checkpoint directory "
            "is the JAX package's (lr2ppo_tpu), which the port does not "
            "read: load it with lr2ppo_tpu, or save with lr2ppo_torch")


def _flatten_tree(node, path=()):
    """(path, leaf) pairs; an empty dict is a leaf, so it is kept."""
    if isinstance(node, dict) and (node or not path):
        for k, v in node.items():
            yield from _flatten_tree(v, path + (k,))
    else:
        yield path, node


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class _Saves:
    """The process's sharded saves: the checkpoint's own gloo group (its
    barriers never share a communicator with training's collectives, which
    may run at the same time), and the one asynchronous write in flight."""

    def __init__(self):
        self.group = None
        self.world_group = None
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        atexit.register(self.settle)

    def process_group(self):
        if not dist.is_initialized():
            return None
        if self.world_group is not dist.group.WORLD:
            # every rank makes it at its first sharded save, in step
            self.group = dist.new_group(backend="gloo")
            self.world_group = dist.group.WORLD
        return self.group

    def settle(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        error, self.error = self.error, None
        if error is not None:
            raise RuntimeError("an asynchronous checkpoint save failed"
                               ) from error

    def run(self, fn, asynchronous: bool) -> None:
        if not asynchronous:
            fn()
            return

        def body():
            try:
                fn()
            except BaseException as e:   # re-raised at the next settle
                self.error = e

        self.thread = threading.Thread(target=body, name="checkpoint-save",
                                       daemon=False)
        self.thread.start()


_SAVES = _Saves()


def wait_for_async_saves() -> None:
    """Block until the 'orbax_async' save in flight is on disk, and re-raise
    its failure; nothing to do for the other backends."""
    _SAVES.settle()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A compact copy off the live tensor, on the host (torch.save writes a
    view's whole storage, so a part must not stay a view of the whole)."""
    return t.detach().to("cpu", copy=True).contiguous()


def _next_version(path: str, group) -> int:
    """The version this save writes, agreed by every rank: rank 0 makes the
    directory (replacing a file of the pickle backend) and reads the
    current manifest."""
    rank = dist.get_rank() if group is not None else 0
    answer = [None]
    if rank == 0:
        try:
            if os.path.isfile(path):
                os.remove(path)
            elif os.path.isdir(path) and not all(
                    _STAGED.match(name) for name in os.listdir(path)):
                _refuse_directory(path)
            os.makedirs(path, exist_ok=True)
            answer[0] = (_manifest(path)["version"] + 1 if is_sharded(path)
                         else 1)
        except (OSError, ValueError) as e:
            answer[0] = f"{type(e).__name__}: {e}"
    if group is not None:
        dist.broadcast_object_list(answer, src=0, group=group)
    if isinstance(answer[0], str):
        raise ValueError(f"cannot write a sharded checkpoint at {path}: "
                         f"{answer[0]}")
    return answer[0]


def save_sharded(path: str, tree: dict, kind: str,
                 asynchronous: bool = False) -> None:
    """Write `tree` (nested dicts; leaves a Part, a tensor or a plain value)
    as this rank's file of the sharded directory at `path`. A Part is
    written with its place; every other leaf only by rank 0, which must hold
    them all. Every rank of the process group calls it. With
    `asynchronous`, the write runs in the background once the tensors are
    copied to the host (settled by wait_for_async_saves)."""
    _SAVES.settle()
    group = _SAVES.process_group()
    rank = dist.get_rank() if group is not None else 0
    world = dist.get_world_size() if group is not None else 1
    version = _next_version(path, group)
    tensors, values = [], []
    for keys, leaf in _flatten_tree(tree):
        if isinstance(leaf, Part):
            tensors.append([list(keys), _host_copy(leaf.tensor),
                            [list(s) for s in leaf.splits]])
        elif rank == 0:
            if isinstance(leaf, torch.Tensor):
                leaf = _host_copy(leaf)
            values.append([list(keys), leaf])
    data = f"v{version}"
    payload = {"format": SHARDED_FORMAT, "rank": rank, "tensors": tensors,
               "values": values}

    def write():
        os.makedirs(os.path.join(path, data), exist_ok=True)
        target = os.path.join(path, data, f"rank_{rank}.pt")
        torch.save(payload, target + ".tmp")
        os.replace(target + ".tmp", target)
        if group is not None:
            dist.barrier(group=group)
        if rank == 0:
            manifest = {"format": SHARDED_FORMAT, "kind": kind,
                        "version": version, "world": world, "data": data,
                        "files": [f"rank_{r}.pt" for r in range(world)]}
            tmp = os.path.join(path, MANIFEST + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(path, MANIFEST))
            for name in os.listdir(path):
                if name.startswith("v") and name != data:
                    shutil.rmtree(os.path.join(path, name),
                                  ignore_errors=True)
        if group is not None:
            dist.barrier(group=group)

    _SAVES.run(write, asynchronous)


def _assemble(parts: list, where: str) -> torch.Tensor:
    """One tensor from its parts [(splits, tensor)]: exactly one whole
    part, or for the outermost split each index 0..parts-1 once, put
    together along its dim."""
    whole = [t for splits, t in parts if not splits]
    if whole:
        if len(parts) != 1:
            raise ValueError(f"{where}: {len(parts)} parts where one holds "
                             "the whole tensor")
        return whole[0]
    heads = {(s[0][0], s[0][2]) for s, _ in parts}
    if len(heads) != 1:
        raise ValueError(f"{where}: parts split in different ways {heads}")
    (dim, n), = heads
    by_index = {}
    for splits, t in parts:
        by_index.setdefault(splits[0][1], []).append((splits[1:], t))
    if sorted(by_index) != list(range(n)):
        raise ValueError(f"{where}: parts {sorted(by_index)} of {n} along "
                         f"dim {dim}")
    return torch.cat([_assemble(by_index[i], where) for i in range(n)],
                     dim=dim)


def rank_files(path: str) -> list:
    """The paths of the rank files of the sharded directory's current
    version."""
    manifest = _manifest(path)
    return [os.path.join(path, manifest["data"], f)
            for f in manifest["files"]]


def load_sharded(path: str):
    """(tree, kind) of a sharded directory: every tensor at full width, on
    the host."""
    wait_for_async_saves()
    _refuse_directory(path)
    kind = _manifest(path)["kind"]
    tree: dict = {}
    parts: dict = {}
    for f in rank_files(path):
        payload = torch.load(f, map_location="cpu", weights_only=True)
        for keys, t, splits in payload["tensors"]:
            parts.setdefault(tuple(keys), []).append(
                (tuple(tuple(s) for s in splits), t))
        for keys, value in payload["values"]:
            _put(tree, tuple(keys), value)
    for keys, got in parts.items():
        _put(tree, keys, _assemble(got, f"{path}: {'/'.join(keys)}"))
    return tree, kind


def _parts(sd: dict) -> dict:
    """A state_dict (or a module's) as whole Parts."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return {k: v if isinstance(v, Part) else Part(v.detach())
            for k, v in sd.items()}


def save_state(path: str, models: dict, optims: dict, generator,
               backend: str = "pickle", **counters) -> None:
    """The resumable `.state` payload, the port's own format: each model's
    state_dict and each optimizer's state_dict (AdamW's moments and count,
    Adafactor's second moments and count; by the same names), the
    dropout generator's state and the counters (step, best, ...). Models
    and optimizers may be given as their state_dicts; for the sharded
    backends their tensors may be Parts (DeviceCtx.local_state_dict), and
    an optimizer object gives its local_state()."""
    check_backend(backend)

    def host_tree(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu()
        if isinstance(node, dict):
            return {k: host_tree(v) for k, v in node.items()}
        return node

    def part_tree(node):
        if isinstance(node, torch.Tensor):
            return Part(node.detach())
        if isinstance(node, dict):
            return {k: part_tree(v) for k, v in node.items()}
        return node

    optims = {k: o if isinstance(o, dict) else (
        o.state_dict() if backend == "pickle" else o.local_state())
        for k, o in optims.items()}
    if backend == "pickle":
        _save({"format": STATE_FORMAT,
               "models": {k: _host(m) for k, m in models.items()},
               "optims": host_tree(optims),
               "generator": generator.get_state(), **counters}, path)
        return
    save_sharded(path, {"format": STATE_FORMAT,
                        "models": {k: _parts(m) for k, m in models.items()},
                        "optims": part_tree(optims),
                        "generator": generator.get_state(), **counters},
                 "state", backend == "orbax_async")


def load_state(path: str) -> dict:
    """Read a `.state` written by save_state, in either form. A JAX package
    `.state` (an orbax directory, or a pickle of optax trees) raises: the
    port cannot resume it, and loads nothing of it."""
    wait_for_async_saves()
    if os.path.isdir(path):
        payload, kind = load_sharded(path)
        if kind != "state" or payload.get("format") != STATE_FORMAT:
            raise ValueError(f"{path} is a sharded checkpoint of "
                             f"lr2ppo_torch but not a .state ({kind})")
        return payload
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
    kind="actor_critic", gives {"actor": ..., "critic": ...}. A sharded
    directory of the port (the 'orbax' backends) gives what its `.bin`
    would; an orbax directory of the JAX package raises."""
    wait_for_async_saves()
    if os.path.isdir(path):
        sd, saved = load_sharded(path)
        if saved != "model":
            raise ValueError(f"{path} is a sharded {saved}, not a model "
                             "checkpoint")
    else:
        tree = jax_pickle_tree(path)
        if tree is not None:
            if "actor" in tree or "critic" in tree:
                return {k: params_from_flax(v) for k, v in tree.items()}
            return params_from_flax(tree)
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if kind == "actor_critic":
        actor, critic = split_actor_critic(sd)
        return {"actor": actor, "critic": critic}
    return sd
