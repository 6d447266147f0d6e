"""GPipe pipeline stages of the tower encoder (`--pp`) on torch.distributed
(counterpart of lr2ppo_tpu/parallel/pipeline.py).

The encoder's L layers are split into pp contiguous stages: stage s holds
layers [s * L/pp, (s+1) * L/pp) under their reference keys
(`encoder.transformer.<i>.*`), stage 0 also the embedding, the last stage
also the encoder's final norm (pre-LN stacks) and the target. One process
drives one stage at one (dp, tp) coordinate of the mesh (parallel/mesh.py):
its neighbours are the ranks of the previous and next stage at the same
(dp, tp), and Megatron tp runs inside each stage as it does without pp.

One micro-batch of B rows (this dp rank's) runs the GPipe schedule over M
microbatches of B/M rows:
  * stage 0 embeds the B rows once (the JAX `embed_only`) and cuts them;
  * every stage runs its layers on each microbatch in turn and sends the
    result to the next stage; the last stage concatenates the M results
    and runs the final norm and the target once over the B rows, so the
    loss is one masked mean over the micro-batch (summed over dp), as the
    JAX `make_pp_loss_apply` runs it (pipeline.py:275-316);
  * then the backward: the last stage's one backward reaches all M inputs;
    their gradients go back, microbatch M-1 first, and each earlier stage
    runs its microbatches' backwards in that order and passes the input
    gradients on; stage 0 ends with one backward of the embedding.
Activations and gradients move by point-to-point `dist.send`/`dist.recv`
between the two ranks (two-rank communicators on NCCL). gloo has no
send/recv of CUDA tensors, so on gloo they go through host memory; NCCL
takes the CUDA tensors directly. With `cfg.remat`, each staged layer is
recomputed in the backward (utils/remat.py), as JAX's `jax.checkpoint` of
the staged layer (pipeline.py:217-225).

Dropout: every site draws its seed from a generator seeded by the micro-step
(one draw from the trainer's generator, the same on every rank), the
microbatch and the layer's global index (the embedding its own), so a stage
needs no other stage's draws; dp ranks differ through the global-index place
of each site (ops/hash_dropout.py:shard_place), tp ranks of a stage draw the
same seeds. JAX's pp stream also differs from its plain one
(tests/test_pipeline.py), so the pp runs are held at dropout 0.

`pack_pipeline_params`/`unpack_pipeline_params` are the JAX package's
layout of a pp `.state` (the layers stacked [pp, L/pp, ...]) over the port's
reference-keyed state dicts; the port's own `.state` and model checkpoints
hold the unpacked, reference-keyed tensors (rank 0 gathers the stages).
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from lr2ppo_torch.utils.remat import remat

# key prefix of the stacked layers in the packed layout (the JAX STACK_KEY)
STACK_KEY = "_pp_stack"
_LAYER = "encoder.transformer."
_MASK64 = (1 << 64) - 1


def check_pp_supported(cfg, mesh_cfg) -> None:
    """Raise where a config is outside the pp envelope: the JAX package's
    check and messages (pipeline.py:48-73)."""
    bad = []
    if cfg.encoder != "transformer":
        bad.append(f"encoder={cfg.encoder!r} (only 'transformer')")
    if cfg.parameter_sharing:
        bad.append("parameter_sharing (one shared layer cannot stage)")
    if cfg.has_residual_attention:
        bad.append("has_residual_attention (cross-layer state)")
    if cfg.relative_position_embedding:
        bad.append("relative_position_embedding (shared bias module)")
    if cfg.factorized_embedding_parameterization:
        bad.append("factorized_embedding_parameterization")
    if cfg.decoder:
        bad.append("decoder (pp covers the encoder stack)")
    if getattr(cfg, "seq_parallel", False):
        bad.append("seq_parallel (sp constrains over a dp×tp mesh; "
                   "under the pp mesh it would be silently inert)")
    if cfg.layers_num % mesh_cfg.pp:
        bad.append(f"layers_num={cfg.layers_num} % pp={mesh_cfg.pp} != 0")
    if mesh_cfg.zero1 or mesh_cfg.fsdp:
        bad.append("zero1/fsdp (pp composes with dp and tp only)")
    if bad:
        raise ValueError("--pp does not support this config: "
                         + "; ".join(bad))


def stage_of_layer(i: int, layers_num: int, pp: int) -> int:
    return i // (layers_num // pp)


def _layer_index(key: str) -> Optional[int]:
    if not key.startswith(_LAYER):
        return None
    return int(key[len(_LAYER):].split(".", 1)[0])


def stage_owns(key: str, layers_num: int, pp: int, stage: int) -> bool:
    """Whether stage `stage` holds the reference key `key`: its layers,
    the embedding on stage 0, the final norm and the target on the last."""
    i = _layer_index(key)
    if i is not None:
        return stage_of_layer(i, layers_num, pp) == stage
    if key.startswith("embedding."):
        return stage == 0
    return stage == pp - 1


def pack_pipeline_params(state: dict, layers_num: int, pp: int) -> dict:
    """The encoder's `encoder.transformer.<i>.<rest>` tensors stacked to
    `_pp_stack.<rest>` of shape [pp, layers_num/pp, ...]; every other key
    unchanged (pipeline.py:98-112)."""
    lps = layers_num // pp
    out, layers = {}, {}
    for k, v in state.items():
        i = _layer_index(k)
        if i is None:
            out[k] = v
        else:
            layers.setdefault(k.split(".", 3)[3], {})[i] = v
    for rest, by_layer in layers.items():
        stacked = torch.stack([torch.as_tensor(by_layer[i])
                               for i in range(layers_num)])
        out[f"{STACK_KEY}.{rest}"] = stacked.reshape(
            (pp, lps) + tuple(stacked.shape[1:]))
    return out


def unpack_pipeline_params(state: dict, layers_num: int, pp: int) -> dict:
    """The inverse of pack_pipeline_params (pipeline.py:115-127)."""
    lps = layers_num // pp
    out = {}
    for k, v in state.items():
        if not k.startswith(STACK_KEY + "."):
            out[k] = v
            continue
        rest = k[len(STACK_KEY) + 1:]
        for i in range(layers_num):
            s, j = divmod(i, lps)
            out[f"{_LAYER}{i}.{rest}"] = v[s, j]
    return out


class _Elsewhere(nn.Module):
    """The place of a module another stage holds: no parameters."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def extra_repr(self) -> str:
        return f"held by stage {self.stage}"


def keep_stage(model: nn.Module, pp: int, stage: int) -> nn.Module:
    """Reduce a full TowerModel (built with its target) to what `stage`
    holds, in place: the other stages' layers, and the embedding, the final
    norm and the target where another stage holds them, become parameterless
    placeholders, so the model's state_dict holds this stage's reference
    keys only."""
    cfg = model.cfg
    enc = model.encoder
    for i in range(cfg.layers_num):
        s = stage_of_layer(i, cfg.layers_num, pp)
        if s != stage:
            enc.transformer[i] = _Elsewhere(s)
    if stage != 0:
        model.embedding = _Elsewhere(0)
    if stage != pp - 1:
        if hasattr(enc, "layer_norm"):
            enc.layer_norm = _Elsewhere(pp - 1)
        if hasattr(model, "target"):
            model.target = _Elsewhere(pp - 1)
    return model


def _mix(*keys: int) -> int:
    """splitmix64 over the keys: a generator seed."""
    h = 0x9E3779B97F4A7C15
    for k in keys:
        h = (h ^ (int(k) & _MASK64)) & _MASK64
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h & ((1 << 63) - 1)


def site_generator(base: int, microbatch: int, layer: int) -> torch.Generator:
    """The CPU generator of one layer's dropout sites in one microbatch of a
    micro-step (`layer` -1: the embedding, which sees the whole
    micro-batch)."""
    return torch.Generator().manual_seed(_mix(base, microbatch, layer + 1))


class P2P:
    """Point-to-point sends and receives of one rank's stage, counting the
    bytes and the host seconds spent in them (a receive waits for its
    sender)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = dist.get_backend() == "gloo" and device.type == "cuda"
        self.bytes = 0
        self.seconds = 0.0

    def send(self, t: torch.Tensor, dst: int) -> None:
        t0 = time.perf_counter()
        t = t.detach().contiguous()
        if self.host:
            t = t.cpu()
        dist.send(t, dst)
        self.bytes += t.numel() * t.element_size()
        self.seconds += time.perf_counter() - t0

    def recv(self, shape, dtype, src: int) -> torch.Tensor:
        t0 = time.perf_counter()
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.host else self.device)
        dist.recv(buf, src)
        self.bytes += buf.numel() * buf.element_size()
        out = buf.to(self.device)
        self.seconds += time.perf_counter() - t0
        return out


class GPipe:
    """The GPipe schedule of one stage (module docstring). `model` is the
    stage's part of a TowerModel (keep_stage, then placed on the mesh)."""

    def __init__(self, model: nn.Module, mesh, microbatches: int,
                 dtype: Optional[torch.dtype], device):
        from lr2ppo_torch.towers.layers import additive_mask_from_seg

        self.model, self.mesh, self.M = model, mesh, microbatches
        self.cfg = cfg = model.cfg
        self.mask_fn = additive_mask_from_seg
        lps = cfg.layers_num // mesh.pp
        self.layers = list(range(mesh.pp_rank * lps,
                                 (mesh.pp_rank + 1) * lps))
        self.pre = cfg.layernorm_positioning == "pre"
        # what passes between the stages: a post-LN layer's output is in
        # the layers' dtype, a pre-LN stream stays in the embedding's
        # float32
        self.wire = (dtype if dtype is not None and not self.pre
                     else torch.float32)
        self.p2p = P2P(torch.device(device))

    def _stage(self, x, seg_m, m: int, base: int, deterministic: bool):
        mask = self.mask_fn(seg_m, self.cfg.mask)
        for i in self.layers:
            blk = self.model.encoder.transformer[i]
            gen = site_generator(base, m, i)
            args = (x, mask, None, None, None, deterministic)
            if self.cfg.remat and torch.is_grad_enabled():
                x = remat(blk, *args, generator=gen)[0]
            else:
                x = blk(*args, gen)[0]
        return x

    def forward_backward(self, src, tgt, seg, base: int,
                         deterministic: bool = False):
        """One micro-batch through the schedule, forward and backward; the
        gradients add to the stage's `.grad`. Returns the last stage's
        (loss, correct, denom) on every rank of the pipeline (broadcast over
        the pp group), as detached float32 tensors."""
        from lr2ppo_torch.train.pretrain import norm_target_out

        mesh, M, model = self.mesh, self.M, self.model
        b = seg.shape[0]
        if b % M:
            raise ValueError(f"micro-batch of {b} rows does not split into "
                             f"{M} pipeline microbatches")
        mb = b // M
        shape = (mb, seg.shape[1], self.cfg.hidden_size)
        segs = seg.split(mb)
        emb = None
        xs, ys = [], []
        for m in range(M):
            if mesh.first_stage:
                if emb is None:
                    emb = model.embedding(src, seg, deterministic,
                                          site_generator(base, 0, -1))
                x = emb.detach()[m * mb:(m + 1) * mb].requires_grad_()
            else:
                x = self.p2p.recv(shape, self.wire,
                                  mesh.prev_stage).requires_grad_()
            y = self._stage(x, segs[m], m, base, deterministic)
            xs.append(x)
            ys.append(y)
            if not mesh.last_stage:
                if y.dtype != self.wire:
                    raise TypeError(f"stage output {y.dtype}, the wire "
                                    f"carries {self.wire}")
                self.p2p.send(y, mesh.next_stage)
        if mesh.last_stage:
            hidden = torch.cat(ys)
            if self.pre:
                hidden = model.encoder.layer_norm(hidden)
            out = model.target(hidden, tgt, seg)
            loss, correct, denom = norm_target_out(out, b * mesh.dp)
            loss.backward()
            metrics = torch.stack([loss.detach().float(),
                                   correct.detach().float(),
                                   torch.as_tensor(denom).detach().float()
                                   .to(loss.device)])
        else:
            for m in reversed(range(M)):
                g = self.p2p.recv(shape, ys[m].dtype, mesh.next_stage)
                torch.autograd.backward(ys[m], g)
            metrics = torch.zeros(3, device=seg.device)
        if not mesh.first_stage:
            for m in reversed(range(M)):
                self.p2p.send(xs[m].grad, mesh.prev_stage)
        elif emb is not None:
            torch.autograd.backward(emb, torch.cat([x.grad for x in xs]))
        return self._from_last(metrics)

    def _from_last(self, metrics: torch.Tensor):
        mesh = self.mesh
        last = mesh.rank + (mesh.pp - 1 - mesh.pp_rank) * mesh.tp
        if dist.get_backend(mesh.pp_group) == "gloo" and metrics.is_cuda:
            host = metrics.cpu()
            dist.broadcast(host, last, group=mesh.pp_group)
            metrics = host.to(metrics.device)
        else:
            dist.broadcast(metrics, last, group=mesh.pp_group)
        return metrics[0], metrics[1], metrics[2]


def gather_to_first(part: dict, mesh) -> dict:
    """The union of every stage's `part` (reference key -> tensor) on rank 0
    (the stages at dp 0, tp 0 send theirs as host tensors); every other
    rank gets its own part back. Every rank must call it."""
    if mesh.pp == 1:
        return part
    if mesh.dp_rank or mesh.tp_rank:
        return part
    group = mesh.host_group
    if mesh.pp_rank:
        dist.send_object_list([{k: v.detach().cpu() for k, v in part.items()}],
                              dst=0, group=group)
        return part
    out = dict(part)
    for s in range(1, mesh.pp):
        got = [None]
        dist.recv_object_list(got, src=s * mesh.tp, group=group)
        dev = next(iter(part.values())).device if part else "cpu"
        out.update({k: v.to(dev) for k, v in got[0].items()})
    return out
