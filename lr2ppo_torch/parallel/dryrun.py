"""A multi-process dry run of one LR²PPO step at tiny shapes (counterpart of
__graft_entry__.py:dryrun_multichip):

    python -m lr2ppo_torch.parallel.dryrun --world 4 [--device cpu]

For each mesh of the world (dp alone, tp alone, and dp x tp where the world
is a multiple of 4) it spawns `world` ranks, one NCCL rank per card, or
gloo processes on the CPU where the caller asks for it, each of which runs PPOTrainer.fit over one rollout
and one update (hash dropout on, the frozen reward model, an eval), and
holds the trained actor and critic against the same step in one
process. Prints one
JSON line per mesh and raises where a mesh disagrees.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import tempfile
import traceback

import numpy as np
import torch

from lr2ppo_torch.device import require_cuda

FEAT, SEQ, IMGS, TAGS, HEADS, BS = 16, 4, 2, 2, 4, 8
# a rate at which one step moves the parameters well beyond the tolerance
LR = 1e-3


class _Batches:
    """What PPOTrainer.fit reads of a loader: this dp rank's rows of one
    global batch made with numpy."""

    def __init__(self, shard=None):
        rng = np.random.default_rng(0)
        batch = {"text": rng.standard_normal((BS, TAGS, SEQ, FEAT),
                                             dtype=np.float32),
                 "img": rng.standard_normal((BS, IMGS, FEAT),
                                            dtype=np.float32),
                 "tgts": rng.integers(0, 3, (BS, TAGS)).astype(np.int32)}
        self.shard = shard
        if shard is not None:
            rank, world = shard
            per = BS // world
            batch = {k: v[rank * per:(rank + 1) * per]
                     for k, v in batch.items()}
        self.batches = [batch]

    def __len__(self):
        return 1

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass

    def first_batch(self):
        return self.batches[0]


def one_step(dp: int, tp: int, device: str) -> dict:
    """One rollout and one update on this process's mesh, at the constant
    learning rate LR (the default warmup gives a one-sweep run the rate 0);
    the actor's and the critic's full-width parameters as numpy arrays (a
    queue passes them by value), and how far the update moved them."""
    from lr2ppo_torch.config import Config, ModelConfig
    from lr2ppo_torch.data import EvalLoader
    from lr2ppo_torch.train.ppo import PPOTrainer

    mcfg = ModelConfig(family="multimodal", feat_size=FEAT, seq_length=SEQ,
                       max_imgs=IMGS, num_heads=HEADS, hash_dropout=True)
    cfg = Config(model=mcfg).replace(epochs_num=1, batch_size=BS, seed=3,
                                     output_model_path="")
    cfg.ppo.update_timesteps = 1
    cfg.optim.scheduler = "constant"
    cfg.optim.learning_rate = cfg.optim.critic_learning_rate = LR
    cfg.mesh.dp, cfg.mesh.tp = dp, tp
    trainer = PPOTrainer(cfg, device=device)
    m, init = trainer.ctx.mesh, {}

    def init_params(seed):
        models = PPOTrainer.init_params(trainer, seed)
        init.update(full_params(trainer.ctx, *models[:2]))
        return models

    trainer.init_params = init_params
    loader = _Batches((m.dp_rank, m.dp) if m.dp > 1 else None)
    ev = EvalLoader(_EvalItems(), buckets=[TAGS], batch_size=BS)
    astate, cstate, best = trainer.fit(lambda epoch: loader, ev)
    params = full_params(trainer.ctx, astate.model, cstate.model)
    moved = max(float(np.abs(v - init[k]).max()) for k, v in params.items())
    return {"params": params, "best": float(best),
            "updates": int(astate.step), "moved": moved}


def full_params(ctx, actor, critic) -> dict:
    """The actor's and the critic's full-width parameters, as numpy."""
    return {f"{side}.{k}": v.detach().float().cpu().numpy().copy()
            for side, model in (("actor", actor), ("critic", critic))
            for k, v in ctx.full_state_dict(model).items()}


class _EvalItems:
    """The global batch's items as an eval dataset."""

    def __init__(self):
        self.b = _Batches().batches[0]

    def __len__(self):
        return BS

    def get(self, i):
        return {k: v[i] for k, v in self.b.items()}


def _rank(rank, world, url, dp, tp, device, queue):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        if device == "cuda":
            require_cuda()
            torch.cuda.set_device(rank)
            dev = f"cuda:{rank}"
        else:
            dev = "cpu"
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=url, rank=rank, world_size=world)
        res = one_step(dp, tp, dev)
        queue.put((rank, res if rank == 0 else {"best": res["best"]}))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def meshes(world: int):
    """dp alone, tp alone, and dp x tp where the world holds 2 x 2."""
    out = [(world, 1), (1, world)]
    if world >= 4 and world % 2 == 0:
        out.append((world // 2, 2))
    return out


def dryrun(world: int, device: str = "cuda", timeout: float = 600.0,
           atol: float = 2e-5, rtol: float = 2e-4) -> list:
    """Run every mesh of `world` on the cards (raises without one), or on
    the CPU with device="cpu"; returns one record a mesh."""
    if device == "cuda":
        require_cuda()
    if device == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"--world {world} needs {world} cards, have "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        ref = one_step(1, 1, "cuda:0" if device == "cuda" else "cpu")
        from lr2ppo_torch.parallel import set_active

        set_active(None)
        ctx = mp.get_context("spawn")
        records = []
        for dp, tp in meshes(world):
            url = f"file://{tmp}/pg_{dp}x{tp}"
            queue = ctx.Queue()
            procs = [ctx.Process(target=_rank, args=(
                r, world, url, dp, tp, device, queue))
                for r in range(world)]
            for p in procs:
                p.start()
            got = {}
            try:
                for _ in range(world):
                    rank, res = queue.get(timeout=timeout)
                    got[rank] = res
            finally:
                for p in procs:
                    p.join(timeout=30)
                    if p.is_alive():
                        p.kill()
                        p.join()
            errors = {r: v["error"] for r, v in got.items() if "error" in v}
            if errors:
                raise RuntimeError(f"mesh {dp}x{tp}: {errors}")
            params = got[0]["params"]
            worst = max(float((np.abs(params[k] - v)
                               / (atol + rtol * np.abs(v))).max())
                        for k, v in ref["params"].items())
            rec = {"dp": dp, "tp": tp, "world": world, "device": device,
                   "updates": got[0]["updates"],
                   "best": [got[r]["best"] for r in sorted(got)],
                   "reference_best": ref["best"],
                   "reference_moved": ref["moved"],
                   "worst_over_tolerance": worst}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            if (worst > 1.0 or got[0]["updates"] != 1
                    or ref["moved"] <= atol):
                raise AssertionError(f"mesh {dp}x{tp} disagrees with one "
                                     f"process: {rec}")
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default): one NCCL rank a card; cpu: gloo "
                         "processes on the host")
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    dryrun(args.world, args.device)


if __name__ == "__main__":
    main()
