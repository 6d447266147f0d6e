"""The PPO evaluator CLI, tabular family (counterpart of
lr2ppo_tpu/cli/ppo_eval_trad.py; reference ppo_eval_trad.sh ->
finetune/ppo_eval_trad.py):

    python -m lr2ppo_torch.cli ppo_eval_trad --pretrained_model_path best.bin \\
        --dev_path DIR_OR_H5 [--case_path case/ppo_cases.json] ...

It loads an ActorCritic checkpoint (the stage-3 `.bin`, or a JAX package
pickle), puts its actor into a ScoreModel with strict=True, ranks every
document of each test query, logs the NDCG and writes one case per query to
--case_path. Reading the grouped .h5 files needs h5py. It runs on one GPU, or
on one process per GPU under torchrun or --distributed (--dp, --tp, --zero1,
--fsdp as in JAX)."""

from __future__ import annotations

from lr2ppo_torch.cli._common import force_family, letor_eval_loader
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.data import LTRPPODataset
from lr2ppo_torch.device import compute_dtype
from lr2ppo_torch.models.scorer import ScoreModel
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.common import device_ctx
from lr2ppo_torch.train.evaluate import evaluate_cases, format_ndcg
from lr2ppo_torch.utils import init_logger


def main(argv=None, device=None) -> dict:
    """`device` defaults to the GPU (raising where there is none); the CPU
    tests pass "cpu". Returns {k: NDCG@k}."""
    cfg = force_family(parse_config(
        argv, "lr2ppo-torch PPO evaluator (tabular)"), "tabular")
    ctx = device_ctx(cfg, device, cfg.mesh.compute_dtype)
    logger = init_logger(cfg.log_path, main=ctx.is_main)
    tree = checkpoints.load_any(cfg.pretrained_model_path,
                                kind="actor_critic")
    model = ScoreModel(cfg.model, compute_dtype(cfg.mesh.compute_dtype),
                       device=ctx.device)
    model.load_state_dict(tree["actor"] if "actor" in tree else tree,
                          strict=True)
    ctx.place(model, fsdp=False)
    ev = letor_eval_loader(cfg, LTRPPODataset)
    result = evaluate_cases(model, ev.ds, ev, cfg.data.case_path,
                            put=ctx.put_eval)
    logger.info("NDCG:" + format_ndcg(result))
    return result


if __name__ == "__main__":
    main()
