"""Feature projection exporter CLI (counterpart of
lr2ppo_tpu/cli/pointwise_2data_infer_trad.py; reference
pointwise_2data_infer_trad.sh -> finetune/pointwise_2data_infer_trad.py):

    python -m lr2ppo_torch.cli pointwise_2data_infer_trad \\
        --pretrained_model_path 2data.bin --input_features_path in.tsv \\
        --output_features_path out.tsv

It loads a 2-data checkpoint (the port's `.bin` or a JAX package pickle),
reads the raw dims of its two projections from their weights, and projects
every row of the tsv [label, qid, raw feats] to 768-d, writing
[label, qid, 768 floats]. It runs on one GPU and needs no h5py.
"""

from __future__ import annotations

import dataclasses

from lr2ppo_torch.cli._common import force_family
from lr2ppo_torch.device import require_cuda
from lr2ppo_torch.config import parse_config
from lr2ppo_torch.train import checkpoints
from lr2ppo_torch.train.pointwise import project_tsv


def main(argv=None, device=None) -> None:
    """`device` defaults to the GPU (raising where there is none; under a
    mesh each rank's own card); the CPU tests pass "cpu"."""
    cfg = force_family(parse_config(
        argv, "lr2ppo-torch 2-data projection exporter"), "tabular")
    # the device first: without a GPU nothing is read
    if device is None:
        require_cuda()
    state_dict = checkpoints.load_any(cfg.pretrained_model_path)
    dims = checkpoints.trad_dims_from_state_dict(state_dict)
    if dims:
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, trad_dims=dims))
    project_tsv(cfg, state_dict, cfg.data.input_features_path,
                cfg.data.output_features_path, device=device)


if __name__ == "__main__":
    main()
