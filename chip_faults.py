"""Planted faults for phase 16's parameter gap (chip_smoke.P16_PARAM_GAP):
the readings a broken pipeline or sequence-parallel run gives, so the
limit can be set between them and the sound legs' readings.

Each fault is patched into the ranks of one phase-16 leg at run time (the
package itself is not changed) and the leg is held, as phase 16 holds it,
against the same one-process reference on the same weights and corpus:

  * pp_drop_grad: pp 2 at dropout 0, the last stage sends microbatch 0's
    input gradient back as zeros, so stage 0 trains on 3/4 of the batch;
  * sp_local_param_grad: tp 2 with --sp at dropout 0.1 against tp 2
    without it, `seq_param` sums a layer norm's or a row-parallel bias's
    gradient over the rank's own tokens only (no gather).

Run from the repo root on one card: `python3 chip_faults.py`. Prints one
JSON line a fault (`param_gap`, its leaf, the loss gap); needs a card.
"""

from __future__ import annotations

import os
import tempfile

import torch

import chip_smoke as cs


def faulty_rank(rank, world, url, backend, job, queue) -> None:
    """chip_smoke.p16_rank with job["fault"] patched in first."""
    fault = job["fault"]
    if fault == "pp_drop_grad":
        from lr2ppo_torch.parallel import pipeline

        real, count = pipeline.P2P.send, [0]

        def send(self, t, dst):
            # the last stage's sends are input gradients, microbatch M-1
            # first: every M-th one (microbatch 0's) goes back as zeros
            if dst < rank:
                count[0] += 1
                if count[0] % cs.P16_MICRO == 0:
                    t = torch.zeros_like(t)
            return real(self, t, dst)

        pipeline.P2P.send = send
    elif fault == "sp_local_param_grad":
        from lr2ppo_torch.parallel import tp

        def backward(ctx, g):
            return g.sum_to_size(ctx.shape), None, None

        tp._SeqParam.backward = staticmethod(backward)
    cs.p16_rank(rank, world, url, backend, job, queue)


def main() -> None:
    dev = cs.require_cuda()
    card_line = cs.card()
    with tempfile.TemporaryDirectory() as tmp:
        paths = cs.p16_files(tmp, 61)

        def job(name, dropout, *extra, ref="ref0", reference=False,
                fault=None):
            return {"kind": "pretrain", "adafactor": False, "fault": fault,
                    "argv": cs.p16_argv(paths, os.path.join(tmp, name),
                                        dropout, *extra),
                    "ref_path": os.path.join(tmp, ref + ".pt"),
                    "reference": reference}

        j = job("ref0", False, reference=True)
        ref0 = cs.p16_pretrain_run(j["argv"], dev, False, j["ref_path"],
                                   True)
        tp2 = cs.spawn_leg("tp2", 2, "gloo",
                           job("tp2d", True, "--tp", "2", ref="tp2d",
                               reference=True), faulty_rank)[0]
        for name, jb, against in (
                ("pp2_drop_grad", job("pp2f", False, "--pp", "2",
                                      fault="pp_drop_grad"), ref0),
                ("sp2_local_param_grad", job("sp2f", True, "--tp", "2",
                                             "--sp", ref="tp2d",
                                             fault="sp_local_param_grad"),
                 tp2)):
            main_rank = cs.spawn_leg(name, 2, "gloo", jb, faulty_rank)[0]
            losses = [r["loss"] for r in main_rank["records"]]
            want = [r["loss"] for r in against["records"]]
            cs.emit(phase="planted_fault", leg=name,
                    param_gap=main_rank["param_gap"],
                    param_gap_leaf=main_rank["param_gap_leaf"],
                    param_gap_all=main_rank["param_gap_all"],
                    param_gaps=main_rank["param_gaps"], losses=losses,
                    reference_losses=want,
                    loss_gap=max(abs(a - b) / abs(b)
                                 for a, b in zip(losses, want)),
                    limit=cs.P16_PARAM_GAP, card=card_line)


if __name__ == "__main__":
    main()
