"""step_mfu.pretrain: the model FLOPs the traced steps need (the MLM head only
at the positions the loss reads) (flops/<config>.py,
forward and backward, nothing recomputed) over the traced window's length
times the dense bfloat16 peak of the chips, in %."""

from perfbench.common.readers import mfu_pct


def read(obs, job):
    return mfu_pct(obs)
