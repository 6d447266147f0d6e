"""step_mfu.lm: the model FLOPs the traced steps need (flops/<config>.py,
forward and backward, nothing recomputed, the routed experts at the held
share) over the traced window's length times the dense bfloat16 peak of
the chips, in %."""

from perfbench.common.readers import mfu_pct


def read(obs, job):
    return mfu_pct(obs)
