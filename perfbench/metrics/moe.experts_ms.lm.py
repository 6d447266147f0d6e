"""moe.experts_ms.lm: device ms per optimizer step of the held experts'
products, forward (and the remat recompute) and backward, from the kernels
launched inside the program's `moe.experts` spans. None where the program
has no such spans."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    return per_occurrence_ms(obs, "lr2ppo.moe.experts", "optimizer_steps")
