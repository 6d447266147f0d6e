"""ppo.update_ms: device ms an update takes (actor and critic forward,
backward and AdamW, and under dp the gradient all-reduce), from the kernels
launched inside the benchmark's ranges around each update call."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    return per_occurrence_ms(obs, "update", "updates")
