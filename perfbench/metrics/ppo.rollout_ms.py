"""ppo.rollout_ms: device ms a rollout takes, from the kernels launched
inside the benchmark's ranges around each rollout call and each
requantization of the int8 twin (once a sweep)."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    roll = per_occurrence_ms(obs, "rollout", "rollouts")
    if roll is None:
        return None
    twin = per_occurrence_ms(obs, "requantize", "rollouts") or 0.0
    return roll + twin
