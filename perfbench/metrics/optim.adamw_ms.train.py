"""optim.adamw_ms.train: device ms of AdamW per update, both models' steps
(inside ranges around AdamW.step, which under dp runs after the gradient
all-reduce and holds no NCCL kernel)."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    return per_occurrence_ms(obs, "adamw", "updates")
