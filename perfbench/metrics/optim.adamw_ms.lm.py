"""optim.adamw_ms.lm: device ms of AdamW per optimizer step of the latent
MoE tower (inside ranges around AdamW.step)."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    return per_occurrence_ms(obs, "adamw", "optimizer_steps")
