"""attn.mla_ms.lm: device ms per optimizer step of the latent tower's
attention sub-block: the kernels launched inside the program's `attn.mla`
spans (the projections, the norm, RoPE and the attention kernel, forward
and the remat recompute) and inside its `attn.kernel_bwd` spans (the
attention kernel's backward). The sub-block's other backward kernels run
outside any span and are not counted. None where the program has no such
spans."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    fwd = per_occurrence_ms(obs, "lr2ppo.attn.mla", "optimizer_steps")
    if fwd is None:
        return None
    return fwd + (per_occurrence_ms(obs, "lr2ppo.attn.kernel_bwd",
                                    "optimizer_steps") or 0.0)
