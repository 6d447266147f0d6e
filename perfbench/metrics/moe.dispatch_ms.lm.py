"""moe.dispatch_ms.lm: device ms per optimizer step of the MoE layers' own
work around the experts: the router, its correction bias and top k
(`moe.route`), the permute to the held experts' rows and the combine
(`moe.dispatch`) and the bias update after the optimizer step
(`moe.bias_update`), from the kernels launched inside the program's spans.
None where the program has no such spans."""

from perfbench.common.readers import per_occurrence_ms


def read(obs, job):
    parts = [per_occurrence_ms(obs, "lr2ppo.moe." + name, "optimizer_steps")
             for name in ("route", "dispatch", "bias_update")]
    if parts[0] is None:
        return None
    return sum(p or 0.0 for p in parts)
