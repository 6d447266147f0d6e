"""mla_attention_roofline.lm: the causal attention kernel of the latent
tower (ops/mla_attention.py), forward and backward, as a share of its
roofline, in %: the calls' operations (flops/<config>.py:attention_flops,
the pairs at or below the diagonal) at the dense bfloat16 peak over their
device time, from ranges around the kernels' launches. The kernel is bound
by its products (about 2,700 operations a byte at 8,192 tokens)."""

from perfbench.common import chipmath
from perfbench.common.harness import load_module


def read(obs, job):
    flops = load_module("flops", job.cell["config"])
    bound = spent = 0.0
    for o in obs:
        for rng, backward in (("mla_fwd", False), ("mla_bwd", True)):
            calls = o["calls"].get(rng, [])
            times = o["range_us"].get(rng, [])
            if len(calls) != len(times):
                raise ValueError(f"{rng}: {len(calls)} calls, {len(times)} "
                                 "ranges traced")
            for (b, h, s, dqk, dv), us in zip(calls, times):
                if us > 0:
                    bound += (flops.attention_flops(b, h, s, dqk, dv,
                                                    backward)
                              / chipmath.BF16_TENSOR_OPS_PER_S * 1e3)
                    spent += us / 1e3
    return 100.0 * bound / spent if spent else None
