"""int8_ffn_roofline: K1, the fused int8 FFN (ops/int8_mlp.py:int8_mlp), as
a share of its roofline, in %: the sum of the calls' bounds over the sum of
their device time, from ranges around the Python entry (so it reads the
same work whatever implements it). A call's bound is the larger of its
operations, 2 x 2 x rows x D x H at the int8 peak, and its bytes (x and y,
both weights, scales and biases) at the HBM rate."""

from perfbench.common import chipmath
from perfbench.common.readers import roofline_pct


def bound_ms(call):
    rows, d, h, itemsize = call
    ops = 2.0 * 2.0 * rows * d * h
    nbytes = 2 * rows * d * itemsize + 2 * d * h + 4 * (2 * h + 2 * d)
    return chipmath.bound(nbytes, ops,
                          chipmath.INT8_TENSOR_OPS_PER_S)["bound_ms"]


def read(obs, job):
    return roofline_pct(obs, "int8_mlp", bound_ms)
