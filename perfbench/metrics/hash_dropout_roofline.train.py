"""hash_dropout_roofline.train: hash dropout (ops/hash_dropout.py, forward
and backward) as a share of its HBM roofline, in %, over the calls whose
input is larger than the L2 (below it the input may never leave the L2, and
an HBM bound is no bound): the bytes read and written at the HBM rate over
the device time, from ranges around each call."""

from perfbench.common import chipmath
from perfbench.common.readers import hbm_bound_ms, roofline_pct


def bound_ms(call):
    numel, itemsize = call
    if numel * itemsize <= chipmath.L2_BYTES:
        return None
    return hbm_bound_ms(2.0 * numel * itemsize)


def read(obs, job):
    return roofline_pct(obs, "hash_dropout", bound_ms)
