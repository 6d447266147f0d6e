"""device.idle_share.lm: the share of the traced window in which no kernel
ran on the device, in %, averaged over the chips."""

from perfbench.common.readers import idle_pct


def read(obs, job):
    return idle_pct(obs)
