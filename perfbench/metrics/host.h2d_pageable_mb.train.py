"""host.h2d_pageable_mb.train: the part of host.h2d_mb.train copied from
pageable (not pinned) host memory, from the program's counter
h2d.pageable_bytes, MB a batch."""

from perfbench.common.program_trace import per_batch_mb


def read(obs, job):
    return per_batch_mb(obs, "h2d.pageable_bytes")
