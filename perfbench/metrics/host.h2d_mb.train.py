"""host.h2d_mb.train: MB a training batch copies from the host to the
device, from the program's counter h2d.bytes (the bytes DeviceCtx.put and
put_array hand to the device) over the traced window's batches."""

from perfbench.common.program_trace import per_batch_mb


def read(obs, job):
    return per_batch_mb(obs, "h2d.bytes")
