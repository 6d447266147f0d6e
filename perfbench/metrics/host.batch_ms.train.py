"""host.batch_ms.train: the host's ms a training batch costs the trainer,
from the benchmark's wrappers around the loader's `next` and
`DeviceCtx.put`: the mean over the traced batches, the largest rank's."""


def read(obs, job):
    vals = [sum(o["host_batch_ms"]) / len(o["host_batch_ms"]) for o in obs
            if o.get("host_batch_ms")]
    return max(vals) if vals else None
