"""comm.exposed_ms.train: ms per update in which an NCCL kernel ran and no
other kernel did (the gradient all-reduce not hidden behind compute), from
the trace, the largest rank's."""


def read(obs, job):
    vals = [o["nccl_exposed_us"] / 1e3 / o["updates"] for o in obs
            if o.get("nccl_us") and o.get("updates")]
    return max(vals) if vals else None
