"""The device trace of a run's traced steps: a torch.profiler window, and its
Chrome trace read back into kernels, copies, host launches and the
benchmark's own ranges.

The benchmark marks calls into the program with `torch.profiler.
record_function` ranges named `bench.<what>` (see `probe`). A device
operation belongs to a range when the host call that launched it (its
CUDA runtime event, matched by correlation id) lies inside the range on the
host's clock. That holds for the backward pass too, whose launches come
from autograd's own thread while the range's thread waits in backward().

The busy and idle arithmetic and the summary by kernel name are frozen
copies of chip_smoke.py:634-676 (`trace_summary`).
"""

from __future__ import annotations

import bisect
import json
import os
from contextlib import contextmanager
from typing import Dict, List, Tuple

from perfbench.common.chipmath import union_us

PREFIX = "bench."
# device operations that are not kernels
COPY_CATS = ("gpu_memcpy", "gpu_memset")


@contextmanager
def probe(name: str):
    """A `bench.<name>` range on the host, read back by `Trace`."""
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


class Profiler:
    """torch.profiler over CPU and CUDA, started and stopped at step
    boundaries; `stop` writes the Chrome trace to `path` and reads it."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> "Trace":
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            return Trace.load(self.path)
        finally:
            os.remove(self.path)


class Trace:
    """Device operations `ops` (name, start us, end us, category, launch
    time on the host's clock or None) and the benchmark's ranges `ranges`
    {name: [(start us, end us), ...]} in host order."""

    def __init__(self, ops: List[tuple], ranges: Dict[str, List[tuple]]):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.ranges = ranges

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        launch: Dict[int, float] = {}
        device, ranges = [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = args.get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
            elif cat == "kernel" or cat in COPY_CATS:
                device.append(e)
            elif cat == "user_annotation" and e.get("name", "").startswith(
                    PREFIX):
                start = float(e["ts"])
                ranges.setdefault(e["name"][len(PREFIX):], []).append(
                    (start, start + float(e.get("dur", 0.0))))
        ops = []
        for e in device:
            start = float(e["ts"])
            corr = (e.get("args") or {}).get("correlation")
            ops.append((e.get("name", ""), start,
                        start + float(e.get("dur", 0.0)), e.get("cat"),
                        launch.get(corr)))
        for spans in ranges.values():
            spans.sort()
        return cls(ops, ranges)

    # -- the whole window ---------------------------------------------------
    def kernels(self) -> List[tuple]:
        return [o for o in self.ops if o[3] == "kernel"]

    def window_us(self) -> float:
        if not self.ops:
            return 0.0
        return max(o[2] for o in self.ops) - min(o[1] for o in self.ops)

    def busy_us(self) -> float:
        """The time in which some device operation ran."""
        return union_us([(o[1], o[2]) for o in self.ops])

    def kernel_busy_us(self) -> float:
        """The time in which some kernel ran (chip_smoke's idle share
        counts kernels only)."""
        return union_us([(o[1], o[2]) for o in self.kernels()])

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        out: Dict[str, Tuple[float, int]] = {}
        for name, start, end, _cat, _l in self.ops:
            us, n = out.get(name, (0.0, 0))
            out[name] = (us + end - start, n + 1)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, [name, seconds]."""
        rows = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:120], us / 1e6] for name, (us, _n) in rows]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations, [what the host was
        doing, seconds]: the innermost benchmark range open on the host at
        the gap's start (the clocks are the profiler's one clock)."""
        gaps, reach = [], None
        for _name, start, end, _cat, _l in self.ops:
            if reach is not None and start > reach:
                gaps.append((start - reach, reach))
            reach = end if reach is None else max(reach, end)
        gaps.sort(reverse=True)
        return [[self.host_at(at), us / 1e6] for us, at in gaps[:n]]

    def host_at(self, t: float) -> str:
        best, width = "outside the benchmark's ranges", float("inf")
        for name, spans in self.ranges.items():
            for s, e in spans:
                if s <= t < e and e - s < width:
                    best, width = f"host in {name}", e - s
        return best

    # -- per range ----------------------------------------------------------
    def in_range(self, name: str, kernels_only: bool = True
                 ) -> List[List[tuple]]:
        """The device operations launched inside each occurrence of the
        range `name`, in host order."""
        spans = self.ranges.get(name, [])
        out: List[List[tuple]] = [[] for _ in spans]
        starts = [s for s, _ in spans]
        for op in self.ops:
            if (kernels_only and op[3] != "kernel") or op[4] is None:
                continue
            t = op[4]
            i = bisect.bisect_right(starts, t) - 1
            # occurrences of one range never overlap one another
            if i >= 0 and t <= spans[i][1]:
                out[i].append(op)
        return out

    def range_device_us(self, name: str) -> List[float]:
        """Device time of the kernels launched inside each occurrence of the
        range `name`."""
        return [sum(o[2] - o[1] for o in ops) for ops in self.in_range(name)]


def breakdown(traces: List[Trace]) -> dict:
    """The result line's `breakdown`: the first trace's ten longest device
    operations and ten longest idle gaps, in seconds."""
    t = traces[0]
    return {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
