"""The measured window of a training fit.

`FitWindow` stands where the trainer expects its training loader and hands
it the program's own loader's batches. It counts optimizer steps (a step
is `per_step` batches) and acts at each step boundary, where the previous
step has been enqueued:

  * after `warm` steps (set-up: the shapes warmed, the first steps that the
    reference follows), it waits for the device, calls `on_warm`, and opens
    the window: the host clock starts, and under --trace 1 the profiler;
  * then it closes the window at the first boundary at or past `seconds`
    (--trace 1: after `trace_steps` steps), waiting for the device first,
    and ends the fit by handing out no more batches.

Under dp every rank closes at the same boundary: `agree` (an all-reduce of
the ranks' wish to close) decides.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np


class FitWindow:
    def __init__(self, loader, per_step: int, warm: int, seconds: float,
                 trace_steps: Optional[int], probes, sync: Callable,
                 on_warm: Callable, on_batch: Callable,
                 agree: Optional[Callable] = None, profiler=None):
        self.loader = loader
        self.per_step, self.warm = per_step, warm
        self.seconds, self.trace_steps = seconds, trace_steps
        self.probes, self.sync = probes, sync
        self.on_warm, self.on_batch = on_warm, on_batch
        self.agree = agree
        self.profiler = profiler
        self.count = 0                # batches handed out
        self.closed = False
        self.t_open: Optional[float] = None
        self.wall_open: Optional[float] = None
        self.window_s: Optional[float] = None
        self.steps_in_window = 0
        self.trace = None
        self.fetch_s: List[float] = []

    # what the trainers read of a loader
    def __len__(self) -> int:
        return len(self.loader)

    @property
    def shard(self):
        return getattr(self.loader, "shard", None)

    @property
    def reuse_buffers(self) -> bool:
        return getattr(self.loader, "reuse_buffers", False)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def first_batch(self) -> Dict[str, np.ndarray]:
        return self.loader.first_batch()

    def _boundary(self) -> None:
        steps = self.count // self.per_step
        if steps == self.warm and self.t_open is None:
            self.sync()
            self.on_warm()
            self.sync()
            self.wall_open = time.time()
            self.t_open = time.perf_counter()
            if self.seconds <= 0 and self.trace_steps is None:
                self.closed = True        # set-up only: no window
                return
            if self.trace_steps is not None:
                self.probes.tracing = True
                self.profiler.start()
            return
        if self.t_open is None:
            return
        done = steps - self.warm
        if self.trace_steps is not None:
            want = done >= self.trace_steps
        else:
            want = (done >= 1
                    and time.perf_counter() - self.t_open >= self.seconds)
        if self.agree is not None:
            want = self.agree(want)
        if want:
            self.sync()
            self.window_s = time.perf_counter() - self.t_open
            self.steps_in_window = done
            if self.trace_steps is not None:
                self.probes.tracing = False
                self.trace = self.profiler.stop()
            self.closed = True

    def __iter__(self):
        if self.closed:
            return
        it = iter(self.loader)
        try:
            while True:
                if self.count % self.per_step == 0:
                    self._boundary()
                    if self.closed:
                        return
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if self.probes.tracing:
                    self.fetch_s.append(time.perf_counter() - t0)
                self.on_batch(self.count, batch)
                self.count += 1
                yield batch
        finally:
            it.close()
