"""Failure detection and profiling hooks (counterpart of
lr2ppo_tpu/utils/guards.py).

The reference's failure handling is `pdb.set_trace()` on NaN loss
(ppo.py:576-578) — useless unattended. Here a NaN in a reported metric
aborts cleanly with a NonFiniteLossError naming the step and the last saved
checkpoint, so an external supervisor can restart from save-best. Tracing
wraps torch.profiler where the JAX package wraps jax.profiler: each trace is
a Chrome trace (.json) in the profile directory, with the card's kernels
where the process has a GPU."""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Optional


class NonFiniteLossError(RuntimeError):
    pass


def check_finite(value: float, step: int, what: str = "loss",
                 checkpoint_hint: Optional[str] = None) -> float:
    """Raise NonFiniteLossError if `value` is NaN/inf; returns it else."""
    if not math.isfinite(value):
        hint = (f"; restart from the save-best checkpoint at "
                f"{checkpoint_hint}" if checkpoint_hint else "")
        raise NonFiniteLossError(
            f"non-finite {what} ({value}) at step {step}{hint}")
    return value


def _profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _export(prof, profile_dir: str, name: str) -> str:
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """A torch.profiler trace of the block when profile_dir is set, written
    to profile_dir/trace.json; a no-op else."""
    if not profile_dir:
        yield
        return
    prof = _profiler()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        _export(prof, profile_dir, "trace.json")


class TraceWindow:
    """Profile a window of steps: tick(step) after each step starts a
    torch.profiler trace at step `start` and stops it `steps` later,
    writing profile_dir/trace_steps_<start>-<stop>.json (the steps after
    `start` up to `stop`, as JAX's window). No-op when the dir is None:
    under a mesh the trainers pass it on rank 0 only. `path` is the file
    written, once it is."""

    def __init__(self, profile_dir: Optional[str], start: int = 10,
                 steps: int = 10):
        self.dir = profile_dir
        self.start = start
        self.stop_at = start + steps
        self.prof = None
        self.path = None

    def tick(self, step: int) -> None:
        if not self.dir:
            return
        if step == self.start and self.prof is None:
            self.prof = _profiler()
            self.prof.start()
        elif step >= self.stop_at and self.prof is not None:
            self.close()

    def close(self) -> None:
        if self.prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.path = _export(self.prof, self.dir,
                                f"trace_steps_{self.start}-{self.stop_at}"
                                ".json")
            self.prof = None


class StepTimer:
    """Step-time / throughput counter (replaces the dead tokens/s counter
    in reference trainer.py:167-178)."""

    def __init__(self):
        self._time = time.perf_counter
        self.reset()

    def reset(self) -> None:
        self.t0 = self._time()
        self.units = 0

    def add(self, n: int) -> None:
        self.units += n

    def rate(self) -> float:
        dt = self._time() - self.t0
        return self.units / dt if dt > 0 else 0.0
