"""Failure detection and profiling hooks (counterpart of
lr2ppo_tpu/utils/guards.py).

The reference's failure handling is `pdb.set_trace()` on NaN loss
(ppo.py:576-578) — useless unattended. Here a NaN in a reported metric
aborts cleanly with a NonFiniteLossError naming the step and the last saved
checkpoint, so an external supervisor can restart from save-best. Tracing
wraps torch.profiler where the JAX package wraps jax.profiler: each trace is
a Chrome trace (.json) in the profile directory, with the card's kernels
where the process has a GPU.

The trainers, the data path and the optimizers mark their work with
`span(name)` and count bytes with `count(name, n)`. Both act only while a
torch.profiler records in this process (--profile_dir's window, or any
profiler the operator starts): a span is then a `lr2ppo.<name>` range in
the profiler's Chrome trace, on the clock of the card's kernels and copies,
nested in the span that encloses it; `counters()` holds the counts. While
nothing records, each call costs one check of the profiler's flag.

  data.wait        the trainer waits for the loader's next batch
  data.put         host batches copied to the device (counters h2d.bytes
                   and h2d.pageable_bytes: the bytes copied, and those of
                   them from pageable host memory)
  ppo.step         stage 3, one batch: rollouts, and a sweep every
                   update_timesteps of them
  ppo.requantize   the int8 rollout twins rebuilt from the live params
  ppo.rollout      one rollout
  ppo.sweep        one update sweep over the collected memories
  ppo.update       one update (actor, then critic)
  ppo.fetch        the sweep's metrics fetched to the host
  ppo.eval         an evaluation
  ppo.save         a .state or best-model save
  pretrain.step    tower pretraining, one optimizer step's batch
  pretrain.update  its forward, backward and optimizer step
  pretrain.report  the report_steps fetch, log and best save
  pretrain.save    a .state or final model save
  optim.step       an AdamW or Adafactor step (counters
                   optim.kernel_tensors and optim.plain_tensors: the
                   tensors an AdamW step sent to its kernel, and to its
                   plain version)
  optim.allreduce  the gradients' all-reduce over dp
  attn.mla         the latent tower's attention sub-block (towers/mla.py)
  attn.kernel_fwd  the causal attention kernel's forward launch
                   (ops/mla_attention.py)
  attn.kernel_bwd  its backward launches, opened inside the autograd
                   Function's backward (on autograd's thread)
  moe.route        the router, the correction bias and the top k
                   (towers/moe.py)
  moe.dispatch     the permute to the held experts' rows and the combine
                   (counters moe.assignments: the (token, choice) pairs
                   sent to held experts, a recomputed forward not counted
                   again; moe.host_syncs: the splits' host syncs, a
                   recomputed forward's included, since it syncs again)
  moe.experts      the held experts' products, forward and backward
  moe.shared       the shared experts
  moe.bias_update  the correction biases moved after the optimizer step

A count may be a device tensor (`count(name, tensor)`): it is added on the
device with no sync, and `counters()` fetches it once, when read.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
from typing import Dict, Optional


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


# -- spans and counters --------------------------------------------------
SPAN_PREFIX = "lr2ppo."
_counts: Dict[str, int] = {}


# the span handed out while nothing records
_NO_SPAN = contextlib.nullcontext()


# torch.autograd._profiler_enabled, bound at the first check after torch
# is loaded (the data path imports this module and loads no torch)
_flag = None


def recording() -> bool:
    """Whether a torch.profiler records on this thread (where torch was
    never imported, none does)."""
    global _flag
    if _flag is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _flag = torch.autograd._profiler_enabled
    return _flag()


def span(name: str):
    """`with span(name):` marks the block as `lr2ppo.<name>` in the trace
    of the torch.profiler that records, if one does; else it is one shared
    object that does nothing."""
    if not (_flag() if _flag is not None else recording()):
        return _NO_SPAN
    return sys.modules["torch"].profiler.record_function(SPAN_PREFIX + name)


def count(name: str, n) -> None:
    """Adds n (an int, or a device tensor, added on its device) to the
    counter `name` while a torch.profiler records."""
    if recording():
        n = n.detach() if hasattr(n, "detach") else int(n)
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counts added while a profiler recorded, since this
    process started (a device count fetched here)."""
    return {k: int(v) for k, v in _counts.items()}
