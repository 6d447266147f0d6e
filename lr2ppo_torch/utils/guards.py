"""Failure detection (counterpart of check_finite in
lr2ppo_tpu/utils/guards.py).

The reference's failure handling is `pdb.set_trace()` on NaN loss
(ppo.py:576-578) — useless unattended. Here a NaN in a reported metric
aborts cleanly with a NonFiniteLossError naming the step and the last saved
checkpoint, so an external supervisor can restart from save-best."""

from __future__ import annotations

import math
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
