"""Activation recomputation with dropout (counterpart of the JAX package's
`nn.remat` of a tower layer and of the fusion trunk).

`remat(fn, *args, generator=g)` runs `fn(*args, g)` under
`torch.utils.checkpoint` (non-reentrant): the activations inside are not
kept, and the backward runs the forward again to rebuild them. A dropout site
inside draws its seed from the generator it is handed, and the recompute must
apply the masks that the forward applied. So `fn` never sees the caller's
generator: each run gets a private one that starts at the caller's state of
the moment of the call. After the forward, the caller's generator is moved to
where the private one stopped, as if `fn` had drawn from it; the recompute in
the backward draws the same seeds again and leaves the caller's generator
alone. `preserve_rng_state` covers only the global generators.

`recomputing()` is true while a backward recomputes a forward, so a count
taken in the forward is not taken again.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


_recomputing = [False]


def recomputing() -> bool:
    """Whether a backward is recomputing a forward under `remat`."""
    return _recomputing[0]


def remat(fn: Callable, *args,
          generator: Optional[torch.Generator] = None):
    """fn(*args, generator) with its activations recomputed in the
    backward; the same seeds are drawn in the forward and the recompute."""
    ran = []

    def run(*a):
        again = bool(ran)
        ran.append(True)
        _recomputing[0] = again
        try:
            if generator is None:
                return fn(*a, None)
            private = torch.Generator(device=generator.device)
            private.set_state(start)
            out = fn(*a, private)
            if not again:
                end.append(private.get_state())
            return out
        finally:
            _recomputing[0] = False

    if generator is None:
        return checkpoint(run, *args, use_reentrant=False)
    start = generator.get_state()
    end = []
    out = checkpoint(run, *args, use_reentrant=False)
    generator.set_state(end[0])
    return out
