"""Seeded weights, made on the device in a few large calls, for the program
to load and the reference to start from.

The rules follow the published models' initialisers as the program applies
them: a linear layer's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(torch's default), a layer norm's scale 1 and shift 0, an embedding table
N(0, 1). Which parameter is which is read from the module that holds it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _rules(model: nn.Module) -> Dict[str, tuple]:
    """name -> ("uniform", bound) | ("one",) | ("zero",) | ("normal",) for
    every parameter of `model`."""
    out: Dict[str, tuple] = {}
    for mname, m in model.named_modules():
        direct = dict(m.named_parameters(recurse=False))
        if not direct:
            continue
        kind = type(m).__name__
        pre = mname + "." if mname else ""
        if isinstance(m, nn.Embedding):
            out[pre + "weight"] = ("normal",)
        elif hasattr(m, "in_features"):
            bound = 1.0 / math.sqrt(m.in_features)
            for k in direct:
                out[pre + k] = ("uniform", bound)
        elif "LayerNorm" in kind:
            for k in direct:
                out[pre + k] = (("one",) if k in ("weight", "gamma")
                                else ("zero",))
        else:
            raise ValueError(f"no initialiser for {kind} {mname!r}")
    return out


@torch.no_grad()
def seeded(models: Dict[str, nn.Module], seed: int, device
           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model name: {parameter name: float32 tensor}} for meta-device
    `models`, from one CUDA (or CPU) generator seeded `seed`: one uniform
    and one normal draw for all of them, taken in the models' order."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    plan = []
    n_uni = n_norm = 0
    for mname, model in models.items():
        rules = _rules(model)
        for k, p in model.named_parameters():
            rule = rules[k]
            plan.append((mname, k, tuple(p.shape), rule))
            if rule[0] == "uniform":
                n_uni += p.numel()
            elif rule[0] == "normal":
                n_norm += p.numel()
    uni = torch.empty(n_uni, device=device).uniform_(-1.0, 1.0,
                                                     generator=gen)
    norm = torch.empty(n_norm, device=device).normal_(0.0, 1.0,
                                                      generator=gen)
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in models}
    iu = inn = 0
    for mname, k, shape, rule in plan:
        n = math.prod(shape)
        if rule[0] == "uniform":
            t = uni[iu:iu + n].view(shape).mul_(rule[1])
            iu += n
        elif rule[0] == "normal":
            t = norm[inn:inn + n].view(shape)
            inn += n
        elif rule[0] == "one":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[mname][k] = t
    return out
