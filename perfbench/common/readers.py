"""Arithmetic the metric readers share. Each reader takes the ranks'
observations (the entries' `observe`) and returns its number, or None where
its cell gave it nothing to read."""

from __future__ import annotations

from typing import List, Optional

from perfbench.common import chipmath


def per_occurrence_ms(obs: List[dict], rng: str, per: str) -> Optional[float]:
    """Device ms of the kernels inside the range `rng`, per `per` (a count
    in the observations), the largest over the ranks."""
    vals = []
    for o in obs:
        us = o["range_us"].get(rng)
        if not us or not o.get(per):
            return None
        vals.append(sum(us) / 1e3 / o[per])
    return max(vals)


def roofline_pct(obs: List[dict], rng: str, bound_ms) -> Optional[float]:
    """100 x the sum of the bounds over the sum of the device time of the
    calls recorded under `rng` (over all ranks) for which bound_ms(call)
    gives a bound; None where none does."""
    bound = spent = 0.0
    for o in obs:
        calls = o["calls"].get(rng, [])
        times = o["range_us"].get(rng, [])
        if len(calls) != len(times):
            raise ValueError(f"{rng}: {len(calls)} calls, {len(times)} "
                             "ranges traced")
        for call, us in zip(calls, times):
            b = bound_ms(call)
            if b is not None and us > 0:
                bound += b
                spent += us / 1e3
    return 100.0 * bound / spent if spent else None


def mfu_pct(obs: List[dict]) -> Optional[float]:
    """100 x the model FLOPs of the traced steps over the window's length
    times the dense peak, summed over the chips."""
    flops = sum(o["model_flops"] for o in obs)
    wall = max(o["wall_s"] for o in obs)
    peak = sum(o["peak_flops"] for o in obs)
    if not flops or not wall:
        return None
    return 100.0 * flops / (wall * peak)


def idle_pct(obs: List[dict]) -> Optional[float]:
    """100 x the share of the traced window in which no kernel ran,
    averaged over the chips."""
    vals = [1.0 - o["kernel_busy_s"] / o["wall_s"] for o in obs
            if o["wall_s"]]
    return 100.0 * sum(vals) / len(vals) if vals else None


def hbm_bound_ms(nbytes: float) -> float:
    return chipmath.bound(nbytes, 0.0, 1.0)["bound_ms"]
