"""The comparison that decides `correct`: numbers that the judge computes
from the program's and the reference's readings, each held to its limit."""

from __future__ import annotations

from typing import Dict, List


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               median: float) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or `median` (the median
    leaf's), whichever is larger."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k, float("nan"))
        gap = abs(p - r) / max(abs(r), median, 1e-30)
        if not gap <= worst:       # a NaN counts as the worst
            worst = gap if gap == gap else float("inf")
    return worst


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 median: float, n: int = 3) -> List[list]:
    """The n worst leaves of worst_leaf: [name, gap, program's norm,
    reference's norm]."""
    rows = [[k, abs(prog.get(k, float("nan")) - r)
             / max(abs(r), median, 1e-30), prog.get(k), r]
            for k, r in ref.items()]
    rows.sort(key=lambda x: -x[1] if x[1] == x[1] else float("-inf"))
    return rows[:n]


def report(detail: dict) -> None:
    """The judge's readings that are not compared, and the worst leaves,
    on standard error (before the compared numbers)."""
    import json
    import sys

    keep = {k: v for k, v in detail.items()
            if k.endswith("_gap") or k.startswith("worst.")}
    print("readings: " + json.dumps(keep, default=float), file=sys.stderr)


def against(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> List[dict]:
    """Each number beside its limit; a number without a limit fails."""
    out = []
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value == value and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out
