"""The program's own spans and counters in a traced window: the window's
idle time split by the span its fit thread was in, and the host-to-device
bytes a batch.

While a torch.profiler records, lr2ppo_torch marks its work with
`lr2ppo.<name>` ranges (lr2ppo_torch/utils/guards.py: span), which land in
the profiler's Chrome trace on the same clock as the kernels. Each
microsecond of the window in which no kernel runs goes to the innermost
span open at that instant on the fit's thread (the thread of the
`*.step` spans), and so to its group:

  data      data.*  (the wait for a batch, the copies to the device)
  compute   ppo.rollout, ppo.update, pretrain.update, optim.*  (launches,
            and syncs hidden in a compute call)
  trainer   every other span: the trainer's own code (ppo.step,
            ppo.sweep and pretrain.step outside their children,
            ppo.requantize, ppo.fetch, reports, evals, saves)
  unspanned no span open on the fit thread

Spans on other threads (the loader's workers, autograd's) never take a
gap. The window is the host clock's `wall_s`, ending at the trace's last
device operation or CUDA call, so the four parts add up to the share of
the window with no kernel running, as `device.idle_share.*` counts it.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Optional, Tuple

PREFIX = "lr2ppo."
GROUPS = ("data", "compute", "trainer", "unspanned")
COMPUTE = ("ppo.rollout", "ppo.update", "pretrain.update")

Span = Tuple[float, float, str]           # (start us, end us, name)


def group(name: Optional[str]) -> str:
    if name is None:
        return "unspanned"
    if name.startswith("data."):
        return "data"
    if name in COMPUTE or name.startswith("optim."):
        return "compute"
    return "trainer"


def load_spans(path: str) -> Dict[object, List[Span]]:
    """{thread id: [(start, end, name)]} of the trace's `lr2ppo.` ranges,
    the prefix dropped, in start order."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out: Dict[object, List[Span]] = {}
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and name.startswith(PREFIX)):
            start = float(e["ts"])
            out.setdefault(e.get("tid"), []).append(
                (start, start + float(e.get("dur", 0.0)),
                 name[len(PREFIX):]))
    for spans in out.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
    return out


def fit_thread(spans: Dict[object, List[Span]]) -> Optional[object]:
    """The thread that holds most `*.step` spans."""
    n = Counter({t: sum(s[2].endswith(".step") for s in ss)
                 for t, ss in spans.items()})
    best = n.most_common(1)
    return best[0][0] if best and best[0][1] else None


def innermost(spans: List[Span], lo: float, hi: float
              ) -> List[Tuple[float, float, Optional[str]]]:
    """[lo, hi) cut at the spans' ends into pieces, each with the innermost
    span open over it (None: none); the spans of one thread nest."""
    cuts = sorted({lo, hi} | {t for s in spans for t in s[:2]
                              if lo < t < hi})
    out, stack, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][0] <= a:
            stack.append(spans[i])
            i += 1
        stack = [s for s in stack if s[1] > a]
        if stack:
            # the open span that started last is inside the others
            inner = max(stack, key=lambda s: (s[0], -s[1]))[2]
        else:
            inner = None
        out.append((a, b, inner))
    return out


def idle_pieces(ops: List[tuple], lo: float, hi: float
                ) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) in which no kernel runs (`ops` as Trace.ops:
    name, start, end, category, launch)."""
    out, reach = [], lo
    for _n, start, end, cat, _l in sorted(ops, key=lambda o: o[1]):
        if cat != "kernel" or end <= reach:
            continue
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def idle_split(ops: List[tuple], spans: Dict[object, List[Span]],
               end_us: float, wall_s: float) -> Optional[dict]:
    """The window [end_us - wall_s, end_us)'s idle time: {"groups": {group:
    % of the window}, "by_span": {innermost span: idle ms}, "idle_pct":
    their sum}; None where the trace holds no kernel or no fit thread."""
    tid = fit_thread(spans)
    if tid is None or not wall_s or not any(o[3] == "kernel" for o in ops):
        return None
    hi = end_us
    lo = hi - wall_s * 1e6
    pieces = innermost(spans[tid], lo, hi)
    groups = dict.fromkeys(GROUPS, 0.0)
    by_span: Dict[str, float] = {}
    j = 0
    for a, b in idle_pieces(ops, lo, hi):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            us = min(b, e) - max(a, s)
            if us > 0:
                groups[group(name)] += us
                key = name or "(none)"
                by_span[key] = by_span.get(key, 0.0) + us
            k += 1
    window = wall_s * 1e6
    pct = {g: 100.0 * us / window for g, us in groups.items()}
    return {"groups": pct, "idle_pct": sum(pct.values()),
            "by_span": {k: v / 1e3 for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])}}


def trace_end(path: str) -> float:
    """The end of the trace's last device operation or CUDA call, us."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ends = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime",
                "cuda_driver")]
    return max(ends) if ends else 0.0


def per_batch_mb(obs: List[dict], name: str) -> Optional[float]:
    """MB of the program's counter `name` (lr2ppo_torch.utils.counters) per
    batch of the traced window, a batch a rollout; None where this process
    holds no such counts (a program without them, or ranks in processes of
    their own). The program counts only while a profiler records, and a
    run traces once: the counts are the window's."""
    try:
        from lr2ppo_torch.utils import counters
    except ImportError:
        return None
    got = counters()
    if "h2d.bytes" not in got or len(obs) != 1 or not obs[0].get("rollouts"):
        return None
    return got.get(name, 0) / obs[0]["rollouts"] / 1e6
