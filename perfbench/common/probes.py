"""Benchmark-side probes around the program's calls: each replaces a
module attribute of the program with a wrapper for the length of a run and
restores it after. A probe opens a `bench.<name>` range (common/trace.py)
while the run is traced, and records what the metric readers and the judge
need; while the run is not traced nor capturing it calls through.
"""

from __future__ import annotations

import importlib
import time
from contextlib import ExitStack, contextmanager
from typing import Callable, Dict, List

from perfbench.common.trace import probe


class Probes:
    """The state the wrappers share: whether a range is wanted (`tracing`),
    the calls recorded while tracing ({name: [args]}), and the host clock
    of timed calls."""

    def __init__(self):
        self.tracing = False
        self.calls: Dict[str, List] = {}
        self.host_s: Dict[str, List[float]] = {}
        self._stack = ExitStack()

    def record(self, name: str, info) -> None:
        if self.tracing:
            self.calls.setdefault(name, []).append(info)

    @contextmanager
    def range(self, name: str):
        if self.tracing:
            with probe(name):
                yield
        else:
            yield

    def timed(self, name: str, fn: Callable) -> Callable:
        """fn with its host time recorded while tracing."""
        def wrapper(*a, **k):
            if not self.tracing:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.host_s.setdefault(name, []).append(
                    time.perf_counter() - t0)
        return wrapper

    def patch(self, where, attr: str, make: Callable) -> None:
        """where.attr = make(original) until `close`; `where` is an object
        or a module's dotted name."""
        obj = (importlib.import_module(where) if isinstance(where, str)
               else where)
        original = getattr(obj, attr)
        setattr(obj, attr, make(original))
        self._stack.callback(setattr, obj, attr, original)

    def close(self) -> None:
        self._stack.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
