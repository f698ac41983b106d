"""The benchmark's own host spans, around its calls into each layer.

A span is (name, start, end) on ``time.perf_counter``.  In a traced run each
span is also a ``torch.profiler.record_function`` range named
``bench:<name>``, so the device trace can say what the host was doing in
each idle gap.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Tuple


class Spans:
    def __init__(self, sync: Optional[Callable[[], None]] = None,
                 clock=time.perf_counter):
        self.items: List[Tuple[str, float, float]] = []
        self.sync = sync
        self.clock = clock
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False, keep: bool = True):
        """Time the block; ``sync`` waits for the device before the span
        ends; ``keep=False`` records the range in the trace only."""
        if self.tracing:
            from torch.profiler import record_function
            rf = record_function(f"bench:{name}")
        else:
            rf = contextlib.nullcontext()
        t0 = self.clock()
        with rf:
            yield
            if sync and self.sync is not None:
                self.sync()
        if keep:
            self.items.append((name, t0, self.clock()))

    def last(self, name: str) -> Optional[float]:
        for n, t0, t1 in reversed(self.items):
            if n == name:
                return t1 - t0
        return None
