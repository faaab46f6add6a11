"""Stage timing — the reference's TimeLogger (TimeLogger.h:7-38) equivalent.

Same start/end bracketing and end-of-run millisecond table, with the same
stage names as the reference's reconstruct() so numbers are directly
comparable, plus nesting support and a context-manager API. ``event``
also names its block in a ``torch.profiler`` trace (``utils.profiling``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

from reconstructor_tpu_torch.utils import profiling


class TimeLogger:
    def __init__(self):
        self.events: List[Tuple[str, float]] = []
        self._stack: List[Tuple[str, float]] = []

    def start_event(self, name: str) -> None:
        self._stack.append((name, time.perf_counter()))

    def end_event(self) -> None:
        name, t0 = self._stack.pop()
        self.events.append((name, (time.perf_counter() - t0) * 1000.0))

    @contextlib.contextmanager
    def event(self, name: str):
        self.start_event(name)
        try:
            with profiling.annotate(name):
                yield
        finally:
            self.end_event()

    def totals(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for name, ms in self.events:
            agg[name] = agg.get(name, 0.0) + ms
        return agg

    def print_timings(self) -> None:
        print("eventName | eventDuration, ms")
        for name, ms in self.totals().items():
            print(f"{name} | {ms:.1f}")
