"""The program's own spans in a traced window, for the per-layer metrics
that read them.

The port names the layers of its hot path with ``record_function`` ranges
(``utils/profiling.annotate``: ``match.*`` in matching, ``ba.*`` in the BA
solvers). They are ``user_annotation`` events of the same session as the
card's events, so they share the device trace's clock. A span still open
when a runner stops the session inside a step (the BA cells stop inside
the next LM iteration) is exported cut at the stop, after the window's end:
``count`` leaves it out.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.trace import TraceData

SPAN_CAT = "user_annotation"


def intervals(trace: TraceData, name: str) -> List[Tuple[float, float]]:
    """(start, end) of every span named ``name``, in microseconds, sorted."""
    return sorted((s, e) for s, e, n, c in trace.host if c == SPAN_CAT and n == name)


def count(trace: TraceData, name: str) -> int:
    """Spans named ``name`` that ended inside the window."""
    return sum(1 for _, e in intervals(trace, name) if e <= trace.window[1])


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_s(trace: TraceData, name: str) -> Optional[float]:
    """Seconds in which the card was idle while a span named ``name`` was
    open: the idle gaps intersected with the union of its intervals. None
    where the trace holds no such span or no device event (idle is then not
    measured)."""
    spans = _union(intervals(trace, name))
    if not spans or not trace.device:
        return None
    gaps = trace.idle_gaps()
    total, k = 0.0, 0
    for s, e in spans:
        while k < len(gaps) and gaps[k][1] <= s:
            k += 1
        j = k
        while j < len(gaps) and gaps[j][0] < e:
            total += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return total * 1e-6
