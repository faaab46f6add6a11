"""One ``torch.profiler`` session over the traced part of a window, and what
the per-layer metrics read from it.

The session records host operations and, on a card, the kernels, copies
and fills through CUPTI. Its Chrome trace is written to a temporary file,
read back once into plain lists and deleted. ``TraceData`` holds:

- ``window``: the host interval of the traced steps (the ``bench.window``
  annotation), in microseconds;
- ``device``: every kernel, copy and fill on the card that overlaps the
  window, as (start, end, name, category), clipped to the window;
- ``host``: host operations and the benchmark's annotations, as (start,
  end, name, category), from which each idle gap of the card gets the name
  of what the host was doing.

``patched`` swaps attributes of the program's modules for the traced steps
only (annotations and counters around calls into a layer), and puts them
back.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 96


class TraceData(NamedTuple):
    window: Tuple[float, float]
    device: List[Tuple[float, float, str, str]]
    host: List[Tuple[float, float, str, str]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self, pred: Callable[[str], bool] = lambda name: True):
        return [d for d in self.device if d[3] == "kernel" and pred(d[2])]

    def kernel_s(self, pred: Callable[[str], bool] = lambda name: True) -> float:
        return sum(e - s for s, e, _, _ in self.kernels(pred)) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s, e, _, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, summed by what the host was doing (the innermost annotation
        and the innermost host operation at the gap's middle)."""
        ops: Dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.device:
            ops[name] += (e - s) * 1e-6
        gaps = self.idle_gaps()
        labels = _host_labels(self.host, [(s + e) / 2 for s, e in gaps])
        idle: Dict[str, float] = defaultdict(float)
        for (s, e), label in zip(gaps, labels):
            idle[label] += (e - s) * 1e-6
        return {"device_ops": [[n, v] for n, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def _host_labels(host, times: List[float]) -> List[str]:
    """For each time, '<annotation> > <host op>' of the innermost ones
    running then ('python' where no host operation ran)."""
    events = sorted(host)
    order = sorted(range(len(times)), key=lambda k: times[k])
    out = [""] * len(times)
    live: List[Tuple[float, float, float, str, str]] = []   # (dur, end, start, name, cat)
    k = 0
    for idx in order:
        t = times[idx]
        while k < len(events) and events[k][0] <= t:
            s, e, name, cat = events[k]
            heapq.heappush(live, (e - s, e, s, name, cat))
            k += 1
        live = [x for x in live if x[1] >= t]
        heapq.heapify(live)
        ann = next((x[3] for x in sorted(live) if x[4] == "user_annotation"
                    and x[3] != WINDOW), "")
        op = next((x[3] for x in sorted(live) if x[4] == "cpu_op"), "python")
        out[idx] = f"{ann} > {op}" if ann else op
    return out


def read_chrome_trace(path: str) -> TraceData:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window: Optional[Tuple[float, float]] = None
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        name = str(ev.get("name", ""))
        if cat == "user_annotation" and name == WINDOW:
            window = (ts, ts + dur)
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name[:NAME_CHARS], cat))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name[:NAME_CHARS], cat))
    if window is None:
        raise RuntimeError(f"the trace holds no '{WINDOW}' annotation")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in device if e > w0 and s < w1]
    host = [h for h in host if h[1] > w0 and h[0] < w1]
    return TraceData(window=window, device=device, host=host)


class Tracer:
    """Start before the first traced step and stop after the last (or, from
    inside a step, where the cell's runner ends its traced part: a second
    stop does nothing); ``read`` then returns what the session recorded."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._dev = device
        self._prof = profile(activities=acts)
        self._rf = None
        self.running = False

    def start(self) -> None:
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        self.running = True

    def stop(self) -> None:
        if not self.running:
            return
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.running = False

    def read(self) -> TraceData:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return read_chrome_trace(path)
        finally:
            os.remove(path)


@contextlib.contextmanager
def patched(targets: Iterable[Tuple[object, str, Callable]]):
    """Replace ``module.attr`` with ``wrap(original)`` for each (module,
    attr, wrap) whose attribute exists; restore all on exit."""
    saved = []
    try:
        for mod, attr, wrap in targets:
            orig = getattr(mod, attr, None)
            if orig is None:
                continue
            saved.append((mod, attr, orig))
            setattr(mod, attr, wrap(orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def annotated(name: str) -> Callable:
    """A wrapper factory that names each call's span ``name`` in the trace."""
    def wrap(fn):
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner
    return wrap
