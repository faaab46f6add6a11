"""Profiling hooks: torch.profiler traces and per-stage device time.

The counterpart of ``reconstructor_tpu/utils/profiling.py``: ``trace``
captures a ``torch.profiler`` trace of the enclosed block (host activity,
plus the card's kernels, copies and fills through CUPTI when the device
is CUDA) and writes it as a Chrome trace (``trace.json`` in ``logdir``;
open it in Perfetto or chrome://tracing); ``annotate`` names a region of
that trace (``record_function``).

``stage_summary`` reads such a trace back and, for every annotated name,
sums the host windows, counts the CUDA launches made inside them, and
measures the device-busy time two ways: the union of the intervals of
kernel, memcpy and memset events on the card clipped to the name's
windows, and the union of the intervals of the device events whose
launch (the runtime or driver call with the same CUPTI correlation id)
falls inside the windows. The second does not depend on the card's
timestamps lining up with the host's, so a kernel of a few microseconds
is not lost when the two clocks drift apart by more than its length.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from reconstructor_tpu_torch.utils import device as devices

TRACE_FILE = "trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120     # kernel names are cut here (templated names run to kilobytes)


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True, device: devices.DeviceLike = None):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace.json``. ``device`` (the card unless the caller says
    otherwise) decides whether CUDA activity is recorded. Yields the
    profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if devices.resolve(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region inside a trace."""
    with torch.profiler.record_function(name):
        yield


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _covered(merged: List[Tuple[float, float]], starts: List[float], s: float,
             e: float) -> float:
    """Length of [s, e) covered by the disjoint sorted ``merged``."""
    total = 0.0
    k = max(bisect.bisect_right(starts, s) - 1, 0)
    while k < len(merged) and merged[k][0] < e:
        total += max(0.0, min(e, merged[k][1]) - max(s, merged[k][0]))
        k += 1
    return total


def stage_summary(trace_path: str, names: Iterable[str], top: int = 5) -> Dict[str, dict]:
    """Per annotated name: ``windows`` (count), ``wall_s`` (their summed
    length on the host clock), ``launches`` (CUDA launch calls made inside
    them), ``busy_s`` (device-busy seconds inside them, None when the trace
    holds no device events at all) and ``top_kernels`` (the ``top`` kernels
    by device time inside them, as [name, seconds]); ``launched_busy_s``
    and ``launched_kernels`` are the same for the device events launched
    inside them (matched by correlation id, not clipped). The key
    ``"all"`` holds the whole trace's device-busy seconds and top
    kernels."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = list(names)
    windows: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    device: List[Tuple[float, float]] = []
    kernels: List[Tuple[float, float, str]] = []
    launches: List[float] = []
    host_ts: Dict[int, float] = {}     # correlation id -> host start of its runtime call
    correlated: List[Tuple[int, float, float, str]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat"), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and ev.get("name") in names:
            windows[ev["name"]].append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            name = ev.get("name", "")[:NAME_CHARS] if cat == "kernel" else ""
            if cat == "kernel":
                kernels.append((ts, ts + dur, name))
            if corr is not None:
                correlated.append((corr, ts, ts + dur, name))
        elif cat in LAUNCH_CATS:
            if corr is not None:
                host_ts[corr] = ts
            if "Launch" in ev.get("name", ""):
                launches.append(ts)
    merged = _merge(device)
    starts = [s for s, _ in merged]
    launches.sort()
    kernels.sort()
    kstarts = [k[0] for k in kernels]

    def top_kernels(wins) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for s, e in wins:
            k = max(bisect.bisect_right(kstarts, s) - 1, 0)   # one may start before s
            while k < len(kernels) and kernels[k][0] < e:
                ks, ke, kname = kernels[k]
                if ke > s:
                    by_name[kname] += (min(e, ke) - max(s, ks)) * 1e-6
                k += 1
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def launched_inside(wins) -> Tuple[float, List[list]]:
        """Busy seconds and top kernels of the device events whose
        runtime call starts inside ``wins``."""
        wstarts = [s for s, _ in wins]
        spans, by_name = [], defaultdict(float)
        for corr, s, e, kname in correlated:
            t = host_ts.get(corr)
            if t is None:
                continue
            k = bisect.bisect_right(wstarts, t) - 1
            if k >= 0 and t < wins[k][1]:
                spans.append((s, e))
                if kname:
                    by_name[kname] += (e - s) * 1e-6
        busy = sum(e - s for s, e in _merge(spans)) * 1e-6
        return busy, [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    out: Dict[str, dict] = {}
    for name in names:
        wins = _merge(windows.get(name, []))
        busy = sum(_covered(merged, starts, s, e) for s, e in wins) * 1e-6
        n_launch = sum(bisect.bisect_left(launches, e) - bisect.bisect_left(launches, s)
                       for s, e in wins)
        launched_busy, launched_kernels = launched_inside(wins)
        out[name] = {"windows": len(windows.get(name, [])),
                     "wall_s": sum(e - s for s, e in wins) * 1e-6,
                     "launches": n_launch,
                     "busy_s": busy if merged else None,
                     "top_kernels": top_kernels(wins),
                     "launched_busy_s": launched_busy if merged else None,
                     "launched_kernels": launched_kernels}
    whole = [(merged[0][0], merged[-1][1])] if merged else []
    out["all"] = {"busy_s": sum(e - s for s, e in merged) * 1e-6 if merged else None,
                  "launches": len(launches), "top_kernels": top_kernels(whole)}
    return out


def busy_share(stage: dict) -> Optional[float]:
    """Device-busy seconds over the stage's host seconds (None if not
    measured)."""
    if stage.get("busy_s") is None or not stage.get("wall_s"):
        return None
    return stage["busy_s"] / stage["wall_s"]
