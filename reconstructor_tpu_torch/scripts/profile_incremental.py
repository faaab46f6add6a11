"""Profile the incremental loop: where the seconds go, stage by stage.

The counterpart of the TPU package's ``scripts/profile_incremental.py``:
it detects and matches, then runs the driver's incremental loop
(``IncrementalReconstructor.reconstruct_from_state``) under cProfile and
a ``torch.profiler`` trace, with a tick around each of the driver's
stages (``choose_initial_pair``, ``triangulate_initial_pair``,
``add_next_view``, ``check_landmark_validity``, ``bundle_adjust``,
``state.remove_landmarks``, ``complete_tracks``; matching is traced as
``match_features``). The ticks wrap the reconstructor's and the state's
methods on the instances; nothing in the driver changes, and the run
registers the same views and landmarks as a run without them.

For each stage it reports wall seconds (host clock, ending in a device
synchronise), calls, CUDA launches, device-busy seconds (the union of the
card's kernel, memcpy and memset intervals inside the stage's annotation
windows, read from the trace; "not measured" on the CPU) and the stage's
top kernels by device time. It writes ``profile_incremental.txt`` (the
table, then cProfile's cumulative listing) and the trace
(``trace.json``) under ``--out``. ``--no-trace`` keeps the ticks and
cProfile and drops the trace (and with it launches and device time), so
that the profiler's own imports and costs stay out of the run.

    python -m reconstructor_tpu_torch.scripts.profile_incremental [FOLDER] \\
        [--max-views N] [--device cpu] [--out DIR] [--repeat R] [--no-trace]

Without FOLDER it renders the smoke scene (25 views of 384x512,
``eval/render.make_scene(seed=0)``). ``--max-views`` keeps the first N
views. ``--repeat`` profiles the same views R times in one process, each
with a new reconstructor and the same seed, into ``DIR/run1``, ``DIR/run2``,
...: the first run pays every first-use cost of the process (CUDA
context, library handles, kernel modules loaded at their first launch),
the later ones show the steady state. ``unprofiled`` runs the same calls
with no instrument, the yardstick a profiled run must reproduce (the smoke
script and the tests hold it to that).
"""

from __future__ import annotations

import argparse
import cProfile
import functools
import io
import json
import os
import pstats
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.utils import device as devices
from reconstructor_tpu_torch.utils import profiling

RECONSTRUCTOR_STAGES = ("choose_initial_pair", "triangulate_initial_pair", "add_next_view",
                        "check_landmark_validity", "bundle_adjust", "complete_tracks")
STATE_STAGES = ("remove_landmarks",)
STAGES = ("match_features",) + RECONSTRUCTOR_STAGES + STATE_STAGES


def smoke_scene(n_views: int = 25, h: int = 384, w: int = 512
                ) -> Tuple[dict, List[io_images.LoadedImage]]:
    """The fountain-sized rendered scene that ``chip_smoke.py`` runs
    (``eval/render.make_scene``, seed 0; focal 1.2 x the longer side so the
    default focal prior applies): (scene, its views as LoadedImages)."""
    from reconstructor_tpu_torch.eval import render
    scene = render.make_scene(seed=0, n_views=n_views, h=h, w=w, tex_size=1024,
                              n_blobs=1200, focal_px=1.2 * max(h, w))
    imgs = [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1),
                               path=f"view{i:02d}")
            for i, im in enumerate(scene["images"])]
    return scene, imgs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def unprofiled(imgs: Sequence[io_images.LoadedImage], cfg: ReconstructorConfig,
               device: devices.DeviceLike = None) -> dict:
    """The same calls with no tick, trace or cProfile: the yardstick a
    profiled run must reproduce."""
    rec = IncrementalReconstructor(cfg, verbose=False, device=device)
    state = rec.detect_features_from_images(imgs)
    rec.match_features(state)
    state = rec.reconstruct_from_state(state)
    return {"registered": len(state.registered), "landmarks": int(state.num_landmarks)}


def profile(imgs: Sequence[io_images.LoadedImage], cfg: ReconstructorConfig,
            out: str, device: devices.DeviceLike = None, trace: bool = True) -> dict:
    """Detect, match and run the incremental loop with every stage ticked,
    annotated and (with ``trace``) traced; write ``profile_incremental.txt``
    and ``trace.json`` under ``out``. Returns the report (see the module
    docstring); without ``trace`` launches, device time and kernels are
    not measured (None)."""
    dev = devices.resolve(device)
    os.makedirs(out, exist_ok=True)
    rec = IncrementalReconstructor(cfg, verbose=False, device=dev)
    t0 = time.perf_counter()
    state = rec.detect_features_from_images(imgs)
    _sync(dev)
    detect_s = time.perf_counter() - t0

    stage_t = {name: 0.0 for name in STAGES}
    calls = {name: 0 for name in STAGES}
    depth = [0]

    def tick(name, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            if depth[0]:                  # a stage inside a stage counts once
                return fn(*a, **k)
            depth[0] += 1
            s = time.perf_counter()
            try:
                with profiling.annotate(name):
                    r = fn(*a, **k)
                    _sync(dev)
            finally:
                depth[0] -= 1
            stage_t[name] += time.perf_counter() - s
            calls[name] += 1
            return r
        return wrapped

    for name in RECONSTRUCTOR_STAGES:
        setattr(rec, name, tick(name, getattr(rec, name)))
    for name in STATE_STAGES:
        setattr(state, name, tick(name, getattr(state, name)))

    prof = cProfile.Profile()
    with profiling.trace(out, enabled=trace, device=dev):
        t0 = time.perf_counter()
        tick("match_features", rec.match_features)(state)
        match_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof.enable()
        state = rec.reconstruct_from_state(state)
        _sync(dev)
        prof.disable()
        loop_s = time.perf_counter() - t0
    trace_path = os.path.join(out, profiling.TRACE_FILE) if trace else None
    unmeasured = {"launches": None, "busy_s": None, "launched_busy_s": None, "top_kernels": []}
    summary = (profiling.stage_summary(trace_path, STAGES) if trace
               else {name: unmeasured for name in STAGES + ("all",)})
    stages = {}
    for name in STAGES:
        s = summary[name]
        stages[name] = {"wall_s": stage_t[name], "calls": calls[name],
                        "launches": s["launches"], "busy_s": s["busy_s"],
                        "launched_busy_s": s["launched_busy_s"],
                        "busy_share": profiling.busy_share(s),
                        "top_kernels": s["top_kernels"]}
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "views": len(imgs), "registered": len(state.registered),
              "landmarks": int(state.num_landmarks), "detect_s": detect_s,
              "match_s": match_s, "loop_s": loop_s, "stages": stages,
              "busy_s": summary["all"]["busy_s"], "launches": summary["all"]["launches"],
              "top_kernels": summary["all"]["top_kernels"], "trace": trace_path}
    with open(os.path.join(out, "profile_incremental.txt"), "w") as f:
        f.write(format_report(report))
        pstats.Stats(prof, stream=f).sort_stats("cumulative").print_stats(60)
    return report


def format_report(report: dict) -> str:
    buf = io.StringIO()
    buf.write(f"device: {report['device']}  views: {report['views']}  registered: "
              f"{report['registered']}  landmarks: {report['landmarks']}\n")
    buf.write(f"detect {report['detect_s']:.3f}s  match {report['match_s']:.3f}s  "
              f"incremental loop {report['loop_s']:.3f}s\n")
    buf.write(f"{'stage':26s} {'wall s':>9s} {'calls':>6s} {'launches':>9s} "
              f"{'busy s':>9s} {'busy':>7s}\n")
    for name, s in sorted(report["stages"].items(), key=lambda kv: -kv[1]["wall_s"]):
        busy = "not measured" if s["busy_s"] is None else f"{s['busy_s']:9.4f}"
        share = "" if s["busy_share"] is None else f"{100 * s['busy_share']:6.2f}%"
        launches = "-" if s["launches"] is None else str(s["launches"])
        buf.write(f"{name:26s} {s['wall_s']:9.4f} {s['calls']:6d} {launches:>9s} "
                  f"{busy:>9s} {share:>7s}\n")
    buf.write("top kernels by device time: " + json.dumps(report["top_kernels"]) + "\n")
    for name, s in report["stages"].items():
        if s["top_kernels"]:
            buf.write(f"  {name}: " + json.dumps(s["top_kernels"]) + "\n")
    return buf.getvalue()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("folder", nargs="?", default=None,
                    help="image folder (default: the rendered smoke scene)")
    ap.add_argument("--max-views", type=int, default=None, help="keep the first N views")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join("build", "profile_incremental"),
                    help="directory for profile_incremental.txt and trace.json")
    ap.add_argument("--repeat", type=int, default=1,
                    help="profile the views this many times in one process")
    ap.add_argument("--no-trace", dest="trace", action="store_false",
                    help="ticks and cProfile only: no torch.profiler trace (and so no "
                         "launch counts or device time)")
    args = ap.parse_args(argv)
    cfg = ReconstructorConfig()
    imgs = (io_images.load_folder(args.folder, cfg.img_max_size) if args.folder
            else smoke_scene()[1])
    imgs = imgs[:args.max_views] if args.max_views else imgs
    for k in range(args.repeat):
        out = args.out if args.repeat == 1 else os.path.join(args.out, f"run{k + 1}")
        report = profile(imgs, cfg, out, device=args.device, trace=args.trace)
        print(f"run {k + 1} of {args.repeat}\n" + format_report(report), flush=True)
    return report


if __name__ == "__main__":
    main()
