"""Run one cell of the benchmark of ``reconstructor_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program. Set-up builds or loads the program's kernels (into the
checkout's ``build/kernels``), makes the cell's inputs on the card from
``--seed`` and warms up every shape the window uses; then the window runs
the cell's step back to back and closes at the end of the first step that
ends after ``--seconds``. With ``--trace 1`` the first steps of the window
are traced (``trace_steps`` in the cell's file; a runner may end the traced
part inside a step) and the cell's per-layer
metrics are reported instead of its end-to-end ones. After the window the
program's output of its last step is compared with the plain reference
(``benchmark/reference``), each number beside its limit.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (steps in the window), ``failed`` (steps judged wrong: the
checked one), ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``. A run that finds no card, or fewer than the cell asks for,
exits 3 and prints no result; one in whose process JAX or the JAX package
is loaded once the window has closed raises, naming them, and prints no
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("RECONSTRUCTOR_TORCH_BUILD_DIR", "build/kernels"),
                   ("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                   ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[_var] = str(ROOT / _sub)

import torch  # noqa: E402

from benchmark.spec import Bench  # noqa: E402
from benchmark.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "reconstructor_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0) -> dict:
    """One run of cell ``name``; returns the result object (no chip check)."""
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    dev = torch.device(device)
    runner = bench.kind(traffic["kind"]).Runner(cell=cell, config=config, traffic=traffic,
                                                seed=seed, device=dev)
    readers = bench.readers(name) if trace else {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runner.setup()
    _sync(dev)

    n_trace = int(cell.get("trace_steps", 1)) if trace else 0
    tracer, hooks = None, None
    steps = 0
    t_open = time.perf_counter()
    setup_s = t_open - t0
    while True:
        if steps == 0 and n_trace:
            tracer = Tracer(dev)
            hooks = runner.trace_hooks(tracer.stop)
            hooks.__enter__()
            tracer.start()
        runner.step()
        steps += 1
        if tracer is not None and steps == n_trace:
            tracer.stop()
            hooks.__exit__(None, None, None)
        if time.perf_counter() - t_open >= seconds and steps >= n_trace:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t_open
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the window's process: {', '.join(found)}")
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    metrics, device_out = {}, {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": int(cell.get("chips", 1)), "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        data = tracer.read()
        view = SimpleNamespace(cell=name, trace=data, counters=runner.counters())
        units = {m["name"]: m["unit"] for m in bench.per_layer(name)}
        for metric, reader in readers.items():
            value = reader.read(view)
            if value is not None:
                metrics[metric] = {"value": float(value), "unit": units[metric]}
        device_out["busy_s"] = data.busy_s()
        device_out["window_s"] = data.window_s
        breakdown = data.breakdown()
    else:
        e2e = dict(runner.e2e(elapsed, steps), setup_s=setup_s)
        for m in bench.end_to_end(name):
            if m["name"] not in e2e:
                raise KeyError(f"cell {name} does not measure {m['name']}")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    checks = runner.check()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded by the check: {', '.join(found)}")
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) and bool(checks)
    out = {"correct": correct, "attempted": steps, "failed": 0 if correct else 1,
           "metrics": metrics, "device": device_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    chips = int(bench.cell(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {chips} CUDA device(s); found {n}", file=sys.stderr)
        return 3
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    for n, c in out["checks"].items():
        print(f"check {n} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
