"""The readings that a cell's limits are set from: on each seed, the
program's numbers and the control's, each against the plain reference.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--no-control]

For every seed: the cell's set-up (inputs from the seed, warm-up), one step
of its window, then the reference; the control is the reference put in the
program's place in the precision just below the configuration's (the
matcher on float8 descriptors; bundle adjustment with TF32 products), at the
cell's own size and on the same inputs and draws. One JSON line per seed on
standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark.run  # noqa: E402,F401  (the run's build and cache directories)
import torch  # noqa: E402

from benchmark.spec import Bench  # noqa: E402


def readings(bench: Bench, name: str, seed: int, control: bool = True,
             device: str = "cuda") -> dict:
    """The program's and (with ``control``) the control's numbers on one
    seed."""
    cell = bench.cell(name)
    traffic = bench.traffic(cell["traffic"])
    runner = bench.kind(traffic["kind"]).Runner(
        cell=cell, config=bench.config(cell["config"]), traffic=traffic, seed=seed,
        device=torch.device(device))
    t = time.perf_counter()
    runner.setup()
    runner.step()
    t_step = time.perf_counter()
    prog, ctrl = runner.judge(control=control)
    return {"seed": seed, "program": prog, "control": ctrl,
            "setup_and_step_s": t_step - t, "judge_s": time.perf_counter() - t_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = Bench(ROOT)
    for s in args.seeds.split(","):
        print(json.dumps(readings(bench, args.workload, int(s), not args.no_control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
