"""Start N ranks of ``multiproc_worker`` joined by ``torch.distributed`` and
merge their reports.

The counterpart of the TPU package's ``scripts/run_multiproc_dryrun.py``.
The ranks meet through a ``FileStore`` in a fresh temporary directory
(no fixed port, so runs side by side do not collide), each with
``LOCAL_RANK`` set to its rank. Prints one JSON object on standard output,
``{"ok", "n_processes", "backend", "device", "wall_s", "workers": [...]}``,
and writes no file. ``ok`` holds when every rank exited 0 and reported a
finite final BA cost below its initial one; the exit code is 0 only then.
A rank that fails or hangs past ``--timeout`` ends the run: the others are
stopped and the run exits 1.

    python -m reconstructor_tpu_torch.scripts.run_multiproc_dryrun 2 --device cpu
    python -m reconstructor_tpu_torch.scripts.run_multiproc_dryrun 2 --device cuda:0  # one card, gloo
    python -m reconstructor_tpu_torch.scripts.run_multiproc_dryrun 4 --device cuda    # a card each, nccl

The backend is ``nccl`` for ``--device cuda`` (a card of its own per rank)
and ``gloo`` otherwise, unless ``--backend`` says.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(n: int, backend: str, device: str, timeout: float) -> dict:
    tmp = tempfile.mkdtemp(prefix="multiproc_")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs, outs, logs = [], [], []
    t0 = time.perf_counter()
    try:
        for rank in range(n):
            outs.append(os.path.join(tmp, f"rank{rank}.json"))
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "reconstructor_tpu_torch.scripts.multiproc_worker",
                 "--init-method", f"file://{tmp}/store", "--world-size", str(n),
                 "--rank", str(rank), "--backend", backend, "--device", device,
                 "--timeout", str(timeout), "--out", outs[rank]],
                env=dict(env, LOCAL_RANK=str(rank)), cwd=tmp, stdout=logs[rank],
                stderr=subprocess.STDOUT))
        # a rank that fails leaves the others waiting in a collective
        deadline = time.monotonic() + timeout + 60
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                break
            time.sleep(0.2)
        rcs = [p.wait() for p in procs]
        wall = time.perf_counter() - t0
        reports = []
        for rank, (rc, out, log) in enumerate(zip(rcs, outs, logs)):
            if rc == 0 and os.path.exists(out):
                with open(out) as fh:
                    reports.append(json.load(fh))
            else:
                log.seek(0)
                print(f"rank {rank} rc={rc}:\n{log.read()[-3000:]}", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    ok = (len(reports) == n and all(r.get("ok") for r in reports)
          and all(r["n_processes"] == n for r in reports))
    return {"ok": bool(ok), "n_processes": n, "backend": backend, "device": device,
            "wall_s": wall, "workers": reports}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2, help="ranks (default 2)")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (a card per rank) or cuda:i (one shared card)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the ranks may take, and a collective may wait")
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    merged = run(args.n, backend, args.device, args.timeout)
    print(json.dumps(merged), flush=True)
    return 0 if merged["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
