"""Traffic kind ``ba_distributed``: one bundle-adjustment problem solved again
and again from the same start by the port's multi-rank global BA
(``ba.distributed.solve_distributed``), over ``ranks`` processes with a card
each, joined by ``backend`` (NCCL on the cards, gloo on the CPU).

The problem, its settings and the reference are ``ba_solves``' (loaded from
its file by path): ``make_problem`` at the traffic's counts from its
``problem_seed``, the engine's global-BA settings, and the float64
reference, here ``reference/ba_blocks.py`` over the cell's cards, since the
float64 blocks of a problem this size do not fit one card.

Processes. The harness's own process is rank 0 on the first card. Its
``setup`` starts ranks 1.. as runs of this file (``LOCAL_RANK`` set, which
picks each rank's card), which meet it through a ``file://`` rendezvous
under the checkout's ``build/``. Every rank builds the same problem from the
seed on its own card (rank 0 checks that every rank holds the same bits)
and warms up with the same LM iterations. Then rank 0 broadcasts an order
before each solve: 1, and every rank runs one ``solve_distributed``; 0, and
the workers leave. So every rank makes the same collective calls in the
same order. Under NCCL the reduction order is pinned (``NCCL_ALGO=Ring``,
``NCCL_PROTO=Simple`` for every rank, set before the group is made): the
sums, and with them the LM iteration count, are the same in every run.

Only rank 0 is traced; the traced part ends inside a solve at the hook that
opens the LM iteration after ``trace_lm_iterations``, on rank 0 alone, and
the solve goes on untraced. A worker that dies ends the run: under gloo the
next collective raises; under NCCL, where a collective would wait for the
group's timeout, rank 0 exits non-zero as soon as it sees the worker gone. A
worker whose rank 0 is gone exits too.

    python3 benchmark/traffic/ba_distributed.py <job.json> <rank>

is a worker; only rank 0's ``setup`` starts it.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__" and str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark.reference import ba_blocks, precision as ref_precision  # noqa: E402
from benchmark.spec import _load_module  # noqa: E402
from benchmark.trace import annotated, patched  # noqa: E402

ba_solves = _load_module(Path(__file__).with_name("ba_solves.py"), "bench_traffic_ba_solves")
ref_ba = ba_solves.ref_ba

# where ranks meet and workers leave their peak memory (listed in .gitignore)
RENDEZVOUS = ROOT / "build" / "bench_rendezvous"
REFERENCE_CACHE = ROOT / "build" / "bench_reference"
# one reduction order for every sum: NCCL's ring with the simple protocol
NCCL_ENV = {"NCCL_ALGO": "Ring", "NCCL_PROTO": "Simple"}
SOLVE, STOP = 1, 0
# seconds rank 0 waits for a worker to leave: the group's own timeout
# (``parallel.mesh.DEFAULT_TIMEOUT_S``, which bounds the rendezvous and
# every collective)
LEAVE_TIMEOUT_S = 300.0


def _backend(traffic: dict, device: torch.device) -> str:
    return str(traffic.get("backend", "nccl")) if device.type == "cuda" else "gloo"


def _fingerprint(p: dict) -> torch.Tensor:
    """Two float64 sums of each padded array: equal on every rank when the
    ranks built the same problem."""
    out = []
    for k in ("cam_params", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask", "cam_free"):
        x = p[k].double().reshape(-1)
        w = torch.arange(x.numel(), device=x.device, dtype=torch.float64) / max(x.numel(), 1)
        out += [x.sum(), (x * w).sum()]
    return torch.stack(out)


class _Solver:
    """One rank's problem and its ``solve_distributed`` calls."""

    def __init__(self, config: dict, traffic: dict, mesh, keep_live: bool):
        from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
        from reconstructor_tpu_torch.config import ReconstructorConfig
        from reconstructor_tpu_torch.parallel import mesh as mesh_mod

        self.mesh = mesh
        self.cfg = ReconstructorConfig(**config["reconstructor"])
        p = ba_solves.make_problem(config["scene"], traffic, int(traffic["problem_seed"]),
                                   mesh.device)
        self.live = p.pop("live") if keep_live else None
        p.pop("live", None)
        same = mesh_mod.all_gather(mesh, _fingerprint(p)[None])
        if not bool((same == same[0]).all()):
            raise RuntimeError("the ranks built different problems from one seed")
        self.n_cams = int(traffic["cameras"])
        prob = ba_lm.BAProblem(**p)
        st = ba_solves.settings(self.cfg, self.n_cams)
        common = dict(max_iters=st.max_iters, init_lambda=st.init_lambda,
                      lambda_up=st.lambda_up, lambda_down=st.lambda_down, ftol=st.ftol,
                      focal_upper_bound=st.focal_upper_bound, huber_delta=st.huber_delta,
                      damping=self.cfg.ba_damping)

        def solve(**kw):
            return distributed.solve_distributed(mesh, prob, **{**common, **kw})
        self.solve = solve
        solve(max_iters=int(traffic.get("warmup_lm_iterations", 2)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _order(mesh, flag=None) -> int:
    """Rank 0 broadcasts ``flag``; every rank returns it."""
    t = torch.tensor([-1 if flag is None else flag], dtype=torch.int32, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)
    return int(t.item())


def reference_solve(live, st, devices) -> ref_ba.Result:
    """The float64 solve of ``live`` over ``devices`` (``reference/ba_blocks.py``),
    kept under ``REFERENCE_CACHE`` by a hash of the problem, the settings, the
    references' code, the torch version, the card and the number of devices:
    the same problem is solved once in a checkout."""
    h = hashlib.sha256()
    for x in live:
        h.update(str(tuple(x.shape)).encode() + str(x.dtype).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr(tuple(st)).encode())
    for mod in (ref_ba, ba_blocks, ref_precision):
        h.update(Path(mod.__file__).read_bytes())
    dev = live.cams.device
    h.update(torch.__version__.encode())
    h.update((torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type).encode())
    h.update(str(len(devices)).encode())
    path = REFERENCE_CACHE / f"ba_blocks_{h.hexdigest()[:24]}.pt"
    if path.is_file():
        r = torch.load(path, map_location=dev)
        return ref_ba.Result(cams=r["cams"], pts=r["pts"], cost=r["cost"],
                             iterations=r["iterations"])
    ref = ba_blocks.solve(live, st, devices, precision="float64")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    torch.save({"cams": ref.cams.cpu(), "pts": ref.pts.cpu(), "cost": float(ref.cost),
                "iterations": int(ref.iterations)}, tmp)
    os.replace(tmp, path)
    return ref


class Runner:
    """Rank 0 of the cell's world: starts the workers, orders the solves,
    stops the workers and judges its last solve."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        # the problem comes from the traffic's problem_seed: the run's seed
        # changes nothing here
        self.cell, self.config, self.traffic = cell, config, traffic
        self.world = int(traffic.get("ranks", cell.get("chips", 1)))
        self.backend = _backend(traffic, device)
        self.dev = torch.device("cuda", 0) if device.type == "cuda" else device
        self.iterations = []                 # LM iterations of every window solve
        self._traced = {"iterations": 0, "bytes0": None, "bytes": None}
        self._tracing = False
        self.result = None
        self.solver = None
        self.mesh = None
        self.procs = []
        self._run = None                     # this run's rendezvous directory
        self._live_procs = False

    # -- the world ---------------------------------------------------------

    def _start_workers(self) -> Path:
        RENDEZVOUS.mkdir(parents=True, exist_ok=True)
        run = RENDEZVOUS / f"{os.getpid()}-{time.time_ns()}"
        run.mkdir()
        job = run / "job.json"
        job.write_text(json.dumps({
            "config": self.config, "traffic": self.traffic, "world": self.world,
            "backend": self.backend, "device": self.dev.type, "store": str(run / "store"),
            "parent": os.getpid(), "out": str(run)}))
        import reconstructor_tpu_torch
        paths = [str(ROOT), str(Path(reconstructor_tpu_torch.__file__).resolve().parents[1])]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            paths + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        if self.dev.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        self.procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                        str(job), str(r)], env=dict(env, LOCAL_RANK=str(r)),
                                       cwd=str(ROOT), stdout=subprocess.DEVNULL)
                      for r in range(1, self.world)]
        self._live_procs = True
        atexit.register(self.close)
        threading.Thread(target=self._watch, daemon=True).start()
        return run

    def _watch(self) -> None:
        """Under NCCL a collective with a dead peer waits for the group's
        timeout: leave at once instead."""
        while self._live_procs:
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is not None and self._live_procs:
                    print(f"ba_distributed: rank {r} ended with exit code {code} during the "
                          f"run", file=sys.stderr, flush=True)
                    if self.backend == "nccl":
                        os._exit(1)
                    return
            time.sleep(0.5)

    def close(self) -> None:
        """Stop what is left of the world: kill live workers, leave the group."""
        self._live_procs = False
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        if self._run is not None:
            shutil.rmtree(self._run, ignore_errors=True)

    def setup(self) -> None:
        from reconstructor_tpu_torch.parallel import mesh as mesh_mod
        if self.backend == "nccl":
            os.environ.update(NCCL_ENV)
        self._run = self._start_workers()
        self.mesh = mesh_mod.initialize_multihost(
            "file://" + str(self._run / "store"), self.world, 0, backend=self.backend,
            device=self.dev)
        self.dev = self.mesh.device
        self.solver = _Solver(self.config, self.traffic, self.mesh, keep_live=True)

    def step(self) -> None:
        _order(self.mesh, SOLVE)
        res = self.solver.solve()
        self.result = (res.cam_params.cpu(), res.points.cpu(), float(res.cost_final))
        self.iterations.append(int(res.iterations))

    def e2e(self, elapsed: float, steps: int) -> dict:
        return {"ba_solve_s": elapsed / steps}

    def _finish(self) -> None:
        """Order the workers to leave, wait for them, read their peaks."""
        if self.mesh is None:
            return
        self._live_procs = False
        _order(self.mesh, STOP)
        for r, p in enumerate(self.procs, start=1):
            try:
                code = p.wait(timeout=LEAVE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self.close()
                raise RuntimeError(f"rank {r} did not leave cleanly (exit code {code})")
        peaks = {0: int(torch.cuda.max_memory_allocated(self.dev))
                 if self.dev.type == "cuda" else 0}
        for r in range(1, self.world):
            f = self._run / f"rank{r}.json"
            if f.is_file():
                peaks[r] = json.loads(f.read_text())["peak_bytes"]
        for r, b in sorted(peaks.items()):
            print(f"rank {r} memory peak {b} bytes", file=sys.stderr)
        self.close()
        self.mesh = None

    # -- the traced solve -------------------------------------------------

    def trace_hooks(self, stop):
        """Counts the traced LM iterations at the program's blocks and ends
        the traced part at the hook that opens the LM iteration after
        ``trace_lm_iterations``; keeps the bytes this rank all-reduced in the
        traced part (``parallel.mesh``'s counter, where the program has it)."""
        from reconstructor_tpu_torch.ba import distributed
        from reconstructor_tpu_torch.parallel import mesh as mesh_mod
        traced, runner = self._traced, self
        budget = int(self.cell.get("trace_lm_iterations", 1 << 30))

        def reduced_bytes():
            return mesh_mod.counts().get("all_reduce_bytes")

        def end():
            if runner._tracing:
                b0, b1 = traced["bytes0"], reduced_bytes()
                traced["bytes"] = None if b0 is None or b1 is None else b1 - b0
                stop()
                runner._tracing = False

        def blocks(fn):
            spanned = annotated("build_pcg_blocks")(fn)

            def inner(*a, **k):
                if runner._tracing and traced["iterations"] == budget:
                    end()
                if not runner._tracing:
                    return fn(*a, **k)
                traced["iterations"] += 1
                return spanned(*a, **k)
            return inner

        @contextlib.contextmanager
        def hooks():
            with patched([(distributed, "_build_pcg_blocks", blocks)]):
                traced["bytes0"] = reduced_bytes()
                runner._tracing = True
                try:
                    yield
                finally:
                    end()
        return hooks()

    def counters(self) -> dict:
        return {"route": "distributed", "ranks": self.world, "iterations": list(self.iterations),
                "traced_iterations": self._traced["iterations"],
                "allreduce_bytes": self._traced["bytes"]}

    # -- the check -----------------------------------------------------------

    def check(self) -> list:
        """Rank 0's last solve against the reference's solve from the same
        start, each number beside the cell's limit."""
        got, _ = self.judge()
        return [(name, got[name], float(lim)) for name, lim in self.cell["limits"].items()]

    def judge(self, control: bool = False):
        """(the program's numbers, the control's or None), as ``ba_solves``
        judges, with the reference over the cell's cards once the workers
        have left."""
        self._finish()
        cams, pts, reported = self.result
        live = self.solver.live
        self.solver = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            devices = [torch.device("cuda", k) for k in range(self.world)]
        else:
            devices = [self.dev] * self.world
        C, L = live.cams.shape[0], live.pts.shape[0]
        n_cams = int(self.traffic["cameras"])
        from reconstructor_tpu_torch.config import ReconstructorConfig
        cfg = ReconstructorConfig(**self.config["reconstructor"])
        st = ba_solves.settings(cfg, n_cams, **self.config.get("reference_settings", {}))
        t = time.perf_counter()
        ref = reference_solve(live, st, devices)
        print(f"reference solve {time.perf_counter() - t:.1f} s ({ref.iterations} LM "
              f"iterations)", file=sys.stderr)
        prog = ref_ba.compare(live, st, ref, cams[:C].to(self.dev), pts[:L].to(self.dev),
                              reported)
        ctrl = None
        if control:
            c = ba_blocks.solve(live, ba_solves.settings(cfg, n_cams), devices,
                                precision="tf32")
            ctrl = ref_ba.compare(live, st, ref, c.cams, c.pts, c.cost)
        return prog, ctrl


def _worker(job_path: str, rank: int) -> int:
    """Rank ``rank`` of the world that ``job_path`` describes."""
    job = json.loads(Path(job_path).read_text())
    if job["backend"] == "nccl":
        os.environ.update(NCCL_ENV)
    parent = int(job["parent"])

    def watch_parent():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(0.5)
    threading.Thread(target=watch_parent, daemon=True).start()

    from reconstructor_tpu_torch.parallel import mesh as mesh_mod
    device = "cuda" if job["device"] == "cuda" else "cpu"
    mesh = mesh_mod.initialize_multihost("file://" + job["store"], int(job["world"]), rank,
                                         backend=job["backend"], device=device)
    solver = _Solver(job["config"], job["traffic"], mesh, keep_live=False)
    while _order(mesh) == SOLVE:
        solver.solve()
    _sync(mesh.device)
    peak = int(torch.cuda.max_memory_allocated(mesh.device)) if mesh.device.type == "cuda" else 0
    (Path(job["out"]) / f"rank{rank}.json").write_text(json.dumps({"peak_bytes": peak}))
    return 0


if __name__ == "__main__":
    # leave without tearing the group down: rank 0 waits for this exit
    # before it leaves the group itself
    code = _worker(sys.argv[1], int(sys.argv[2]))
    sys.stderr.flush()
    os._exit(code)
