"""The port's multi-rank global BA and its collectives on gloo worlds of CPU
processes, against the benchmark's plain float64 reference
(``benchmark/reference/ba.py``, plain ``torch``, no part of the engine).

One module fixture starts a world of 4 ranks (JAX and the JAX package
blocked) that solves two seeded problems with ``solve_distributed`` at the
benchmark's settings (``traffic/ba_solves``: the engine's global-BA settings,
Huber 3 px, Marquardt, ftol 1e-6), and checks ``parallel.mesh``'s byte
counters and spans. This process solves the same problems with the
reference in float64 and with its TF32 control.

- (a) ``cost_excess``, ``cost_report`` and ``reproj_gap_px`` against the
  float64 solve from the same start. Tolerances: 1e-4, 1e-5 and 0.01 px.
  The program sums in float32 and stops at ftol 1e-6 after its own number of
  LM iterations (seed 3: 34 on one device, the reference 42), so its cost
  sits up to ~2e-5 above the reference's, its reported cost ~2e-6 off its
  float64 cost, its pixels ~1e-3 px from the reference's (one device, seeds
  3 and 7: at most 1.6e-5, 1.9e-6, 1.2e-3 px). The control, whose products
  read TF32 operands, reads at least 0.11, 0.0037 and 0.17 px: it fails
  every tolerance.
- (b) The shares: each rank's slice of the observations (``shard_problem``)
  gives partial block sums, W^T u and W z before ``all_sum``; the four
  partials add up to the sums of the uncut problem.
- (c) ``mesh.counts()``: the bytes each ``all_sum`` and ``all_gather`` handed
  the group, cleared by ``reset_counts``.
- (d) ``mesh.all_sum`` and ``mesh.all_gather`` spans under a CPU profiler.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import ba as ref_ba
from benchmark.spec import Bench
from reconstructor_tpu_torch.ba import cuda_schur, distributed, lm as ba_lm
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.parallel.mesh import Mesh

import torch_parity  # noqa: F401  (sets the worker's torch thread count)

pytestmark = pytest.mark.multiprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SEEDS = (3, 7)
COUNTS = dict(cameras=16, points=800, observations=2400)
LIMITS = {"cost_excess": 1e-4, "cost_report": 1e-5, "reproj_gap_px": 0.01}

WORKER = r"""
import sys
for name in ("jax", "jaxlib", "reconstructor_tpu"):
    sys.modules[name] = None
import json
import numpy as np
import torch
torch.set_num_threads(1)
from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
from reconstructor_tpu_torch.parallel import mesh as mesh_mod
from reconstructor_tpu_torch.utils import profiling

store, world, rank, inp, out, logdir = sys.argv[1:7]
kw = json.loads(sys.argv[7])
mesh = mesh_mod.initialize_multihost("file://" + store, int(world), int(rank),
                                     backend="gloo", device="cpu", timeout_s=240)
res = {}
# (c) the byte counters
a, b = torch.ones(3, 4), torch.arange(5, dtype=torch.float32)
mesh_mod.reset_counts()
sa, sb = mesh_mod.all_sum(mesh, a, b)
g = mesh_mod.all_gather(mesh, torch.full((2, 3), float(rank)))
n = mesh_mod.counts()
mesh_mod.reset_counts()
res.update(sum_a=sa.numpy(), sum_b=sb.numpy(), gathered=g.numpy(),
           counts=np.array([n["all_reduce"], n["all_reduce_bytes"], n["all_gather"],
                            n["all_gather_bytes"]]),
           cleared=np.array(list(mesh_mod.counts().values())))
# (d) the spans
with profiling.trace(logdir, device="cpu"):
    mesh_mod.all_sum(mesh, a)
    mesh_mod.all_gather(mesh, a)
# (a) the solves
z = np.load(inp)
for seed in kw.pop("seeds"):
    prob = ba_lm.BAProblem(**{k: torch.from_numpy(z[f"{seed}_{k}"])
                              for k in ba_lm.BAProblem._fields})
    mesh_mod.reset_counts()
    r = distributed.solve_distributed(mesh, prob, **kw)
    n = mesh_mod.counts()
    res.update({f"{seed}_cams": r.cam_params.numpy(), f"{seed}_pts": r.points.numpy(),
                f"{seed}_cost": np.array(float(r.cost_final)),
                f"{seed}_iters": np.array(int(r.iterations)),
                f"{seed}_reduce_bytes": np.array(n["all_reduce_bytes"]),
                f"{seed}_reduces": np.array(n["all_reduce"])})
np.savez(out, **res)
"""


def ba_solves():
    return Bench(REPO).kind("ba_solves")


def config():
    return Bench(REPO).config("bal-final13682")


def problem(seed):
    """(padded arrays, live problem) of a tiny problem of the benchmark's
    generator on the CPU."""
    p = ba_solves().make_problem(config()["scene"], COUNTS, seed, torch.device("cpu"))
    return p, p.pop("live")


def settings(**override):
    bs = ba_solves()
    cfg = ReconstructorConfig(**config()["reconstructor"])
    return cfg, bs.settings(cfg, COUNTS["cameras"], **override)


def solve_kwargs():
    cfg, st = settings()
    return dict(max_iters=st.max_iters, init_lambda=st.init_lambda, lambda_up=st.lambda_up,
                lambda_down=st.lambda_down, ftol=st.ftol,
                focal_upper_bound=st.focal_upper_bound, huber_delta=st.huber_delta,
                damping=cfg.ba_damping)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ba")
    arrays = {}
    for seed in SEEDS:
        p, _ = problem(seed)
        arrays.update({f"{seed}_{k}": v.numpy() for k, v in p.items()})
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    logs = [str(tmp / f"trace{r}") for r in range(WORLD)]
    kw = dict(solve_kwargs(), seeds=list(SEEDS))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp / "store"), str(WORLD),
                               str(r), inp, outs[r], logs[r], json.dumps(kw)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-3000:]
    return {"ranks": [dict(np.load(o)) for o in outs], "traces": logs}


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_distributed_against_the_float64_reference(world, seed):
    p, live = problem(seed)
    _, st = settings(**config()["reference_settings"])
    ref = ref_ba.solve(live, st, precision="float64")
    r0 = world["ranks"][0]
    C, L = live.cams.shape[0], live.pts.shape[0]
    got = ref_ba.compare(live, st, ref, torch.from_numpy(r0[f"{seed}_cams"][:C]),
                         torch.from_numpy(r0[f"{seed}_pts"][:L]), float(r0[f"{seed}_cost"]))
    assert all(got[k] <= lim for k, lim in LIMITS.items()), got
    # every rank ends with the same state
    for r in world["ranks"][1:]:
        for k in ("cams", "pts", "cost", "iters"):
            np.testing.assert_array_equal(r[f"{seed}_{k}"], r0[f"{seed}_{k}"])
    # the TF32 control fails at least one tolerance
    _, st_ctrl = settings()
    c = ref_ba.solve(live, st_ctrl, precision="tf32")
    ctrl = ref_ba.compare(live, st, ref, c.cams, c.pts, c.cost)
    assert any(ctrl[k] > lim for k, lim in LIMITS.items()), ctrl


@pytest.mark.parametrize("seed", SEEDS)
def test_rank_shares_add_up_to_the_uncut_sums(seed):
    p, _ = problem(seed)
    prob = ba_lm.BAProblem(**p)
    prob = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    cam, pts = prob.cam_params, prob.points
    g = torch.Generator().manual_seed(seed % 1000)
    u = torch.randn(cam.shape[0], 12, generator=g)
    z = torch.randn(pts.shape[0], 3, generator=g)

    def sums(pr):
        lay = distributed._layouts(pr)
        g_c, g_p, H_cc, H_pp, Y = distributed._build_pcg_blocks(pr, lay, cam, pts, 3.0)
        return g_c, g_p, H_cc, H_pp, cuda_schur.ytu_sum(Y, u, lay), cuda_schur.yz_sum(Y, z, lay)

    whole = sums(prob)
    parts, live = [], 0
    for rank in range(WORLD):
        mesh = Mesh(group=None, rank=rank, size=WORLD, backend="none",
                    device=torch.device("cpu"))
        sh = distributed.shard_problem(mesh, prob)
        assert sh.obs_uv.shape[0] == prob.obs_uv.shape[0] // WORLD
        live += int(sh.obs_mask.sum())
        parts.append(sums(sh._replace(obs_cam=sh.obs_cam.long(), obs_pt=sh.obs_pt.long())))
    assert live == COUNTS["observations"]
    names = ("g_c", "g_p", "H_cc", "H_pp", "ytu", "yz")
    for name, w, ps in zip(names, whole, zip(*parts)):
        total = ps[0].double() + ps[1].double() + ps[2].double() + ps[3].double()
        scale = float(w.abs().max())
        np.testing.assert_allclose(total.numpy(), w.double().numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_counts_report_the_bytes_each_rank_reduced_and_gathered(world):
    for rank, r in enumerate(world["ranks"]):
        np.testing.assert_array_equal(r["sum_a"], np.full((3, 4), float(WORLD)))
        np.testing.assert_array_equal(r["sum_b"], WORLD * np.arange(5, dtype=np.float32))
        np.testing.assert_array_equal(r["gathered"][:, 0], np.repeat(np.arange(WORLD), 2))
        # one all_sum of 12 + 5 float32, one all_gather of 6 float32
        assert r["counts"].tolist() == [1, (12 + 5) * 4, 1, 6 * 4]
        assert r["cleared"].tolist() == [0, 0, 0, 0]
    # a solve: every all_sum's buffer counted, the same bytes on every rank
    for seed in SEEDS:
        b = [int(r[f"{seed}_reduce_bytes"]) for r in world["ranks"]]
        n = int(world["ranks"][0][f"{seed}_reduces"])
        assert len(set(b)) == 1 and n > 2 * int(world["ranks"][0][f"{seed}_iters"])
        # at least the blocks' g_c, g_p, H_cc, H_pp over the padded cameras
        # and points, once an LM iteration
        p, _ = problem(seed)
        C, L = p["cam_params"].shape[0], p["points"].shape[0]
        per_blocks = (C * 12 + L * 3 + C * 144 + L * 9) * 4
        assert b[0] >= per_blocks * int(world["ranks"][0][f"{seed}_iters"])


def test_collectives_record_their_spans_under_a_cpu_profiler(world):
    from reconstructor_tpu_torch.utils import profiling
    for logdir in world["traces"]:
        names = [e["name"] for e in json.load(open(os.path.join(logdir, profiling.TRACE_FILE)))
                 ["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        assert names.count("mesh.all_sum") == 1 and names.count("mesh.all_gather") == 1
