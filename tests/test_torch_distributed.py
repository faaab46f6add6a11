"""The port's multi-device path on gloo worlds of CPU processes, against
the JAX package's sharded functions on the 8-device CPU mesh of
``tests/conftest.py`` and against the port's single-device functions.

One module fixture starts, side by side, a world of 4 ranks and a world of
1 rank that run every check (``kind=checks``), a world of 2 ranks that run
the driver with ``mesh=`` on the tiny rendered scene of
``test_torch_isolation.py`` (``kind=driver``), and one process without a
group that runs that driver on one device with ``ba_solver="pcg"``
(``kind=single``). The processes block ``jax``, ``jaxlib`` and
``reconstructor_tpu`` and write their outputs per rank; meanwhile this
process runs the JAX package's sharded functions on the same inputs.

- 15 pairs over 4 ranks: one rank's slice ends in a (0, 0) padding pair.
- The gate's draws are injected from the JAX keys ``split(PRNGKey(7),
  B)``, so the port and JAX pick the same minimal sets; a second gate run
  draws from a seeded generator, which must give the single-device
  result and leave every rank's generator where one device leaves it.
- ``solve_distributed`` sums each rank's observations in its own order,
  so its float32 final cost is held to the JAX package's and to
  ``solve_pcg``'s within rtol 1e-5 (measured: 1.1e-6 and 2.2e-6 apart for
  these 10 LM iterations; near convergence the iteration count itself
  moves with the last bits, so ``max_iters`` fixes it), the cameras within
  1e-3; its ranks are bit-identical, and a world of one equals the
  single-device functions bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reconstructor_tpu.ba import distributed as jdist, lm as jlm
from reconstructor_tpu.matching import knn as jknn, pairs as jpairs, superglue as jsg
from reconstructor_tpu.parallel import sharding as jsharding
from reconstructor_tpu_torch.parallel import sharding

import torch_parity
from test_ba import make_ba_problem

pytestmark = pytest.mark.multiprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = dict(ratio_thresh=0.9, cross_check=True, use_fused=False, num_hypotheses=64,
            thresh_px=3.0, min_matches=7)
BA = dict(max_iters=10, cg_iters=100, cg_tol=1e-8)
SG = dict(sinkhorn_iters=10, score_thresh=0.2)

WORKER = r"""
import sys
for name in ("jax", "jaxlib", "reconstructor_tpu"):
    sys.modules[name] = None
import json
import numpy as np
import torch
torch.set_num_threads(1)
from reconstructor_tpu_torch.parallel import sharding

kind, store, world, rank, inp, out = sys.argv[1:7]
GATE = json.loads(sys.argv[7])
BA = json.loads(sys.argv[8])
SG = json.loads(sys.argv[9])
res = {}


def scene_run(mesh, **kw):
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.eval import render
    from reconstructor_tpu_torch.io import images as io_images
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    sc = render.make_scene(seed=0, n_views=5, h=192, w=256, n_blobs=200, tex_size=512,
                           focal_px=1.2 * 256)
    imgs = [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1))
            for im in sc["images"]]
    cfg = ReconstructorConfig(max_keypoints=256, ransac_num_hypotheses=256,
                              pnp_num_hypotheses=256, fundamental_num_hypotheses=128,
                              final_refinement_rounds=1, **kw)
    rec = IncrementalReconstructor(cfg, verbose=False, device="cpu", mesh=mesh)
    st = rec.reconstruct_from_state(rec.detect_features_from_images(imgs))
    keys = sorted(st.matches)
    res.update(registered=np.array(st.registered), lm_xyz=st.lm_xyz,
               poses=np.stack([st.poses[i] for i in sorted(st.poses)]),
               match_keys=np.array(keys), match_tables=np.stack([st.matches[k] for k in keys]),
               gen_state=rec._gen.get_state().numpy())


if kind == "single":
    scene_run(None, ba_solver="pcg")
    np.savez(out, **res)
    sys.exit(0)

mesh = sharding.initialize_multihost("file://" + store, int(world), int(rank),
                                     backend="gloo", device="cpu", timeout_s=240)
if kind == "driver":
    scene_run(mesh)
    np.savez(out, **res)
    sys.exit(0)

from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
from reconstructor_tpu_torch.matching import gated, knn, superglue
z = np.load(inp)
try:
    sharding.make_mesh(int(world) + 1, device="cpu")
except ValueError:
    res["too_many_raises"] = np.array(True)
net = superglue.structured_identity_params()
prob = ba_lm.BAProblem(**{k: torch.from_numpy(z["ba_" + k]) for k in ba_lm.BAProblem._fields})
sg_args = [z["sg_" + k] for k in ("desc", "xy", "score", "mask", "shapes")]
gate_args = [z["gate_" + k] for k in ("desc", "mask", "xy")]


def run(m, prefix):
    '''Every sharded function over ``m``; ``m=None`` runs the
    single-device functions instead.'''
    pairs = z["pairs"]
    if m is None:
        T = torch.from_numpy
        mi, mm = knn.match_all_pairs(T(z["desc"]), T(z["mask"]), T(pairs))
        gi, gc = gated.match_and_gate(*map(T, gate_args), T(pairs), pos=T(z["pos"]), **GATE)
        g = torch.Generator().manual_seed(11)
        hi, hc = gated.match_and_gate(*map(T, gate_args), T(pairs), generator=g, **GATE)
        si, sm, ss = superglue.match_pairs_batched(net, *map(T, sg_args), T(pairs), **SG)
        r = distributed.solve_pcg(prob, **BA)
    else:
        mi, mm = sharding.match_all_pairs_sharded(m, z["desc"], z["mask"], pairs, use_fused=False)
        gi, gc = sharding.match_and_gate_sharded(m, *gate_args, pairs,
                                                 pos=torch.from_numpy(z["pos"]), **GATE)
        g = torch.Generator().manual_seed(11)
        hi, hc = sharding.match_and_gate_sharded(m, *gate_args, pairs, generator=g, **GATE)
        si, sm, ss = sharding.match_superglue_sharded(m, net, *sg_args, pairs, **SG)
        r = distributed.solve_distributed(m, prob, **BA)
    outs = dict(knn_idx=mi, knn_mask=mm, gate_idx=gi, gate_cnt=gc, gen_idx=hi, gen_cnt=hc,
                gen_state=g.get_state(), sg_idx=si, sg_mask=sm, sg_scores=ss,
                ba_cams=r.cam_params, ba_points=r.points, ba_cost0=r.cost_initial,
                ba_cost=r.cost_final, ba_iters=torch.tensor(int(r.iterations)))
    for k, v in outs.items():
        res[prefix + k] = v.numpy()


sharding.reset_counts()
run(mesh, "")
res["all_reduces"] = np.array(sharding.counts()["all_reduce"])
if int(world) == 1:
    run(None, "nomesh_")
np.savez(out, **res)
"""


def launch(kind, world, tmp, inp):
    store = str(tmp / f"store_{kind}_{world}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"{kind}_{world}_{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, kind, store, str(world), str(r), inp, outs[r],
         json.dumps(GATE), json.dumps(BA), json.dumps(SG)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, outs


def collect(procs, outs):
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


def gate_views(rng, n_views=6, n=64, D=32):
    """6 views of 64 points (0.4 px noise) with descriptors that match
    across views: the gate's F fits are well posed. On random
    correspondences, as the JAX test's, near-degenerate 8-point samples
    turn XLA's and torch's float32 rounding into different F (ROADMAP
    queue C 3), and JAX and the port agree only at a rate."""
    pts = rng.uniform([-2, -1.5, 5], [2, 1.5, 9], (n, 3))
    base = rng.standard_normal((n, D))
    desc = np.zeros((n_views, n, D), np.float32)
    xy = np.zeros((n_views, n, 2), np.float32)
    for v in range(n_views):
        a, c = -0.04 * v, np.cos(0.04 * v)
        R = np.array([[c, 0, np.sin(-a)], [0, 1, 0], [-np.sin(-a), 0, c]])
        P = pts @ R.T + np.array([0.25 * v, 0.03 * v, 0.0])
        xy[v] = P[:, :2] / P[:, 2:] * torch_parity.INTR[:2] + torch_parity.INTR[2:4] \
            + rng.normal(0, 0.4, (n, 2))
        d = base + 0.2 * rng.standard_normal(base.shape)
        desc[v] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return desc, np.ones((n_views, n), bool), xy


def inputs():
    """The JAX distributed tests' inputs: unfiltered matching (6 x 64 x
    32 random, 15 pairs), SuperGlue (6 x 32 x 256), a 4-camera BA problem
    with 0.5 px noise; the gate on ``gate_views`` with the draws of the JAX
    keys."""
    rng = np.random.default_rng(3)
    desc = rng.standard_normal((6, 64, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.ones((6, 64), bool)
    xy = rng.uniform(0, 256, (6, 64, 2)).astype(np.float32)
    g_desc, g_mask, g_xy = gate_views(np.random.default_rng(4))
    pairs = jpairs.exhaustive_pairs(6).astype(np.int32)               # 15 pairs
    keys = jax.random.split(jax.random.PRNGKey(7), 16)                # padded to 8 devices
    pos = np.stack([torch_parity.draws(k, (GATE["num_hypotheses"], 8)) for k in keys[:15]])
    rng = np.random.default_rng(5)
    sg_desc = rng.standard_normal((6, 32, 256)).astype(np.float32)
    sg_desc /= np.linalg.norm(sg_desc, axis=-1, keepdims=True)
    sg = dict(sg_desc=sg_desc, sg_xy=rng.uniform(0, 256, (6, 32, 2)).astype(np.float32),
              sg_score=rng.uniform(0.2, 1.0, (6, 32)).astype(np.float32),
              sg_mask=np.ones((6, 32), bool), sg_shapes=np.full((6, 2), 256, np.int32))
    prob, _, _ = make_ba_problem(np.random.default_rng(2), n_cams=4, n_pts=128, px_noise=0.5)
    ba = {"ba_" + k: np.asarray(v) for k, v in prob._asdict().items()}
    return dict(desc=desc, mask=mask, xy=xy, pairs=pairs, pos=pos, keys=keys, gate_desc=g_desc,
                gate_mask=g_mask, gate_xy=g_xy, **sg, **ba)


def jax_refs(z):
    """The JAX package's sharded functions on its 8-device mesh."""
    mesh = jsharding.make_mesh(8)
    mi, mm = jsharding.match_all_pairs_sharded(mesh, z["desc"], z["mask"], z["pairs"])
    chunk = np.zeros((16, 2), np.int32)
    chunk[:15] = z["pairs"]
    gi, gc = jsharding.match_and_gate_sharded(
        mesh, jnp.asarray(z["gate_desc"]), jnp.asarray(z["gate_mask"]),
        jnp.asarray(z["gate_xy"]), jnp.asarray(chunk), z["keys"], **GATE)
    sg_args = [jnp.asarray(z["sg_" + k]) for k in ("desc", "xy", "score", "mask", "shapes")]
    si, sm, ss = jsharding.match_superglue_sharded(
        mesh, jsg.structured_identity_params(), *sg_args, jnp.asarray(chunk),
        use_pallas=False, **SG)
    prob = jlm.BAProblem(**{k: jnp.asarray(z["ba_" + k]) for k in jlm.BAProblem._fields})
    O = prob.obs_uv.shape[0]
    pad = -O % 8
    prob = prob._replace(obs_cam=jnp.pad(prob.obs_cam, (0, pad)),
                         obs_pt=jnp.pad(prob.obs_pt, (0, pad)),
                         obs_uv=jnp.pad(prob.obs_uv, ((0, pad), (0, 0))),
                         obs_mask=jnp.pad(prob.obs_mask, (0, pad)))
    r = jdist.solve_distributed(mesh, prob, **BA)
    ref_i, ref_m = jknn.match_all_pairs(jnp.asarray(z["desc"]), jnp.asarray(z["mask"]),
                                        jnp.asarray(z["pairs"]))
    out = dict(knn_idx=mi, knn_mask=mm, knn_single_idx=ref_i, knn_single_mask=ref_m,
               gate_idx=np.asarray(gi)[:15], gate_cnt=np.asarray(gc)[:15],
               sg_idx=np.asarray(si)[:15], sg_mask=np.asarray(sm)[:15],
               sg_scores=np.asarray(ss)[:15], ba_cams=r.cam_params, ba_cost=r.cost_final,
               ba_iters=r.iterations)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worlds")
    z = inputs()
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **{k: v for k, v in z.items() if k != "keys"})
    runs = {name: launch(kind, world, tmp, inp) for name, kind, world in
            (("four", "checks", 4), ("one", "checks", 1), ("driver", "driver", 2),
             ("single", "single", 1))}
    try:
        ref = jax_refs(z)
    except BaseException:
        for procs, _ in runs.values():
            for p in procs:
                p.kill()
        raise
    out = {name: collect(*run) for name, run in runs.items()}
    out["jax"] = ref
    return out


def check_knn(w):
    r0, nomesh, j = w["four"][0], w["one"][0], w["jax"]
    np.testing.assert_array_equal(r0["knn_idx"], nomesh["nomesh_knn_idx"])
    np.testing.assert_array_equal(r0["knn_mask"], nomesh["nomesh_knn_mask"])
    np.testing.assert_array_equal(r0["knn_idx"], j["knn_idx"])
    np.testing.assert_array_equal(r0["knn_mask"], j["knn_mask"])
    np.testing.assert_array_equal(j["knn_idx"], j["knn_single_idx"])
    assert r0["knn_mask"].sum() > 0


def check_gate_injected(w):
    r0, nomesh, j = w["four"][0], w["one"][0], w["jax"]
    for k in ("gate_idx", "gate_cnt"):
        np.testing.assert_array_equal(r0[k], nomesh["nomesh_" + k])
        np.testing.assert_array_equal(r0[k], j[k])
    assert r0["gate_cnt"].sum() > 0


def check_gate_generator(w):
    r0, nomesh = w["four"][0], w["one"][0]
    for k in ("gen_idx", "gen_cnt", "gen_state"):
        np.testing.assert_array_equal(r0[k], nomesh["nomesh_" + k])


def check_superglue(w):
    r0, nomesh, j = w["four"][0], w["one"][0], w["jax"]
    np.testing.assert_array_equal(r0["sg_idx"], nomesh["nomesh_sg_idx"])
    np.testing.assert_array_equal(r0["sg_mask"], nomesh["nomesh_sg_mask"])
    np.testing.assert_allclose(r0["sg_scores"], nomesh["nomesh_sg_scores"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(r0["sg_idx"], j["sg_idx"])
    np.testing.assert_array_equal(r0["sg_mask"], j["sg_mask"])
    np.testing.assert_allclose(r0["sg_scores"], j["sg_scores"], atol=1e-4, rtol=0)
    assert r0["sg_mask"].sum() > 0


def check_solve_distributed(w):
    r0, nomesh, j = w["four"][0], w["one"][0], w["jax"]
    cost = float(r0["ba_cost"])
    assert cost < float(r0["ba_cost0"]) / 100
    np.testing.assert_allclose(cost, float(j["ba_cost"]), rtol=1e-5)
    np.testing.assert_allclose(cost, float(nomesh["nomesh_ba_cost"]), rtol=1e-5)
    assert int(r0["ba_iters"]) == int(j["ba_iters"]) == int(nomesh["nomesh_ba_iters"])
    C = 4
    np.testing.assert_allclose(r0["ba_cams"][:C], j["ba_cams"][:C], rtol=0, atol=1e-3)
    # every CG iteration reduced twice, and the blocks, rhs, step and costs
    assert r0["all_reduces"] > 2 * int(r0["ba_iters"])


def check_gauge(w):
    prob, _, _ = make_ba_problem(np.random.default_rng(2), n_cams=4, n_pts=128, px_noise=0.5)
    np.testing.assert_array_equal(w["four"][0]["ba_cams"][0], np.asarray(prob.cam_params)[0])


def check_ranks_identical(w):
    ranks = w["four"]
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def check_world_of_one(w):
    one = w["one"][0]
    for k in [k for k in one if k.startswith("nomesh_")]:
        np.testing.assert_array_equal(one[k[len("nomesh_"):]], one[k], err_msg=k)


def check_too_many_devices(w):
    assert all(bool(r["too_many_raises"]) for r in w["four"] + w["one"])
    with pytest.raises(ValueError):
        sharding.make_mesh(2, device="cpu")


def check_driver(w):
    a, b = w["driver"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    single = w["single"][0]
    assert sorted(a["registered"].tolist()) == sorted(single["registered"].tolist())
    assert len(a["registered"]) == 5
    n, m = len(a["lm_xyz"]), len(single["lm_xyz"])
    assert abs(n - m) <= 0.02 * m, (n, m)
    # the matching is sharded, the draws are not: the tables are the single device's
    np.testing.assert_array_equal(a["match_keys"], single["match_keys"])
    np.testing.assert_array_equal(a["match_tables"], single["match_tables"])


CASES = {"knn_unfiltered": check_knn, "gate_injected_draws": check_gate_injected,
         "gate_generator_draws": check_gate_generator, "superglue": check_superglue,
         "solve_distributed": check_solve_distributed, "gauge_camera": check_gauge,
         "ranks_bit_identical": check_ranks_identical, "world_of_one": check_world_of_one,
         "too_many_devices": check_too_many_devices, "driver_world_of_two": check_driver}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded(worlds, case):
    CASES[case](worlds)
