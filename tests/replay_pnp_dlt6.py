"""Replay the PnP registrations that ``chip_smoke.py --pnp-replay NPZ``
kept (each view's 2D-3D matches, intrinsics, the P3P and DLT6 RANSAC
draws made on the card, and the card's poses and inlier masks) through
the JAX package and through the port on the CPU, on those same draws.

The JAX ``solve_pnp_ransac`` samples from a key; here its
``ransac.sample_minimal_sets`` is replaced, for this process only, by one
that indexes the compacted valid slots with the card's raw draws, as the
port's ``pos=`` does. Prints one JSON line a view and one for the whole:
inlier counts (card, port on the CPU, JAX), the pose gaps card-JAX and
CPU-JAX, JAX's own DLT6-P3P gap, and that gap once both JAX poses are
polished again over JAX's DLT6 inliers. Gaps are the rotation angle in
degrees and the camera centres' distance over the camera's distance to
the landmarks' mean.

    JAX_PLATFORMS=cpu python tests/replay_pnp_dlt6.py NPZ
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

MINIMALS = {"p3p": 3, "dlt6": 6}


def centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def gap(Ta, Tb, dist):
    """(rotation angle in degrees, centre distance / dist), in float64."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    d = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / np.sqrt(8.0)
    return (float(np.degrees(2.0 * np.arcsin(min(d, 1.0)))),
            float(np.linalg.norm(centre(Ta) - centre(Tb)) / dist))


def replay_view(z, k: int) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from reconstructor_tpu.geometry import pnp as jpnp
    from reconstructor_tpu.geometry import ransac as jransac
    from reconstructor_tpu_torch.geometry import pnp as tpnp

    X, uv, intr = z[f"X{k}"], z[f"uv{k}"], z[f"intr{k}"]
    mask = np.ones(len(X), bool)
    kw = dict(thresh_px=float(z["thresh_px"]), refine_iters=int(z["refine_iters"]))
    out = {"view": int(z[f"view{k}"]), "matches": len(X)}
    dist = float(np.linalg.norm(centre(z[f"pose_p3p{k}"]) - X.mean(0)))
    jres = {}
    for m in MINIMALS:
        pos = z[f"pos_{m}{k}"]

        def sample(key, msk, num_hypotheses, sample_size, pos=pos):
            order = jnp.argsort(~msk.astype(bool))
            return order[jnp.asarray(pos) % jnp.maximum(jnp.sum(msk), 1)]
        original = jransac.sample_minimal_sets
        jransac.sample_minimal_sets = sample
        try:
            pj, ij, _ = jpnp.solve_pnp_ransac(
                jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(intr),
                jnp.asarray(mask), num_hypotheses=len(pos), minimal=m, **kw)
        finally:
            jransac.sample_minimal_sets = original
        pt, it, _ = tpnp.solve_pnp_ransac(
            torch.as_tensor(X), torch.as_tensor(uv), torch.as_tensor(intr),
            torch.as_tensor(mask), num_hypotheses=len(pos), pos=torch.as_tensor(pos),
            minimal=m, **kw)
        pj, ij = np.asarray(pj), np.asarray(ij)
        jres[m] = (pj, ij)
        card = z[f"pose_{m}{k}"]
        out[m] = {"inliers_card_cpu_jax": [int(z[f"inliers_{m}{k}"].sum()), int(it.sum()),
                                           int(ij.sum())],
                  "card_vs_jax": gap(card, pj, dist), "cpu_vs_jax": gap(pt.numpy(), pj, dist),
                  "card_vs_cpu": gap(card, pt.numpy(), dist),
                  "inliers_card_eq_jax": bool((z[f"inliers_{m}{k}"] == ij).all())}
    out["jax_dlt6_vs_p3p"] = gap(jres["dlt6"][0], jres["p3p"][0], dist)
    w = jnp.asarray(jres["dlt6"][1].astype(np.float32))
    polished = [np.asarray(jpnp._gauss_newton_refine(
        jnp.asarray(jres[m][0]), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(intr), w,
        kw["refine_iters"])) for m in MINIMALS]
    out["jax_repolished_dlt6_vs_p3p"] = gap(polished[1], polished[0], dist)
    out["card_dlt6_vs_p3p"] = gap(z[f"pose_dlt6{k}"], z[f"pose_p3p{k}"], dist)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("npz")
    args = ap.parse_args(argv)
    z = np.load(args.npz)
    n = sum(1 for key in z.files if key.startswith("view"))
    rows = []
    for k in range(n):
        rows.append(replay_view(z, k))
        print(json.dumps(rows[-1]), flush=True)
    posed = [r for r in rows
             if r["dlt6"]["inliers_card_cpu_jax"][2] >= 0.9 * r["p3p"]["inliers_card_cpu_jax"][2]]
    print(json.dumps({
        "views": n, "jax_dlt6_posed": [r["view"] for r in posed],
        "p3p_card_vs_jax_max": [max(r["p3p"]["card_vs_jax"][i] for r in rows) for i in (0, 1)],
        "dlt6_card_vs_jax_max": [max(r["dlt6"]["card_vs_jax"][i] for r in rows) for i in (0, 1)],
        "jax_posed_dlt6_vs_p3p_max": [max((r["jax_dlt6_vs_p3p"][i] for r in posed), default=None)
                                      for i in (0, 1)],
        "jax_repolished_max": [max(r["jax_repolished_dlt6_vs_p3p"][i] for r in rows)
                               for i in (0, 1)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
