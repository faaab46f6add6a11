"""Helpers shared by the port's parity tests (``test_torch_*.py``): numpy
inputs to both packages, and the raw RANSAC draws the JAX samplers make."""

import contextlib
import signal

import numpy as np
import jax
import jax.numpy as jnp
import torch

from reconstructor_tpu.geometry import se3 as jse3

# The tier-1 run puts six pytest workers on the machine's cores, each
# also running XLA's own thread pool: two torch threads per worker keep
# the CPU from being oversubscribed several times over.
torch.set_num_threads(2)

I32MAX = jnp.iinfo(jnp.int32).max


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the enclosed test (as a decorator) or block with TimeoutError
    once it has run ``seconds`` of wall time (SIGALRM; pytest runs each
    test in its process's main thread)."""
    def expire(signum, frame):
        raise TimeoutError(f"over its time limit of {seconds} s")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def t(a):
    """A CPU tensor holding a copy of ``a``."""
    return torch.from_numpy(np.array(a))


def draws(key, shape):
    """The raw draws ``ransac.sample_minimal_sets`` makes from ``key``."""
    return np.asarray(jax.random.randint(key, shape, 0, I32MAX, dtype=jnp.int32))


INTR = np.array([400.0, 400.0, 160.0, 120.0, 0.0, 0.0], np.float32)


def two_view(rng, n=200, outliers=0.3, noise=0.4):
    """Correspondences of one scene in two cameras, with outliers."""
    pts = rng.uniform([-2, -1.5, 5], [2, 1.5, 9], (n, 3)).astype(np.float32)
    R = np.asarray(jse3.angle_axis_to_rotation(jnp.asarray([0.02, -0.08, 0.01], jnp.float32)))
    tr = np.array([0.6, 0.05, 0.02], np.float32)

    def proj(P):
        return P[:, :2] / P[:, 2:] * INTR[:2] + INTR[2:4]
    uv1 = proj(pts) + rng.normal(0, noise, (n, 2))
    uv2 = proj(pts @ R.T + tr) + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    uv2[bad] = rng.uniform([0, 0], [320, 240], (int(bad.sum()), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), pts, R, tr


def smoke_views(views):
    """Views of the smoke script's 25-view 384x512 scene
    (``scripts/profile_incremental.smoke_scene``), rendering only those:
    (gray images (n, 384, 512) in [0, 1], world-to-camera poses (n, 4, 4)).
    ORB needs its wider baselines: every 3rd view is a 5.25 degree step."""
    from reconstructor_tpu_torch.eval import render
    rng = np.random.default_rng(0)
    tex_a, _ = render.make_blob_texture(rng, 1024, 1200)
    tex_b, _ = render.make_blob_texture(rng, 1024, 1200)
    poses = render.corner_rig(25, rng=rng)[list(views)]
    imgs, _ = render.render_views(poses, tex_a, tex_b, 384, 512, 614.4)
    return np.stack(imgs), poses


def rendered_folder(d, seed: int = 11):
    """``test_integration.render_synthetic_views`` (4 views of 256x320) as
    PNGs in the folder ``d`` (a ``pathlib.Path``), with a golden PLY of the
    true camera centres beside them (gray points, green camera rows, as
    the port writes one): (folder, golden PLY path, world-to-camera poses)."""
    from PIL import Image
    from reconstructor_tpu_torch.io import ply
    from test_integration import render_synthetic_views
    imgs, poses, _, pts = render_synthetic_views(np.random.default_rng(seed))
    for i, im in enumerate(imgs):
        Image.fromarray((im * 255).astype(np.uint8)).convert("RGB").save(str(d / f"{i:02d}.png"))
    golden = str(d / "golden.ply")
    ply.save_cloud(golden, pts, np.full((len(pts), 3), 128, np.uint8), poses)
    return str(d), golden, poses


# the configuration of the measuring scripts' tests on those views
# (``test_torch_pipeline``'s, with 128 F-gate hypotheses)
MEASURE_KW = dict(max_keypoints=256, ransac_num_hypotheses=256, pnp_num_hypotheses=256,
                  fundamental_num_hypotheses=128, focal_px=300.0, pnp_min_inliers=8,
                  min_2d3d_match_num=5)
