"""Diagnostic visualizations — drawFeatMatchesAndSave parity.

The reference writes one side-by-side image per matched pair with red
match lines (SequentialReconstructor.cpp:117-196, saved under
out/matches/pairXY.JPG). Same artifact here, drawn with PIL on the
reference-resized images; only stored (i < j) pairs are drawn (the
reference draws both orders of every pair — pure duplication).

A copy of ``reconstructor_tpu.utils.viz``. PIL and matplotlib are imported
inside the functions that draw, so the package imports where neither is
installed (the machine with the card has neither).
"""

from __future__ import annotations

import os

import numpy as np


def draw_pair_matches(rgb1: np.ndarray, rgb2: np.ndarray,
                      xy1: np.ndarray, xy2: np.ndarray):
    """Side-by-side montage with red lines between matched keypoints."""
    from PIL import Image, ImageDraw
    h = max(rgb1.shape[0], rgb2.shape[0])
    w = rgb1.shape[1] + rgb2.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: rgb1.shape[0], : rgb1.shape[1]] = rgb1
    canvas[: rgb2.shape[0], rgb1.shape[1]:] = rgb2
    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    off = rgb1.shape[1]
    for (x1, y1), (x2, y2) in zip(xy1, xy2):
        draw.line([(float(x1), float(y1)), (float(x2) + off, float(y2))],
                  fill=(255, 0, 0), width=1)
    return img


def draw_all_matches(state, img_folder: str, out_folder: str) -> int:
    """Write matches/pair{i}{j}.JPG for every stored pair; returns count."""
    from reconstructor_tpu_torch.io import images as io_images
    matches_dir = os.path.join(out_folder, "matches")
    os.makedirs(matches_dir, exist_ok=True)
    imgs = io_images.load_folder(img_folder)
    n = 0
    for (i, j), m in state.matches.items():
        sel = np.where(m >= 0)[0]
        if sel.size == 0:
            continue
        img = draw_pair_matches(imgs[i].rgb, imgs[j].rgb,
                                state.xy[i, sel], state.xy[j, m[sel]])
        img.save(os.path.join(matches_dir, f"pair{i}{j}.JPG"))
        n += 1
    return n


def draw_keypoints(rgb: np.ndarray, xy: np.ndarray,
                   radius: int = 2):
    """Keypoint overlay (Utils::visualizeKeypoints equivalent)."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(rgb)
    draw = ImageDraw.Draw(img)
    for x, y in xy:
        draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                     outline=(0, 255, 0))
    return img


def render_cloud(ply_path: str, out_png: str, views=((20, -60), (10, -120)),
                 point_size: float = 0.5) -> None:
    """Offline render of a reconstruction cloud to PNG.

    The reference ships viewer screenshots (fountain1.jpg/fountain2.jpg,
    README:11-21) from its interactive PCL window (utils.cpp:278-326);
    this is the headless equivalent: two elevation/azimuth views of the
    colored landmarks with camera centers overdrawn in green.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from reconstructor_tpu_torch.io import ply as ply_mod

    pts, cols = ply_mod.load_cloud(ply_path)
    is_cam = np.all(cols == np.array([0, 250, 0], np.uint8), axis=1)
    lm, lm_c = pts[~is_cam], cols[~is_cam]
    cams = pts[is_cam]

    # robust extent clip so far outliers don't flatten the view
    lo, hi = np.percentile(lm, [2, 98], axis=0)
    keep = np.all((lm >= lo) & (lm <= hi), axis=1)
    lm, lm_c = lm[keep], lm_c[keep]

    fig = plt.figure(figsize=(7 * len(views), 7))
    for i, (elev, azim) in enumerate(views):
        ax = fig.add_subplot(1, len(views), i + 1, projection="3d")
        ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], c=lm_c / 255.0,
                   s=point_size, linewidths=0)
        if cams.size:
            ax.scatter(cams[:, 0], cams[:, 1], cams[:, 2], c="lime", s=30,
                       marker="^", depthshade=False)
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110, facecolor="black")
    plt.close(fig)
