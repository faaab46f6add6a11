"""Traffic kind ``match_passes``: whole passes of gated matching over every
selected pair of an image set, back to back, by one caller.

Inputs (``make_scene``): the feature state of an image set, made on the
device from the seed. ``n_views`` views of one scene on a circular arc
(``arc_degrees`` wide, radius ``radius``), each looking at the scene's
centre; the scene is ``n_points`` points in a box, each visible from the
views within ``visible_degrees`` of its own direction. Every view has
``slots`` keypoint slots, of which a prefix is valid; the valid counts are
the same set for every seed (evenly spaced from ``valid_slots[0]`` to
``valid_slots[1]``), dealt to the views in an order drawn from the seed.
A ``shared_share`` of a view's valid slots are projections of points it
sees (``px_noise`` pixels of noise; descriptor = the point's unit
descriptor plus ``desc_noise`` of Gaussian noise, renormalised), the rest
are clutter (uniform positions, random unit descriptors), in an order drawn
from the seed.

A step is one ``IncrementalReconstructor.match_features(state,
filter=True)`` from empty tables, with the reconstructor's RANSAC seed set
to the run's seed. The check recomputes the last step's tables with the
plain reference on the same draws.

Set-up first matches a two-view scene on a reconstructor of its own (its
RANSAC draws are not the window's), so that the kernels the path loads are
built (in a checkout's first run) before the cell's inputs are made. Then
it runs ``warmup_passes`` whole passes of the cell, and more, up to
``warmup_max_passes``, until two passes in a row take times within
``warmup_settle`` of each other.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference import match as ref_match
from benchmark.trace import annotated, patched


def make_scene(scene: dict, seed: int, device: torch.device) -> dict:
    """The feature state as tensors on ``device``: xy (N, K, 2), desc (N, K,
    D), mask (N, K), valid (N,) counts, intrinsics (N, 6), shapes (N, 2)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(device=device, dtype=torch.float32)
    N, K, D = int(scene["n_views"]), int(scene["slots"]), int(scene["desc_dim"])
    P = int(scene["n_points"])
    h, w, f = int(scene["height"]), int(scene["width"]), float(scene["focal_px"])

    def rand(*shape):
        return torch.rand(*shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(*shape, generator=g, **f32)

    arc = math.radians(float(scene["arc_degrees"]))
    vis = math.radians(float(scene["visible_degrees"]))
    ang = torch.linspace(-arc / 2, arc / 2, N, **f32)
    centre = torch.stack([scene["radius"] * torch.sin(ang),
                          (2 * rand(N) - 1) * scene["height_jitter"],
                          -scene["radius"] * torch.cos(ang)], 1)
    z = -centre / torch.linalg.norm(centre, dim=1, keepdim=True)
    x = torch.linalg.cross(torch.tensor([0.0, -1.0, 0.0], **f32).expand(N, 3), z, dim=1)
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    R = torch.stack([x, torch.linalg.cross(z, x, dim=1), z], 1)          # rows: camera axes
    t = -torch.einsum("nij,nj->ni", R, centre)

    lo = torch.tensor(scene["box_min"], **f32)
    hi = torch.tensor(scene["box_max"], **f32)
    pts = lo + (hi - lo) * rand(P, 3)
    facing = (rand(P) - 0.5) * (arc + 2 * vis)
    base = randn(P, D)
    base = base / torch.linalg.norm(base, dim=1, keepdim=True)

    pc = torch.einsum("nij,pj->npi", R, pts) + t[:, None]
    zc = pc[..., 2]
    uv = f * pc[..., :2] / zc.clamp(min=1e-6)[..., None] + torch.tensor([w / 2, h / 2], **f32)
    seen = ((zc > 0.5) & (uv[..., 0] >= 4) & (uv[..., 0] < w - 4) & (uv[..., 1] >= 4)
            & (uv[..., 1] < h - 4) & ((ang[:, None] - facing[None]).abs() < vis))

    lo_v, hi_v = scene["valid_slots"]
    valid = torch.round(torch.linspace(float(lo_v), float(hi_v), N, **f32)).long()
    valid = valid[torch.randperm(N, generator=g, device=device)]
    shared = torch.minimum(torch.round(valid.float() * scene["shared_share"]).long(),
                           seen.sum(1))
    # the shared points of each view: its visible points in a random order
    pick = torch.argsort(torch.where(seen, rand(N, P), -1.0), dim=1, descending=True)[:, :K]
    slot = torch.arange(K, device=device)
    is_pt = slot[None] < shared[:, None]
    is_valid = slot[None] < valid[:, None]
    pid = torch.where(is_pt, pick, 0)
    # deal the valid entries to the valid slots in a random order
    key = torch.where(is_valid, rand(N, K), 2.0)
    order = torch.argsort(key, dim=1)
    pid, is_pt = torch.gather(pid, 1, order), torch.gather(is_pt, 1, order)

    n_idx = torch.arange(N, device=device)[:, None]
    xy_pt = uv[n_idx, pid] + scene["px_noise"] * randn(N, K, 2)
    xy_cl = rand(N, K, 2) * torch.tensor([w - 1.0, h - 1.0], **f32)
    d_pt = base[pid] + scene["desc_noise"] * randn(N, K, D)
    d_cl = randn(N, K, D)
    desc = torch.where(is_pt[..., None], d_pt, d_cl)
    desc = desc / torch.linalg.norm(desc, dim=2, keepdim=True)
    xy = torch.where(is_pt[..., None], xy_pt, xy_cl)
    desc = torch.where(is_valid[..., None], desc, 0.0)
    xy = torch.where(is_valid[..., None], xy, 0.0)
    intr = torch.tensor([f, f, w // 2, h // 2, 0.0, 0.0], **f32).expand(N, 6)
    shapes = torch.tensor([h, w], device=device, dtype=torch.int32).expand(N, 2)
    return {"xy": xy, "desc": desc, "mask": is_valid, "valid": valid,
            "intrinsics": intr.contiguous(), "shapes": shapes.contiguous()}


class Runner:
    """Passes of ``match_features`` over every selected pair."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.dev = int(seed), device
        self.passes = 0          # passes made, warm-up included
        self._traced = {"passes": 0}

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from reconstructor_tpu_torch.config import ReconstructorConfig
        from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
        from reconstructor_tpu_torch.pipeline.state import ReconstructionState

        self.cfg = ReconstructorConfig(**self.config["reconstructor"]).with_(rng_seed=self.seed)

        def state(scene):
            s = {k: v.cpu().numpy() for k, v in scene.items()}
            N, K = s["mask"].shape
            return ReconstructionState(
                num_images=N, max_keypoints=K, xy=s["xy"], desc=s["desc"], kp_mask=s["mask"],
                colors=np.zeros((N, K, 3), np.uint8), shapes=s["shapes"],
                intrinsics=s["intrinsics"])
        IncrementalReconstructor(self.cfg, verbose=False, device=self.dev).match_features(
            state(make_scene({**self.config["scene"], "n_views": 2}, self.seed, self.dev)))
        self.scene = make_scene(self.config["scene"], self.seed, self.dev)
        self.state = state(self.scene)
        self.recon = IncrementalReconstructor(self.cfg, verbose=False, device=self.dev)
        self.pairs = self.recon.select_pairs(self.state)
        # the driver's chunk rule on one device
        self.chunk = (self.cfg.match_chunk_pairs_fused if self.dev.type == "cuda"
                      else self.cfg.match_chunk_pairs)
        t = self.traffic
        least, most = int(t.get("warmup_passes", 1)), int(t.get("warmup_max_passes", 0))
        settle = float(t.get("warmup_settle", 0.0))
        times = []

        def settled():
            return len(times) >= 2 and abs(times[-1] - times[-2]) <= settle * times[-2]
        while len(times) < least or (len(times) < most and not settled()):
            t0 = time.perf_counter()
            self.step()
            times.append(time.perf_counter() - t0)
        self.warmup_times = times

    def step(self) -> None:
        self.state.matches = {}
        self.recon.match_features(self.state, filter=True)
        self.passes += 1

    def e2e(self, elapsed: float, steps: int) -> dict:
        return {"match_pairs_per_s": steps * len(self.pairs) / elapsed}

    # ------------------------------------------------------------------
    def trace_hooks(self, stop):
        """Spans around the calls into each layer for the traced passes (which
        ``run.py`` ends: ``stop`` is not needed here)."""
        from reconstructor_tpu_torch.matching import cuda_knn, gated
        from reconstructor_tpu_torch.parallel import sharding
        traced = self._traced

        def count_pass(fn):
            spanned = annotated("match_features")(fn)

            def inner(*a, **k):
                traced["passes"] += 1
                return spanned(*a, **k)
            return inner
        return patched([
            (type(self.recon), "match_features", count_pass),
            (sharding, "match_and_gate_sharded", annotated("match_and_gate")),
            (cuda_knn, "match_all_pairs_fused", annotated("knn")),
            (gated, "filter_pairs", annotated("fgate")),
        ])

    def counters(self) -> dict:
        """Per traced pass: pairs, chunks and kernel 1's least seconds."""
        kt = ref_match.fitted_width(self.scene["mask"])
        D = self.scene["desc"].shape[2]
        N = self.scene["mask"].shape[0]
        valid = self.scene["valid"].clamp(max=kt)
        elt = 2 if self.cfg.knn_compute_dtype == "bfloat16" else 4
        pairs = torch.as_tensor(self.pairs, device=self.dev)
        bound = sum(roofline.knn_bound_s(valid, pairs[s:s + self.chunk], N, kt, D, elt)
                    for s in range(0, len(self.pairs), self.chunk))
        return {"traced_passes": self._traced["passes"], "pairs": len(self.pairs),
                "chunks": -(-len(self.pairs) // self.chunk), "knn_bound_s": bound}

    # ------------------------------------------------------------------
    def check(self) -> list:
        """The last pass's tables against the reference's on the same draws,
        each number beside the cell's limit."""
        got, _ = self.judge()
        return [(name, got[name], float(lim)) for name, lim in self.cell["limits"].items()]

    def judge(self, control: bool = False):
        """(the program's numbers, the control's or None): the last pass's
        tables, and with ``control`` the reference's own tables from float8
        descriptors, each against the reference's tables on the same draws."""
        cfg, dev, sc = self.cfg, self.dev, self.scene
        P, K = len(self.pairs), self.state.max_keypoints
        got = np.full((P, K), -1, np.int64)
        for p, (i, j) in enumerate(self.pairs):
            m = self.state.matches.get((int(i), int(j)))
            if m is not None:
                got[p] = m
        self.recon = self.state = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        H = cfg.fundamental_num_hypotheses
        sizes = [min(self.chunk, P - s) for s in range(0, P, self.chunk)]
        pairs = torch.as_tensor(self.pairs, device=dev)

        def tables(precision):
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.seed)
            for _ in range(self.passes - 1):        # the draws of the earlier passes
                for n in sizes:
                    ref_match.raw_draws((n, H, 8), dev, gen)
            return ref_match.match_tables(
                sc["desc"], sc["mask"], sc["xy"], pairs, self.chunk,
                lambda n: ref_match.raw_draws((n, H, 8), dev, gen),
                ratio=cfg.ratio_thresh, cross_check=cfg.cross_check, num_hypotheses=H,
                thresh_px=cfg.fundamental_thresh_px, min_matches=cfg.min_matches_for_filter,
                precision=precision)
        ref = tables(self._precision())
        prog = ref_match.compare_tables(torch.as_tensor(got, device=dev), ref)
        ctrl = ref_match.compare_tables(tables("float8"), ref) if control else None
        return prog, ctrl

    def _precision(self) -> str:
        """The matcher's precision as the run states it: the configuration's
        on the card, float32 where the program's CPU path runs."""
        return self.cfg.knn_compute_dtype if self.dev.type == "cuda" else "float32"
