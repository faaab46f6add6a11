"""Reconstruction state from saved arrays.

``reconstructor_tpu.pipeline.checkpoint`` writes a ReconstructionState as
one npz of named arrays. This module builds this package's state from
arrays in that layout — read from such a file, or taken straight from a
live state of the other package — so a run can continue here on the
exact features and matches another run produced. Writing checkpoints and
resuming the reconstructor's random stream are not part of this package
yet.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from reconstructor_tpu_torch.pipeline.state import ReconstructionState

FIELDS = ["xy", "desc", "kp_mask", "kp_score", "colors", "shapes",
          "intrinsics", "feat2lm", "lm_xyz", "lm_rgb", "lm_obs_img",
          "lm_obs_feat", "lm_obs_mask", "lm_initial"]


def arrays_of(state) -> dict:
    """The checkpoint layout of a state object (of either package), as
    copies: its array fields plus num_images, max_keypoints, registered,
    pose_ids/pose_mats and match_keys/match_vals."""
    data = {f: np.array(getattr(state, f)) for f in FIELDS
            if getattr(state, f) is not None}
    data["num_images"] = np.asarray(state.num_images)
    data["max_keypoints"] = np.asarray(state.max_keypoints)
    data["registered"] = np.asarray(state.registered, np.int32)
    pose_ids = np.asarray(sorted(state.poses), np.int32)
    data["pose_ids"] = pose_ids
    data["pose_mats"] = (np.stack([state.poses[int(i)] for i in pose_ids])
                         if pose_ids.size else np.zeros((0, 4, 4), np.float32))
    keys = np.asarray(sorted(state.matches), np.int32).reshape(-1, 2)
    data["match_keys"] = keys
    data["match_vals"] = (np.stack([state.matches[(int(i), int(j))] for i, j in keys])
                          if keys.size else np.zeros((0, state.max_keypoints), np.int32))
    return data


def state_from_arrays(z: Mapping[str, np.ndarray]) -> ReconstructionState:
    """Build a ReconstructionState from checkpoint-layout arrays (copies)."""
    def get(name):
        return np.array(z[name]) if name in z else None
    state = ReconstructionState(
        num_images=int(z["num_images"]),
        max_keypoints=int(z["max_keypoints"]),
        xy=get("xy"), desc=get("desc"), kp_mask=get("kp_mask"),
        colors=get("colors"), shapes=get("shapes"), intrinsics=get("intrinsics"),
        kp_score=get("kp_score"), feat2lm=get("feat2lm"),
        lm_xyz=get("lm_xyz"), lm_rgb=get("lm_rgb"),
        lm_obs_img=get("lm_obs_img"), lm_obs_feat=get("lm_obs_feat"),
        lm_obs_mask=get("lm_obs_mask"), lm_initial=get("lm_initial"))
    if "registered" in z:
        state.registered = [int(i) for i in z["registered"]]
    if "pose_ids" in z:
        for i, T in zip(z["pose_ids"], z["pose_mats"]):
            state.poses[int(i)] = np.array(T)
    if "match_keys" in z:
        for (i, j), m in zip(z["match_keys"], z["match_vals"]):
            state.matches[(int(i), int(j))] = np.array(m, np.int32)
    return state


def load(path: str) -> ReconstructionState:
    """Read a checkpoint npz into a ReconstructionState."""
    with np.load(path, allow_pickle=False) as z:
        return state_from_arrays({k: z[k] for k in z.files})
