"""Reconstruction checkpoint / resume.

A ReconstructionState round-trips through one compressed npz of named
arrays — frontend outputs, match tables, poses and the landmark /
observation tables — in the layout of ``reconstructor_tpu.pipeline.
checkpoint``, so each package reads the other's files and a run resumes
after any stage. ``save`` writes through ``<path>.tmp.npz`` and
``os.replace``, so an interrupted write leaves the last file whole.

Beside the state, ``meta_json`` carries the config's scalar fields,
``"rng": "torch"`` and the generator's device type, and ``caps``: ``{}``,
because this package runs eagerly and keeps no sticky shape caps. The
generator's ``get_state()`` bytes are stored as ``rng_state_torch``; the
JAX package's ``rng_key`` is never written, and is not read here (a JAX
key drives another stream of draws).
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

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


def save(path: str, state: ReconstructionState, config=None,
         generator: Optional[torch.Generator] = None) -> None:
    """Write the full resumable state to one compressed npz.

    ``config`` (a ReconstructorConfig) and ``generator`` (the driver's
    random stream) make a resumed run reproduce the interrupted one: same
    thresholds, same draws."""
    data = arrays_of(state)
    meta = {"rng": "torch", "caps": {}}
    if config is not None:
        meta["config"] = {k: v for k, v in vars(config).items()
                          if isinstance(v, (int, float, str, bool, type(None)))}
    if generator is not None:
        meta["rng_device"] = generator.device.type
        data["rng_state_torch"] = generator.get_state().numpy()
    data["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **data)
    os.replace(tmp, path)


def load_meta(path: str) -> dict:
    """Read back the metadata saved alongside the state ({} if none)."""
    with np.load(path, allow_pickle=False) as z:
        if "meta_json" not in z.files:
            return {}
        return json.loads(bytes(z["meta_json"].tobytes()).decode())


def load_rng_state(path: str, device) -> Optional[torch.Tensor]:
    """The saved generator state, for a generator on ``device``; None if
    the file holds none, or one of a generator on another device type (a
    CPU generator's state does not fit a CUDA one)."""
    saved_on = load_meta(path).get("rng_device")
    if saved_on != torch.device(device).type:
        return None
    with np.load(path, allow_pickle=False) as z:
        return torch.from_numpy(np.array(z["rng_state_torch"]))
