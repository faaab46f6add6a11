"""reconstructor_tpu_torch — the incremental Structure-from-Motion engine
in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

A second implementation of ``reconstructor_tpu`` (JAX/XLA/Pallas for a
TPU), with the same sub-package layout and module names. It imports torch,
numpy, scipy and the standard library only: no JAX and nothing of
``reconstructor_tpu``, so it runs on a machine that has neither.

- ``geometry``  — SE(3), pinhole camera, triangulation, RANSAC, the
                  fundamental gate, epipolar pose, P3P/PnP.
- ``features``  — the DoG/SIFT-style detector, batched.
- ``matching``  — exact top-2 kNN: the plain version and the CUDA kernel
                  (``matching/cuda_knn.py``, ``matching/csrc/knn_top2.cu``;
                  the packed-int32 variant ``csrc/knn_packed.cu``; their
                  shared bf16 product ``csrc/knn_wgmma.cuh``).
- ``ba``        — Levenberg-Marquardt bundle adjustment, dense Schur.
- ``pipeline``  — the incremental reconstruction loop.
- ``io``        — image reading/resizing (native libjpeg or PIL), PLY export.
- ``eval``      — scene rendering and trajectory error.
- ``utils``     — device choice, kernel builds, timing, torch.profiler hooks.
- ``scripts``   — profiling entry points: the kNN kernel's cost split by
                  level (``scripts/csrc/knn_levels.cu``), the packed kernel
                  against the float one, the incremental loop by stage.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# Geometry (RANSAC, DLT, Schur solves) needs true float32 products: TF32
# keeps about three decimal digits and silently destroys pose accuracy.
# matmuls already default to full float32; convolutions through cuDNN do
# not, so both switches are pinned.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from reconstructor_tpu_torch.config import ReconstructorConfig  # noqa: E402

__version__ = "0.1.0"


def __getattr__(name):
    if name == "IncrementalReconstructor":
        from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
        return IncrementalReconstructor
    raise AttributeError(name)


__all__ = ["ReconstructorConfig", "IncrementalReconstructor", "__version__"]
