"""Fixed-budget batched RANSAC.

The reference leans on OpenCV's sequential RANSAC loops
(``cv::findFundamentalMat`` GeometricFilter.cpp:47, ``cv::findEssentialMat``
GeometricFilter.cpp:26, ``cv::solvePnPRansac``
SequentialReconstructor.cpp:591) whose iteration counts adapt at runtime.
Here a *fixed batch* of hypotheses is evaluated in one shot:

1. sample H minimal sets at once (valid indices compacted first, uniform
   draws below the valid count),
2. run the minimal solver batched over all H samples,
3. score every hypothesis against every correspondence with one (H, N)
   residual evaluation,
4. argmax inlier count.

Randomness: torch cannot reproduce JAX's counter-based PRNG, so every
sampler takes an optional tensor of raw draws ``pos`` (non-negative
int32 values, reduced modulo the valid count exactly as
``reconstructor_tpu.geometry.ransac.sample_minimal_sets`` reduces
``jax.random.randint``'s output). Without it the draws come from a
``torch.Generator``. Fed the JAX draws, the port picks the same minimal
sets as the reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

INT32_MAX = 2 ** 31 - 1


def raw_draws(shape, device: torch.device,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform int32 draws in [0, 2^31 - 1), the range the JAX sampler uses."""
    return torch.randint(0, INT32_MAX, shape, generator=generator,
                         device=device, dtype=torch.int64).to(torch.int32)


def sample_minimal_sets(mask: torch.Tensor, num_hypotheses: int,
                        sample_size: int,
                        generator: Optional[torch.Generator] = None,
                        pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw (H, S) index sets of valid (masked-in) points.

    Valid indices are compacted to the front once (a stable argsort), then
    each hypothesis takes S uniform positions below the valid count.
    Duplicates inside a sample merely yield a rank-deficient model that
    scores no inliers.
    """
    mask = mask.bool()
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    n_valid = torch.clamp(mask.sum(), min=1).to(torch.int64)
    if pos is None:
        pos = raw_draws((num_hypotheses, sample_size), mask.device, generator)
    return order[pos.to(torch.int64) % n_valid]


def ransac(data: Tuple[torch.Tensor, ...],
           mask: torch.Tensor,
           solver: Callable[..., torch.Tensor],
           residual: Callable[..., torch.Tensor],
           sample_size: int,
           num_hypotheses: int,
           inlier_thresh: float,
           generator: Optional[torch.Generator] = None,
           pos: Optional[torch.Tensor] = None):
    """Generic batched RANSAC.

    data: per-correspondence tensors, each (N, ...); mask: (N,).
    solver: sampled data, each (H, S, ...) -> models (H, ...).
    residual: (models (H, ...), *data) -> (H, N).

    Returns (best_model, inlier_mask (N,), best_count).
    """
    idx = sample_minimal_sets(mask, num_hypotheses, sample_size, generator, pos)
    sampled = tuple(d[idx] for d in data)
    models = solver(*sampled)
    res = residual(models, *data)
    inliers = (res < inlier_thresh) & mask[None, :]
    counts = torch.sum(inliers, dim=-1)
    best = torch.argmax(counts)
    return models[best], inliers[best], counts[best]
