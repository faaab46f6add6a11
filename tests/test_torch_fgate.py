"""The fundamental gate and the fused match+gate chunk of the PyTorch port against the JAX package, on the CPU.

JAX's counter-based PRNG cannot be reproduced in torch, so every port
sampler takes the raw draws as a tensor. These tests draw them with
``jax.random.randint`` from the very key the JAX function splits
internally; both packages then pick the same minimal sets, and inlier
masks are compared index for index where the problem is well posed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.geometry import fgate as jfgate
from reconstructor_tpu.matching import gated as jgated
from reconstructor_tpu_torch.geometry import cuda_fgate
from reconstructor_tpu_torch.geometry import fgate as tfgate
from reconstructor_tpu_torch.matching import cuda_knn, gated as tgated, knn as tknn

from torch_parity import draws, t, two_view


class TestFundamentalGate:
    def _chunk(self, rng, noise, sizes=(200, 120, 60, 9)):
        B, K = len(sizes), 256
        p1 = np.zeros((B, K, 2), np.float32)
        p2 = np.zeros((B, K, 2), np.float32)
        m = np.zeros((B, K), bool)
        for b in range(B):
            n = sizes[b]
            uv1, uv2, *_ = two_view(rng, n=n, outliers=0.2 + 0.1 * b, noise=noise)
            p1[b, :n], p2[b, :n], m[b, :n] = uv1, uv2, True
        return p1, p2, m

    def _both(self, p1, p2, m, stride, H=128):
        keys = jax.random.split(jax.random.PRNGKey(5), p1.shape[0])
        inl_j = jfgate.filter_pairs_scalarized(keys, jnp.asarray(p1), jnp.asarray(p2),
                                               jnp.asarray(m), num_hypotheses=H,
                                               thresh_px=3.0, stride=stride)
        pos = np.stack([draws(k, (H, 8)) for k in keys])
        inl_t = tfgate.filter_pairs_scalarized(t(p1), t(p2), t(m), H, 3.0, stride, pos=t(pos))
        return np.asarray(inl_j), inl_t.numpy()

    @pytest.mark.parametrize("stride", [1, 4])
    def test_scalarized_gate_inliers_equal(self, stride):
        """Well-posed pairs (0.05 px noise, 60+ matches, <= 40% outliers):
        every clean minimal sample pins F, so both packages pick the same
        winner and classify every slot the same."""
        p1, p2, m = self._chunk(np.random.default_rng(0), noise=0.05, sizes=(200, 120, 60))
        inl_j, inl_t = self._both(p1, p2, m, stride)
        np.testing.assert_array_equal(inl_j, inl_t)
        assert inl_t[0].sum() > 100

    @pytest.mark.parametrize("stride", [1, 4])
    def test_sampson_counts_plain_equals_inline_chain(self, stride):
        """Kernel 7's plain version (and its wrapper, which runs it for CPU
        tensors) counts exactly what the two lines it replaced in
        ``filter_pairs_scalarized`` counted: hypotheses solved from the
        gate's own minimal samples plus F = 0 and an F holding a NaN,
        masks with holes that are not a prefix, one pair all masked."""
        rng = np.random.default_rng(3)
        p1, p2, m = self._chunk(rng, noise=0.4, sizes=(200, 120, 60, 9))
        m[:, 5:40:3] = False
        m[3] = False
        B, K, H = p1.shape[0], p1.shape[1], 64
        P1, P2, M = t(p1), t(p2), t(m)
        idx = torch.from_numpy(rng.integers(0, 60, (B, H, 8)))
        hx1, hy1 = (torch.gather(P1[..., c], 1, idx.reshape(B, -1)).reshape(B, H, 8)
                    for c in (0, 1))
        hx2, hy2 = (torch.gather(P2[..., c], 1, idx.reshape(B, -1)).reshape(B, H, 8)
                    for c in (0, 1))
        f = tfgate._solve_f9(hx1, hy1, hx2, hy2, torch.ones_like(hx1), 8.0)
        f[:, 0] = 0.0
        f[:, 1, 4] = float("nan")
        thr = 3.0 * 3.0
        # the chain as filter_pairs_scalarized ran it inline
        x1f, y1f = P1[..., 0], P1[..., 1]
        x2f, y2f = P2[..., 0], P2[..., 1]
        xs1, ys1 = x1f[:, ::stride], y1f[:, ::stride]
        xs2, ys2 = x2f[:, ::stride], y2f[:, ::stride]
        ms = M[:, ::stride]
        d = cuda_fgate.sampson9(f, xs1[:, None], ys1[:, None], xs2[:, None], ys2[:, None])
        inline = torch.sum((d < thr) & ms[:, None, :], dim=-1)
        plain = cuda_fgate.sampson_counts_plain(f, P1, P2, M, stride, thr)
        wrapped = cuda_fgate.sampson_counts(f, P1, P2, M, stride, thr)
        assert plain.dtype == inline.dtype == torch.int64 and plain.shape == (B, H)
        np.testing.assert_array_equal(plain.numpy(), inline.numpy())
        np.testing.assert_array_equal(wrapped.numpy(), inline.numpy())
        S = len(range(0, K, stride))
        assert (plain[:3, 0] == ms[:3].sum(1)).all() and (plain[:, 1] == 0).all()
        assert (plain[3] == 0).all() and plain[0].max() > S // 8

    def test_scalarized_gate_noisy_agrees(self):
        """0.4 px noise and up to 50% outliers: a minimal sample that is
        nearly degenerate leaves two 9x9 eigenvalues close, and inverse
        iteration then amplifies float32 rounding differences between XLA
        (which fuses and contracts ops) and torch into a different F for
        the same sample. The 9-match pair is degenerate outright (any 8 of
        its points, outliers included, fit an F exactly). Same draws still
        give the same gate on >= 97% of match slots, and inlier counts
        within 4 per pair."""
        p1, p2, m = self._chunk(np.random.default_rng(0), noise=0.4)
        inl_j, inl_t = self._both(p1, p2, m, stride=1)
        assert (inl_j == inl_t)[m].mean() >= 0.97
        assert np.abs(inl_j.sum(1) - inl_t.sum(1)).max() <= 4


class TestGatedMatching:
    def test_match_and_gate_equal(self):
        """kNN + F-gate for one pair chunk: the port's chunk body on the
        plain matcher against the JAX XLA path, same draws."""
        rng = np.random.default_rng(2)
        N, K, D = 3, 256, 128
        uv1, uv2, *_ = two_view(rng, n=180, outliers=0.0)
        base = rng.standard_normal((180, D)).astype(np.float32)
        desc = np.zeros((N, K, D), np.float32)
        xy = np.zeros((N, K, 2), np.float32)
        mask = np.zeros((N, K), bool)
        for n, uv in enumerate((uv1, uv2, uv1[::-1])):
            d = base + 0.2 * rng.standard_normal(base.shape).astype(np.float32)
            if n == 2:
                d = d[::-1]
            desc[n, :180] = d / np.linalg.norm(d, axis=1, keepdims=True)
            xy[n, :180] = uv
            mask[n, :180] = True
        chunk = np.array([[0, 1], [0, 2], [1, 2], [0, 0]], np.int32)
        H = 64
        keys = jax.random.split(jax.random.PRNGKey(3), 4)
        mi_j, cnt_j = jgated.match_and_gate_jit(
            keys, jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(xy), jnp.asarray(chunk),
            ratio_thresh=0.7, cross_check=True, use_fused=False, num_hypotheses=H,
            thresh_px=3.0, min_matches=7)
        pos = np.stack([draws(k, (H, 8)) for k in keys])
        mi_t, cnt_t = tgated.match_and_gate(
            t(desc), t(mask), t(xy), t(chunk), ratio_thresh=0.7, cross_check=True,
            num_hypotheses=H, thresh_px=3.0, min_matches=7, pos=t(pos))
        np.testing.assert_array_equal(np.asarray(mi_j), mi_t.numpy())
        np.testing.assert_array_equal(np.asarray(cnt_j), cnt_t.numpy())
        # the fused (kernel-module) matcher gives the plain matcher's tables here
        for a, b in zip(cuda_knn.match_all_pairs_fused(t(desc), t(mask), t(chunk)),
                        tknn.match_all_pairs(t(desc), t(mask), t(chunk))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
