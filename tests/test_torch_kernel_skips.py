"""The skipping arithmetic of the port's CUDA kernels, on the CPU.

The Sinkhorn kernel (``matching/csrc/sinkhorn.cu``) loops over each pair's
valid rows and columns only, folds the masked columns of the first row
half-step into the bin row as a count, and writes the masked rows' u and
columns' v in closed form. The bf16 kNN kernel (``matching/csrc/knn_top2.cu``)
and its packed-int32 variant (``matching/csrc/knn_packed.cu``) compute the
column tiles of image j below its extent only and give the masked columns
past it in closed form; the packed one also starts its column accumulator
at ``_DMAX << 12`` and builds no column keys in warps whose 16 rows are
all masked. No kernel runs here, so each test drives a plain-PyTorch
emulation of the kernel's skipped loop, built on the wrapper's own plan
helpers (``cuda_sinkhorn.skip_plan``, ``cuda_knn.column_extents``), and
holds it against the plain version and the JAX package. Last, the build
(``utils/cuda_build.py``) names each library by a hash that covers the
headers its source includes, so an edit to the kNN kernels' shared
``knn_wgmma.cuh`` rebuilds all three; that is checked without nvcc.

Tolerances: float32 throughout. The Sinkhorn emulation sums its
logsumexps in bands and merges them, as the kernel's cluster does, so it
agrees with the plain loop, the JAX loop and the Pallas kernel (interpret
mode) to 1e-4 absolute, the bound the TPU package holds between its
kernel and its XLA loop. The kNN emulations compute every distance they
keep with the plain version's product, so rows and colarg are bit-equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconstructor_tpu.matching import pallas_knn, pallas_sinkhorn
from reconstructor_tpu.matching import superglue as jsg
from reconstructor_tpu_torch.matching import cuda_knn, cuda_sinkhorn
from reconstructor_tpu_torch.utils import cuda_build

from torch_parity import t

# ----------------------------------------------------------------------
# Sinkhorn
# ----------------------------------------------------------------------


def lse_partial(x, dim, last):
    """The kernel's (m, sum of exp(x - m)) along ``dim``: one pass with m =
    ``last`` (the previous iteration's maxima) where that keeps the sum
    in [1e-30, 1e30], else two passes with the maximum. Returns (m, sum,
    this iteration's maxima); an empty slice gives (-inf, 0), as an empty
    band does in the kernel."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.full(shape, -float("inf")), torch.zeros(shape), last
    m = x.amax(dim)
    s = torch.exp(x - m.unsqueeze(dim)).sum(dim)
    s_last = torch.exp(x - last.unsqueeze(dim)).sum(dim)
    one_pass = torch.isfinite(last) & (s_last >= 1e-30) & (s_last <= 1e30)
    return torch.where(one_pass, last, m), torch.where(one_pass, s_last, s), m


def merge_partials(parts):
    """The kernel's merge of per-band (max, sum) partials, skipping empty
    bands."""
    m = torch.full_like(parts[0][0], -float("inf"))
    s = torch.zeros_like(parts[0][1])
    for om, os in parts:
        keep = os != 0
        up = keep & (om > m)
        s_up = s * torch.exp(m - om) + os
        s_dn = os * torch.exp(om - m) + s
        s = torch.where(up, s_up, torch.where(keep, s_dn, s))
        m = torch.where(up, om, m)
    return m, s


def sinkhorn_emulated(C, log_mu, log_nu, num_iters, bands=3, bin_term=True):
    """The kernel's loop on one chunk: valid rows x valid columns (with the
    bins) from ``skip_plan``, rows split into ``bands`` bands whose column
    partials are merged, each logsumexp in one pass from the last
    iteration's maxima where it can, the first row half-step's masked columns folded
    into the bin row as a count (unless ``bin_term`` is False), and the
    masked rows' u and columns' v in closed form."""
    B, M1, N1 = C.shape
    rows_idx, n_rows, cols_idx, n_cols = cuda_sinkhorn.skip_plan(log_mu, log_nu)
    out = torch.empty_like(C)
    for b in range(B):
        nr, nc = int(n_rows[b]), int(n_cols[b])
        R, Cc = rows_idx[b, :nr].long(), cols_idx[b, :nc].long()
        sub = C[b][R][:, Cc]
        mu, nu = log_mu[b, R], log_nu[b, Cc]
        alpha = C[b, M1 - 1, N1 - 1]
        n_masked = N1 - nc
        rb = -(-nr // bands)
        u = torch.zeros(nr)
        v = torch.zeros(nc)
        v_bin_prev = torch.tensor(0.0)
        row_last = torch.full((nr,), -float("inf"))
        col_last = [torch.full((nc,), -float("inf")) for _ in range(bands)]
        for it in range(num_iters):
            if it == num_iters - 1:
                v_bin_prev = v[-1].clone()
            m, s, row_last = lse_partial(sub + v[None, :], 1, row_last)
            if it == 0 and n_masked > 0 and bin_term:
                mm = torch.maximum(m[-1], alpha)
                s[-1] = s[-1] * torch.exp(m[-1] - mm) + n_masked * torch.exp(alpha - mm)
                m[-1] = mm
            u = mu - (m + torch.log(s))
            parts = []
            for k in range(bands):
                pm, ps, col_last[k] = lse_partial(
                    sub[k * rb:(k + 1) * rb] + u[k * rb:(k + 1) * rb, None], 0, col_last[k])
                parts.append((pm, ps))
            m, s = merge_partials(parts)
            v = nu - (m + torch.log(s))
        uf = torch.zeros(M1)
        vf = torch.zeros(N1)
        uf[R], vf[Cc] = u, v
        if num_iters > 0:
            Rm, Cm = rows_idx[b, nr:].long(), cols_idx[b, nc:].long()
            uf[Rm] = log_mu[b, Rm] - (C[b, Rm, N1 - 1] + v_bin_prev)
            vf[Cm] = log_nu[b, Cm] - (C[b, M1 - 1, Cm] + u[-1])
        out[b] = C[b] + uf[:, None] + vf[None, :]
    return out


def sinkhorn_case(name):
    """(scores (B, M, N), mask0, mask1, alpha, iters) as numpy."""
    rng = np.random.default_rng(len(name))
    B, M, N = 4, 40, 56
    scores = (2 * rng.standard_normal((B, M, N))).astype(np.float32)
    m0 = np.ones((B, M), bool)
    m1 = np.ones((B, N), bool)
    iters = 30
    if name == "non_prefix_masks":
        m0 = rng.uniform(size=(B, M)) < 0.7
        m1 = rng.uniform(size=(B, N)) < 0.6
        m0[:, -1] = False                  # a masked last slot
    elif name == "fully_masked_image":
        m0[1] = False                      # rows with no valid column partner
        m1[2] = False                      # rows with 0 valid columns
        m1[0, 10:30] = False
    elif name == "single_valid_slot":
        m0[0] = False
        m0[0, 17] = True                   # one valid row, not the first
        m1[1] = False
        m1[1, 9] = True                    # rows with 1 valid column
        m1[3, 50:] = False
    elif name == "one_iteration":
        # the masked rows' and columns' closed forms after a single
        # iteration, with v still 0 in the first row half-step
        m0 = rng.uniform(size=(B, M)) < 0.6
        m1 = rng.uniform(size=(B, N)) < 0.5
        iters = 1
    elif name == "slow_first_iteration":
        # few iterations on a pair with many masked columns: the first row
        # half-step's bin-row term has not been damped away
        scores = (4 * rng.standard_normal((B, M, N))).astype(np.float32)
        m1[:, 8:] = False
        m1[:, 20:24] = True
        iters = 3
    return scores, m0, m1, np.float32(0.7), iters


SINKHORN_CASES = ["non_prefix_masks", "fully_masked_image", "single_valid_slot",
                  "one_iteration", "slow_first_iteration"]


def _emulated_and_valid(name, **kw):
    scores, m0, m1, alpha, iters = sinkhorn_case(name)
    C, mu, nu, norm = cuda_sinkhorn.augment(t(scores), t(alpha), t(m0), t(m1))
    z = sinkhorn_emulated(C, mu, nu, iters, **kw)
    ones = np.ones((m0.shape[0], 1), bool)
    valid = (np.concatenate([m0, ones], 1)[:, :, None]
             & np.concatenate([m1, ones], 1)[:, None, :])
    return scores, m0, m1, alpha, iters, (z - norm[:, None, None]).numpy(), valid, (C, mu, nu)


@pytest.mark.parametrize("reference", ["plain", "jax_loop", "pallas_interpret"])
@pytest.mark.parametrize("name", SINKHORN_CASES)
def test_sinkhorn_skips_equal_references(name, reference):
    scores, m0, m1, alpha, iters, got, valid, (C, mu, nu) = _emulated_and_valid(name)
    if reference == "plain":
        _, _, _, norm = cuda_sinkhorn.augment(t(scores), t(alpha), t(m0), t(m1))
        want = (cuda_sinkhorn.sinkhorn_plain(C, mu, nu, iters) - norm[:, None, None]).numpy()
    else:
        fn = (jsg.log_sinkhorn if reference == "jax_loop"
              else lambda *a: pallas_sinkhorn.log_sinkhorn_fused(*a, interpret=True))
        want = np.stack([np.asarray(fn(jnp.asarray(scores[b]), jnp.asarray(alpha),
                                       jnp.asarray(m0[b]), jnp.asarray(m1[b]), iters))
                         for b in range(scores.shape[0])])
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4, rtol=0)
    assert (got[~valid] <= -1e8).all() and (want[~valid] <= -1e8).all()


@pytest.mark.parametrize("bands", [1, 16])
def test_sinkhorn_band_count_does_not_matter(bands):
    """More bands than valid rows leaves empty bands, whose (-inf, 0)
    partials the merge skips; one band is the unsplit loop."""
    _, _, _, _, _, got, valid, (C, mu, nu) = _emulated_and_valid("single_valid_slot",
                                                                    bands=bands)
    _, _, _, _, _, ref, _, _ = _emulated_and_valid("single_valid_slot")
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=0)


def test_sinkhorn_needs_the_first_iteration_bin_row_term():
    """Without the masked columns' alpha + 0 terms in the first row
    half-step's bin row, a slowly converging pair comes out far off the
    plain loop; with them it agrees to 1e-4."""
    scores, m0, m1, alpha, iters, with_term, valid, (C, mu, nu) = \
        _emulated_and_valid("slow_first_iteration")
    *_, without, _, _ = _emulated_and_valid("slow_first_iteration", bin_term=False)
    _, _, _, norm = cuda_sinkhorn.augment(t(scores), t(alpha), t(m0), t(m1))
    want = (cuda_sinkhorn.sinkhorn_plain(C, mu, nu, iters) - norm[:, None, None]).numpy()
    assert np.abs(with_term - want)[valid].max() <= 1e-4
    assert np.abs(without - want)[valid].max() > 1e-3


@pytest.mark.parametrize("name", SINKHORN_CASES)
def test_sinkhorn_skip_plan_lists(name):
    """Valid rows first in order, the bin last among them, then the masked
    rows; the counts include the bins. Columns likewise."""
    scores, m0, m1, alpha, _ = sinkhorn_case(name)
    _, mu, nu, _ = cuda_sinkhorn.augment(t(scores), t(alpha), t(m0), t(m1))
    rows_idx, n_rows, cols_idx, n_cols = cuda_sinkhorn.skip_plan(mu, nu)
    for b in range(scores.shape[0]):
        for mask, idx, n in ((m0[b], rows_idx[b], n_rows[b]), (m1[b], cols_idx[b], n_cols[b])):
            valid = np.flatnonzero(np.append(mask, True))
            masked = np.flatnonzero(~mask)
            assert int(n) == len(valid)
            np.testing.assert_array_equal(idx.numpy(), np.concatenate([valid, masked]))


# ----------------------------------------------------------------------
# top-2 kNN
# ----------------------------------------------------------------------

_BIG = 1e30


def knn_emulated(desc, bias, pair_idx, tile):
    """The bf16 kernel's skipped loop: per pair, the column tiles below
    image j's extent (``column_extents``) are computed (with the plain
    version's product, so every kept distance is the same float); the
    columns past the last computed tile give the row one candidate
    (1e30, first skipped column), a second 1e30 when they are more than
    one, and nothing to colarg."""
    K = desc.shape[1]
    ext = cuda_knn.column_extents(bias)
    outs = []
    for i, j in pair_idx.long().tolist():
        sim = desc[i].float() @ desc[j].float().T
        dist = torch.clamp(2.0 - 2.0 * sim, min=0.0) + bias[j][None, :]
        cs = min(K, -(-int(ext[j]) // tile) * tile)       # first skipped column
        d = dist[:, :cs]
        if cs > 0:
            best, arg = torch.min(d, dim=1)
            second = torch.where(torch.arange(cs) == arg[:, None], float("inf"), d).amin(1)
        else:
            best = torch.full((K,), float("inf"))
            second = best.clone()
            arg = torch.zeros(K, dtype=torch.int64)
        if cs < K:   # the skipped region's candidate, pushed after the computed ones
            take = _BIG < best
            second = torch.where(take, best, torch.minimum(second, torch.tensor(_BIG)))
            arg = torch.where(take, torch.tensor(cs), arg)
            best = torch.where(take, torch.tensor(_BIG), best)
            if K - cs > 1:
                second = torch.minimum(second, torch.tensor(_BIG))
        colarg = torch.zeros(K, dtype=torch.int64)
        if cs > 0:
            dc = d + bias[i][:, None]
            cmin, carg = torch.min(dc, dim=0)
            colarg[:cs] = torch.where(cmin < _BIG, carg, 0)
        outs.append((best, second, arg.to(torch.int32), colarg.to(torch.int32)))
    return tuple(torch.stack(o) for o in zip(*outs))


def knn_case():
    """Six images of 256 slots: 200, 1, 0, 70 and 129 valid prefixes and a
    non-prefix mask with holes (extents that are not a tile multiple, a
    fully masked image, a single valid slot)."""
    rng = np.random.default_rng(21)
    K, D = 256, 128
    desc = rng.standard_normal((6, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.zeros((6, K), bool)
    for n, count in enumerate((200, 1, 0, 70, 129)):
        mask[n, :count] = True
    mask[5, :150] = True
    mask[5, 40:90] = False                      # a hole
    mask[5, 200] = True                         # a lone valid slot past it
    desc[1, 0] = desc[0, 5]
    pairs = np.array([[0, 1], [1, 0], [0, 2], [2, 0], [3, 4], [4, 3], [5, 0], [0, 5],
                      [1, 2], [5, 5]], np.int32)
    return desc, mask, pairs


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("reference", ["plain", "pallas_interpret"])
def test_knn_tile_skips_equal_references(tile, reference):
    desc, mask, pairs = knn_case()
    bias = np.where(mask, 0.0, _BIG).astype(np.float32)
    got = knn_emulated(t(desc), t(bias), t(pairs), tile)
    if reference == "plain":
        want = cuda_knn.knn_topk2_plain(t(desc), t(bias), t(pairs))
    else:
        want = pallas_knn._knn_topk2(jnp.asarray(desc), jnp.asarray(bias), jnp.asarray(pairs),
                                     interpret=True, packed=False)
    for a, b, what in zip(got, want, ("best", "second", "arg", "colarg")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


def test_knn_column_extents():
    """Last valid slot + 1 for any mask, 0 for a fully masked image."""
    _, mask, _ = knn_case()
    bias = np.where(mask, 0.0, _BIG).astype(np.float32)
    ext = cuda_knn.column_extents(t(bias)).numpy()
    np.testing.assert_array_equal(ext, [200, 1, 0, 70, 129, 201])
    assert ext.dtype == np.int32


# ----------------------------------------------------------------------
# packed-int32 top-2 kNN
# ----------------------------------------------------------------------

_DMAX = cuda_knn._DMAX
_INT_MAX = 2**31 - 1


def packed_emulated(desc, bias, pair_idx, tile, live_warps_only=True, start=_DMAX << 12):
    """The bf16 packed kernel's skipped loop, per pair: the column tiles
    below image j's extent (``column_extents`` with the int32 rule) are
    computed (with the plain version's product, so every key is the
    same), each folded into the row's two smallest keys as the kernel's
    quad merge does; the columns past the last computed tile give the row
    the keys (DMAX << 12) | cs and (DMAX << 12) | (cs + 1); the column
    accumulator starts at ``start`` and takes, per computed tile, the
    column keys of the 16-row warps with a valid row only
    (``live_warps_only``)."""
    N, K, _ = desc.shape
    ext = cuda_knn.column_extents(bias, valid_below=_DMAX)
    live = (bias < _DMAX).view(N, K // 16, 16).any(2)
    if not live_warps_only:
        live = torch.ones_like(live)
    cols = torch.arange(K, dtype=torch.int32)
    outs = []
    for i, j in pair_idx.long().tolist():
        sim = desc[i].float() @ desc[j].float().T
        di = torch.clamp((2.0 - 2.0 * sim) * cuda_knn._SCALE, 0.0, float(_DMAX - 1))
        di = torch.maximum(di.to(torch.int32), bias[j][None, :])
        cs = min(K, -(-int(ext[j]) // tile) * tile)      # first skipped column
        best = torch.full((K,), _INT_MAX, dtype=torch.int32)
        second = best.clone()
        colacc = torch.full((K,), start, dtype=torch.int32)
        for c0 in range(0, cs, tile):
            d = di[:, c0:c0 + tile]
            keys = (d << 12) | cols[c0:c0 + tile]
            tb = keys.amin(1)
            ts = torch.where(keys == tb[:, None], _INT_MAX, keys).amin(1)
            second = torch.minimum(torch.minimum(second, ts), torch.maximum(best, tb))
            best = torch.minimum(best, tb)
            ck = (torch.maximum(d, bias[i][:, None]) << 12) | cols[:, None]
            ck = ck.view(K // 16, 16, -1)[live[i]]
            if ck.shape[0]:
                colacc[c0:c0 + tile] = torch.minimum(colacc[c0:c0 + tile], ck.amin(1).amin(0))
        for c in range(cs, min(cs + 2, K)):      # the skipped region's two smallest keys
            key = torch.tensor((_DMAX << 12) | c, dtype=torch.int32)
            second = torch.minimum(second, torch.maximum(best, key))
            best = torch.minimum(best, key)

        def value(k):
            v = (k >> 12).to(torch.float32) * (1.0 / cuda_knn._SCALE)
            return torch.where(k >= (_DMAX << 12), _BIG, v)
        outs.append((value(best), value(second), best & 4095, colacc & 4095))
    return tuple(torch.stack(o) for o in zip(*outs))


@functools.lru_cache(maxsize=None)
def packed_reference(reference):
    desc, mask, pairs = knn_case()
    bias = np.where(mask, 0, _DMAX).astype(np.int32)
    if reference == "plain":
        out = cuda_knn.knn_topk2_packed_plain(t(desc), t(bias), t(pairs))
    else:
        out = pallas_knn._knn_topk2(jnp.asarray(desc), jnp.asarray(bias), jnp.asarray(pairs),
                                    interpret=True, packed=True)
    return [np.asarray(x) for x in out]


def packed_case():
    desc, mask, pairs = knn_case()
    return t(desc), t(np.where(mask, 0, _DMAX).astype(np.int32)), t(pairs)


@pytest.mark.parametrize("warps", ["live only", "all"])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("reference", ["plain", "pallas_interpret"])
def test_packed_tile_skips_equal_references(tile, reference, warps):
    """Skipping the tiles past the extent, starting the accumulator at
    DMAX << 12 and leaving out the masked warps' column keys are each
    exact: bit-equal to the plain version and the Pallas kernel, on
    prefixes, a hole with a lone slot past it, an empty image and a
    self-pair; the masked warps' keys, when built, change nothing."""
    got = packed_emulated(*packed_case(), tile, live_warps_only=warps == "live only")
    want = packed_reference(reference)
    for a, b, what in zip(got, want, ("best", "second", "arg", "colarg")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


def test_packed_needs_the_dmax_accumulator_start():
    """Started at INT32_MAX, as the unskipped kernel may, the accumulator
    of a skipped column would read slot 4095; the references give row 0,
    which DMAX << 12 gives without any work."""
    desc, bias, pairs = packed_case()
    _, _, _, colarg = packed_emulated(desc, bias, pairs, 128, start=_INT_MAX)
    want = packed_reference("plain")[3]
    assert (colarg.numpy() != want).any()
    assert set(colarg.numpy()[colarg.numpy() != want].tolist()) == {4095}
    assert (want[colarg.numpy() != want] == 0).all()


# ----------------------------------------------------------------------
# the build hash covers included headers
# ----------------------------------------------------------------------


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A source's library name hashes the source and every file it reaches
    through quoted includes, resolved from the including file's directory
    (as nvcc does); system includes and unrelated files do not count."""
    monkeypatch.setenv("RECONSTRUCTOR_TORCH_BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "csrc").mkdir()
    (tmp_path / "common").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    hdr = tmp_path / "common" / "shared.cuh"
    deep = tmp_path / "common" / "deeper.cuh"
    other = tmp_path / "common" / "other.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "../common/shared.cuh"\n'
                   '__global__ void k() {}\n')
    hdr.write_text('#pragma once\n  #  include "deeper.cuh"\n// #include "other.cuh"\n')
    deep.write_text("constexpr int kX = 1;\n")
    other.write_text("constexpr int kY = 1;\n")
    assert cuda_build.sources(src) == [src.resolve(), hdr.resolve(), deep.resolve()]
    first = cuda_build.library_path(src)
    assert first.parent == tmp_path / "build" and first.name.startswith("libk_")
    other.write_text("constexpr int kY = 2;\n")
    assert cuda_build.library_path(src) == first
    deep.write_text("constexpr int kX = 2;\n")
    second = cuda_build.library_path(src)
    assert second != first
    hdr.write_text('#pragma once\n#include "deeper.cuh"\n')
    assert cuda_build.library_path(src) not in (first, second)


@pytest.mark.parametrize("source", ["matching/csrc/knn_top2.cu", "matching/csrc/knn_packed.cu",
                                    "scripts/csrc/knn_levels.cu"])
def test_knn_kernels_hash_their_shared_header(source):
    """The three kNN kernel sources reach the shared product header
    (``knn_levels.cu`` by a relative path from ``scripts/csrc``)."""
    pkg = cuda_build._PKG
    found = cuda_build.sources(pkg / source)
    assert found[0] == (pkg / source).resolve()
    assert (pkg / "matching" / "csrc" / "knn_wgmma.cuh").resolve() in found
