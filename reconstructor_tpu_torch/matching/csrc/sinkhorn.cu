// Log-space Sinkhorn on the dust-bin coupling, for Hopper (sm_90a).
//
// Replaces reconstructor_tpu/matching/pallas_sinkhorn.py::_sinkhorn_kernel
// (the Pallas TPU kernel launched by sinkhorn_pallas). Same function, for
// each pair b of a chunk of B pairs, with C the (M1, N1) augmented coupling
// and u, v starting at 0:
//   repeat num_iters times:
//     u = log_mu - LSE_row(C + v^T)
//     v = log_nu - LSE_col(C + u)
//   out = C + u + v^T
// Every logsumexp is stabilised by a maximum and exact (not approximate).
//
// What bounds it on an H100: operations. Each iteration takes one
// exponential per coupling entry that the data needs in each half-step,
// at the special-function units' 16 per clock per SM; the bytes that must
// move are C in and out once, about 20x less time. A pair's loop is a
// long chain of dependent half-steps, so what a design must avoid is
// (a) waiting: on barriers across the card and on re-reading the coupling
// from L2 every half-step, and (b) work the data does not need.
//
// The design: one thread-block cluster per pair, no cooperative launch,
// no grid-wide barrier; clusters never talk to each other, so a chunk
// whose clusters do not all fit at once runs in waves.
// - Masked rows and columns are skipped. A masked row has log_mu = -1e9
//   and (as matching/cuda_sinkhorn.augment builds it) C = -1e9 outside
//   the bin column; a masked column likewise. Their terms in every other
//   row's and column's logsumexp underflow to exactly 0 in float32, so the
//   loop runs over valid rows x valid columns plus the bins only. Each
//   block finds its pair's valid rows and columns from the marginals
//   (above -1e9 / 2, any mask) by a block-wide prefix sum: no pass of its
//   own before the launch.
// - One trap: in the first row half-step v is still 0 on the masked
//   columns, so the bin row's logsumexp has (N - n_valid) terms alpha + 0
//   that are not negligible; they are folded in as a count.
// - The masked rows' u and columns' v are written in closed form after
//   the loop: u_i = log_mu_i - (C[i, bin] + v_bin) with v_bin from before
//   the last column half-step, v_j = log_nu_j - (C[bin, j] + u_bin).
// - The pair's valid rows are split into bands across the cluster's
//   blocks. Each band is held, over the valid columns, in its block's
//   shared memory for the whole loop (rows beyond what shared memory
//   holds are read from device memory by the same code).
// - Row half-step: local to the block, one warp per row. Each logsumexp
//   is one pass, m + log(sum exp(x - m)) with m the row's maximum of the
//   last iteration, which it also updates; m need not be this
//   iteration's maximum, only near it: while the sum stays within
//   [1e-30, 1e30] float32 keeps its relative precision. Otherwise (the
//   first iteration, or a sum out of range) it takes two passes, the
//   maximum first. One pass saves a third of the instructions.
// - Column half-step: each block reduces its band into per-column
//   (m, sum) partials the same way (threads on columns, and on groups of
//   rows where the columns leave threads over) and stores each into the shared
//   memory of the block that owns the column's slice (distributed shared
//   memory: remote stores, no remote loads on the critical path); after a
//   cluster barrier the owner merges its slice and stores the new v into
//   every block's copy; a second cluster barrier ends the half-step. Two
//   cluster barriers an iteration.
// - The cluster size (up to 16, non-portable above 8) is chosen at launch
//   from cudaOccupancyMaxActiveClusters: the fewest waves times the
//   longest band, rows read from device memory counted 3x. At the learned
//   path's chunk that is 16 on an H100 80GB HBM3, which places 7 such
//   clusters at once: 8 pairs take 2 waves (the card's shared memory holds
//   about 7 of these pairs' couplings at once).
// expf, not __expf: the fast intrinsic's error would compound over the
// iterations.
// What bounds this design: an accurate expf is ~8 instructions, one of
// them on the special-function unit, so the FP32 pipes' issue rate, not
// the SFU's 16 a clock, sets the pace of a half-step; each iteration adds
// a fixed chain of two cluster barriers and the merge, whatever the size;
// and where the card places fewer clusters than the chunk has pairs, the
// waves multiply it all.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// shared memory (4-byte words): v, column index, log_nu (N1 each); the
// partials that the cluster's blocks send to this block for its slice of
// the columns, max and sum (N1 + kMaxCluster each); u, row index, log_mu,
// last row max (rb_max each); the row groups' column partials (2 x
// kThreads, also the scan's scratch); the last column maxima (N1 or
// kThreads); then the band's rows x n_c
__host__ __device__ inline long long fixed_words(int N1, int rb_max) {
  return 5LL * N1 + 2LL * kMaxCluster + 4LL * rb_max + 2LL * kThreads +
         (N1 > kThreads ? N1 : kThreads);
}

// exclusive prefix sum of x over the block; `total` gets the sum
__device__ __forceinline__ int block_scan(int x, int* scratch, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = scratch[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? scratch[warp - 1] : 0;
  total = scratch[kWarps - 1];
  __syncthreads();   // scratch free again
  return before + inc - x;
}

// the valid entries of a marginal (above -1e9 / 2; the bin, last, always)
__device__ __forceinline__ bool valid_slot(const float* lm, int i, int n) {
  return i == n - 1 || lm[i] > -5e8f;
}

// compact the valid slots of lm (n entries) in order: slots whose rank
// among the valid ones lies in [lo, hi) go to idx[rank - lo], their
// marginal to val[rank - lo]. Returns the number of valid slots.
__device__ int compact_valid(const float* lm, int n, int* scratch, int lo, int hi, int* idx,
                             float* val, bool count_only) {
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(n, (int)threadIdx.x * per);
  const int i1 = min(n, i0 + per);
  int cnt = 0;
  for (int i = i0; i < i1; ++i) cnt += valid_slot(lm, i, n);
  int total = 0;
  int pos = block_scan(cnt, scratch, total);
  if (!count_only) {
    for (int i = i0; i < i1; ++i) {
      if (!valid_slot(lm, i, n)) continue;
      if (pos >= lo && pos < hi) {
        idx[pos - lo] = i;
        val[pos - lo] = lm[i];
      }
      ++pos;
    }
  }
  return total;
}

// a sum of exp(x - m) in this range keeps float32's relative precision:
// m may then be any value near the maximum, not only the maximum itself
__device__ __forceinline__ bool sum_in_range(float s) { return s >= 1e-30f && s <= 1e30f; }

// (m, sum of exp(x - m)) of x = band[r][c] + u[r] over the band's rows
// first, first + step, ... (< nb): rows below `cached` from shared memory,
// the rest from device memory. One pass with m = `last`, the previous
// iteration's maximum, when that keeps the sum in range; else two passes
// with the maximum. `last` gets this iteration's maximum.
__device__ __forceinline__ void column_lse(const float* tile, int n_c, int c, int first,
                                           int step, int cached, int nb, const float* u_s,
                                           const float* Cb, const int* ridx_s, int N1,
                                           int gcol, float& last, float& m_out,
                                           float& s_out) {
  float m = -INFINITY, s = 0.f;
  const float ml = last;
  if (ml > -INFINITY) {
    int r = first;
#pragma unroll 4
    for (; r < cached; r += step) {
      const float x = tile[(size_t)r * n_c + c] + u_s[r];
      m = fmaxf(m, x);
      s += expf(x - ml);
    }
#pragma unroll 4
    for (; r < nb; r += step) {
      const float x = __ldg(Cb + (size_t)ridx_s[r] * N1 + gcol) + u_s[r];
      m = fmaxf(m, x);
      s += expf(x - ml);
    }
    last = m;
    if (sum_in_range(s)) {
      m_out = ml;
      s_out = s;
      return;
    }
  }
  m = -INFINITY;
  int r = first;
#pragma unroll 4
  for (; r < cached; r += step) m = fmaxf(m, tile[(size_t)r * n_c + c] + u_s[r]);
#pragma unroll 4
  for (; r < nb; r += step) m = fmaxf(m, __ldg(Cb + (size_t)ridx_s[r] * N1 + gcol) + u_s[r]);
  s = 0.f;
  r = first;
#pragma unroll 4
  for (; r < cached; r += step) s += expf(tile[(size_t)r * n_c + c] + u_s[r] - m);
#pragma unroll 4
  for (; r < nb; r += step) s += expf(__ldg(Cb + (size_t)ridx_s[r] * N1 + gcol) + u_s[r] - m);
  last = m;
  m_out = m;
  s_out = s;
}

__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_kernel(const float* __restrict__ C, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, int M1, int N1, int num_iters,
                int smem_words, float* __restrict__ u, float* __restrict__ v,
                float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb_max = (M1 + cs - 1) / cs;

  extern __shared__ float smem[];
  float* v_s = smem;
  int* cidx_s = reinterpret_cast<int*>(v_s + N1);
  float* lnu_s = reinterpret_cast<float*>(cidx_s + N1);
  float* pbm_s = lnu_s + N1;
  float* pbs_s = pbm_s + N1 + kMaxCluster;
  float* u_s = pbs_s + N1 + kMaxCluster;
  int* ridx_s = reinterpret_cast<int*>(u_s + rb_max);
  float* lmu_s = reinterpret_cast<float*>(ridx_s + rb_max);
  float* rlast_s = lmu_s + rb_max;
  float* gm_s = rlast_s + rb_max;
  float* gs_s = gm_s + kThreads;
  float* clast_s = gs_s + kThreads;
  float* tile = smem + fixed_words(N1, rb_max);
  int* scratch = reinterpret_cast<int*>(gm_s);

  const float* lmu = log_mu + (size_t)b * M1;
  const float* lnu = log_nu + (size_t)b * N1;
  const float* Cb = C + (size_t)b * M1 * N1;
  // the pair's valid rows (with the bin row), split into bands; its valid
  // columns (with the bin column), all held by every block
  const int n_r = compact_valid(lmu, M1, scratch, 0, 0, nullptr, nullptr, true);
  const int rb = (n_r + cs - 1) / cs;
  const int r0 = min(n_r, rank * rb);
  const int nb = min(n_r, r0 + rb) - r0;                 // this block's band
  compact_valid(lmu, M1, scratch, r0, r0 + nb, ridx_s, lmu_s, false);
  const int n_c = compact_valid(lnu, N1, scratch, 0, N1, cidx_s, lnu_s, false);
  const long long room = (smem_words - fixed_words(N1, rb_max)) / n_c;
  const int cached = (int)min((long long)nb, room);      // band rows in shared memory
  const int cb = (n_c + cs - 1) / cs;
  const int c0 = min(n_c, rank * cb);
  const int c1 = min(n_c, c0 + cb);                      // columns this block merges
  const bool has_bin_row = nb > 0 && r0 + nb == n_r;
  const int n_masked_cols = N1 - n_c;
  const float alpha = Cb[(size_t)(M1 - 1) * N1 + (N1 - 1)];
  // column half-step: threads on columns, and on groups of rows where the
  // columns leave threads over
  const int ncp = min(kThreads, (n_c + 31) / 32 * 32);
  const int groups = kThreads / ncp;
  const int gi = tid / ncp;
  const int cl = tid - gi * ncp;

  for (int c = tid; c < n_c; c += kThreads) v_s[c] = 0.f;
  for (int c = tid; c < max(N1, kThreads); c += kThreads) clast_s[c] = -INFINITY;
  for (int r = tid; r < nb; r += kThreads) {
    u_s[r] = 0.f;
    rlast_s[r] = -INFINITY;
  }
  __syncthreads();
  for (int r = warp; r < cached; r += kWarps) {
    const float* row = Cb + (size_t)ridx_s[r] * N1;
    float* t = tile + (size_t)r * n_c;
    for (int c = lane; c < n_c; c += 32) t[c] = row[cidx_s[c]];
  }
  cluster.sync();   // every block of the cluster running before any remote store

  // send column c's partial of this band to the block that merges it
  auto send = [&](int c, float m, float s) {
    const int owner = c / cb;
    const int slot = rank * cb + (c - owner * cb);
    cluster.map_shared_rank(pbm_s, owner)[slot] = m;
    cluster.map_shared_rank(pbs_s, owner)[slot] = s;
  };

  float v_bin_prev = 0.f;
  for (int it = 0; it < num_iters; ++it) {
    if (it == num_iters - 1) v_bin_prev = v_s[n_c - 1];

    // u = log_mu - LSE_row(C + v^T), one warp per row of the band
    for (int r = warp; r < nb; r += kWarps) {
      float m = -INFINITY, s = 0.f;
      if (r < cached) {
        // one pass with the row's last maximum when the sum stays in range
        const float* t = tile + (size_t)r * n_c;
        const float ml = rlast_s[r];
        bool one_pass = false;
        if (ml > -INFINITY) {
#pragma unroll 4
          for (int c = lane; c < n_c; c += 32) {
            const float x = t[c] + v_s[c];
            m = fmaxf(m, x);
            s += expf(x - ml);
          }
          m = warp_max(m);
          s = warp_sum(s);
          one_pass = sum_in_range(s);
        }
        if (one_pass) {
          if (lane == 0) rlast_s[r] = m;
          m = ml;
        } else {
          m = -INFINITY;
#pragma unroll 4
          for (int c = lane; c < n_c; c += 32) m = fmaxf(m, t[c] + v_s[c]);
          m = warp_max(m);
          s = 0.f;
#pragma unroll 4
          for (int c = lane; c < n_c; c += 32) s += expf(t[c] + v_s[c] - m);
          s = warp_sum(s);
          if (lane == 0) rlast_s[r] = m;
        }
      } else {
        const float* g = Cb + (size_t)ridx_s[r] * N1;
#pragma unroll 4
        for (int c = lane; c < n_c; c += 32) m = fmaxf(m, __ldg(g + cidx_s[c]) + v_s[c]);
        m = warp_max(m);
#pragma unroll 4
        for (int c = lane; c < n_c; c += 32) s += expf(__ldg(g + cidx_s[c]) + v_s[c] - m);
        s = warp_sum(s);
      }
      if (it == 0 && r0 + r == n_r - 1 && n_masked_cols > 0) {
        // the bin row in the first half-step: the masked columns' alpha + 0
        const float mm = fmaxf(m, alpha);
        s = s * expf(m - mm) + (float)n_masked_cols * expf(alpha - mm);
        m = mm;
      }
      if (lane == 0) u_s[r] = lmu_s[r] - (m + logf(s));
    }
    __syncthreads();

    // this band's (max, sum) partial of every valid column, sent to the
    // column's owner
    if (groups == 1) {
      for (int c = tid; c < n_c; c += kThreads) {
        float m, s;
        column_lse(tile, n_c, c, 0, 1, cached, nb, u_s, Cb, ridx_s, N1, cidx_s[c], clast_s[c],
                   m, s);
        send(c, m, s);
      }
    } else {
      if (gi < groups && cl < n_c)
        column_lse(tile, n_c, cl, gi, groups, cached, nb, u_s, Cb, ridx_s, N1, cidx_s[cl],
                   clast_s[tid], gm_s[tid], gs_s[tid]);
      __syncthreads();
      if (tid < n_c) {
        float m = -INFINITY;
        for (int k = 0; k < groups; ++k) m = fmaxf(m, gm_s[k * ncp + tid]);
        float s = 0.f;
        for (int k = 0; k < groups; ++k)
          if (gs_s[k * ncp + tid] > 0.f) s += gs_s[k * ncp + tid] * expf(gm_s[k * ncp + tid] - m);
        send(tid, m, s);
      }
    }
    cluster.sync();   // every band's partials have reached their owners

    // merge this block's slice of the columns and hand v to every block
    for (int c = c0 + tid; c < c1; c += kThreads) {
      const int l = c - c0;
      float m = -INFINITY;
      for (int k = 0; k < cs; ++k) m = fmaxf(m, pbm_s[k * cb + l]);
      float s = 0.f;
      for (int k = 0; k < cs; ++k) {
        const float os = pbs_s[k * cb + l];
        if (os > 0.f) s = fmaf(os, expf(pbm_s[k * cb + l] - m), s);   // empty bands: (-inf, 0)
      }
      const float vc = lnu_s[c] - (m + logf(s));
      for (int k = 0; k < cs; ++k) cluster.map_shared_rank(v_s, k)[c] = vc;
    }
    cluster.sync();   // v complete in every block; partials consumed
  }

  // u, v of the valid rows and columns; the masked ones in closed form
  for (int r = tid; r < nb; r += kThreads) u[(size_t)b * M1 + ridx_s[r]] = u_s[r];
  for (int c = c0 + tid; c < c1; c += kThreads) v[(size_t)b * N1 + cidx_s[c]] = v_s[c];
  if (has_bin_row) {
    const float u_bin = u_s[nb - 1];
    for (int i = tid; i < M1; i += kThreads)
      if (!valid_slot(lmu, i, M1))
        u[(size_t)b * M1 + i] =
            num_iters == 0 ? 0.f : lmu[i] - (Cb[(size_t)i * N1 + (N1 - 1)] + v_bin_prev);
    for (int j = tid; j < N1; j += kThreads)
      if (!valid_slot(lnu, j, N1))
        v[(size_t)b * N1 + j] =
            num_iters == 0 ? 0.f : lnu[j] - (Cb[(size_t)(M1 - 1) * N1 + j] + u_bin);
  }
  __threadfence();
  cluster.sync();   // u, v in device memory; no block touches another's shared memory after

  // out = C + u + v^T, the pair's rows spread over the cluster
  const float* ub = u + (size_t)b * M1;
  const float* vb = v + (size_t)b * N1;
  float* ob = out + (size_t)b * M1 * N1;
  for (int i = rank; i < M1; i += cs) {
    const float ui = __ldcg(ub + i);
    const float* crow = Cb + (size_t)i * N1;
    float* orow = ob + (size_t)i * N1;
    for (int j = tid; j < N1; j += kThreads) orow[j] = crow[j] + ui + __ldcg(vb + j);
  }
}

cudaLaunchConfig_t make_config(int B, int cs, size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// for cluster size cs: the dynamic shared memory (all of a band at full
// size, up to what a block may have), the band rows it holds, and the
// clusters the device places at once (0: none)
cudaError_t cluster_fit(int B, int M1, int N1, int cs, int max_smem, int* smem, int* cached,
                        int* active) {
  *active = 0;
  const int rb = (M1 + cs - 1) / cs;
  const long long fixed = fixed_words(N1, rb);
  const long long want = fixed + (long long)rb * N1;
  const long long words = want < max_smem / 4 ? want : max_smem / 4;
  if (words < fixed) return cudaSuccess;   // the column state alone does not fit
  *smem = (int)(words * 4);
  *cached = (int)((words - fixed) / N1 < rb ? (words - fixed) / N1 : rb);
  cudaError_t e = cudaFuncSetAttribute(sinkhorn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(B, cs, (size_t)*smem, 0, attr);
  if (cudaOccupancyMaxActiveClusters(active, sinkhorn_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();   // this size cannot be placed
    *active = 0;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Choose the launch for a (B, M1, N1) chunk on `device`: plan[0] cluster
// size, plan[1] dynamic shared memory bytes, plan[2] clusters that fit at
// once, plan[3] band rows a block holds in shared memory at full size
// (M1 rows, N1 columns valid). The cost of a size is its waves times its
// longest band, rows read from device memory counted 3x.
// Returns the CUDA status (0 = success).
int sinkhorn_plan(int B, int M1, int N1, int device, int* plan) {
  if (B <= 0 || M1 <= 0 || N1 <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int max_smem = 0;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(sinkhorn_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  double best_cost = -1.0;
  for (int cs = kMaxCluster; cs >= 1; --cs) {
    int smem = 0, cached = 0, active = 0;
    e = cluster_fit(B, M1, N1, cs, max_smem, &smem, &cached, &active);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) continue;
    const int rb = (M1 + cs - 1) / cs;
    const int waves = (B + active - 1) / active;
    const double cost = (double)waves * ((double)cached + 3.0 * (double)(rb - cached) + 4.0);
    if (best_cost < 0.0 || cost < best_cost) {
      best_cost = cost;
      plan[0] = cs;
      plan[1] = smem;
      plan[2] = active;
      plan[3] = cached;
    }
  }
  return best_cost < 0.0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// couplings (B, M1, N1), log_mu (B, M1), log_nu (B, N1), float32,
// contiguous. u (B, M1) and v (B, N1) are outputs; out (B, M1, N1). cs and smem
// come from sinkhorn_plan. Launches on `stream` of `device` and allocates
// nothing. Returns the CUDA status (0 = success).
int sinkhorn_launch(const float* C, const float* log_mu, const float* log_nu, int B, int M1,
                    int N1, int num_iters, int cs, int smem, float* u, float* v, float* out,
                    int device, void* stream) {
  if (B <= 0 || M1 <= 0 || N1 <= 0 || num_iters < 0) return (int)cudaErrorInvalidValue;
  if (cs < 1 || cs > kMaxCluster || (long long)B * cs > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(sinkhorn_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(B, cs, (size_t)smem, static_cast<cudaStream_t>(stream),
                                       attr);
  const int words = smem / 4;
  e = cudaLaunchKernelEx(&cfg, sinkhorn_kernel, C, log_mu, log_nu, M1, N1, num_iters, words, u,
                         v, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* sinkhorn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
