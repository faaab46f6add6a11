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
// Every logsumexp is max-stabilised and exact (not approximate).
//
// What bounds it on an H100: operations. Each iteration takes one
// exponential per coupling entry in each half-step, 2 * num_iters * B *
// M1 * N1 in all (1.68e9 at K = 1024, B = 8, 100 iterations), at the SFU's
// 16 per clock per SM; the bytes that must move are only C in and out
// once (67 MB at that shape), about 20x less time. On the TPU the whole
// coupling sat in VMEM (4.2 MB a pair at K = 1024). An SM has 227 KB of
// shared memory, so here the chunk's coupling stays in device memory
// (33.6 MB at K = 1024, B = 8), where it is resident in the 50 MB L2
// after the first sweep, and the design is one persistent cooperative
// launch per chunk:
// - every block of the grid (sized from the occupancy calculator so that
//   all blocks are co-resident) takes part in every half-step; the grid
//   synchronises between half-steps (cooperative_groups grid sync);
// - row half-step: one warp per row of every pair, lanes on neighbouring
//   columns (coalesced), then a warp-shuffle merge;
// - column half-step: a block per 32-column tile of one pair, lanes on
//   the tile's columns and warps on interleaved rows, so each warp reads
//   128 contiguous bytes per row; the warps' partials merge in shared
//   memory;
// - u and v live in device memory (a few KB, L1/L2 resident).
// Each logsumexp is a one-pass online one: a running maximum and a sum
// rescaled when the maximum grows, one expf per element (select between
// "rescale the sum" and "add a term", both from exp(-|x - m|)). It equals
// the reference's two-pass max-then-sum up to float32 rounding. expf,
// not __expf: the fast intrinsic's error would compound over the
// iterations. Speed (fewer grid syncs, wider tiles, keeping a pair's
// rows in shared memory across a cluster) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// fold x into the running (max m, sum s of exp(. - m)); m starts at -inf
// and s at 0; x is finite (masked entries carry -1e9, not -inf)
__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
  const float d = x - m;
  const float e = expf(-fabsf(d));
  const bool up = d > 0.f;
  s = up ? fmaf(s, e, 1.f) : s + e;
  m = up ? x : m;
}

// merge a partial (om, os) into (m, s); an empty partial has m = -inf, s = 0
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  if (om > m) {
    s = fmaf(s, expf(m - om), os);
    m = om;
  } else if (os > 0.f) {
    s = fmaf(os, expf(om - m), s);
  }
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ C, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, int B, int M1, int N1,
                int num_iters, float* __restrict__ u, float* __restrict__ v,
                float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float part_m[kWarps][32];
  __shared__ float part_s[kWarps][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gthread = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const int rows = B * M1;
  const int cols = B * N1;
  const int ntile = (N1 + 31) / 32;

  for (long long e = gthread; e < rows; e += nthreads) u[e] = 0.f;
  for (long long e = gthread; e < cols; e += nthreads) v[e] = 0.f;
  grid.sync();

  for (int it = 0; it < num_iters; ++it) {
    // u = log_mu - LSE_row(C + v^T)
    for (int row = gwarp; row < rows; row += nwarps) {
      const int b = row / M1;
      const float* c = C + (size_t)row * N1;
      const float* vb = v + (size_t)b * N1;
      float m = -INFINITY, s = 0.f;
      for (int j = lane; j < N1; j += 32) lse_push(m, s, c[j] + vb[j]);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, off);
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        lse_merge(m, s, om, os);
      }
      if (lane == 0) u[row] = log_mu[row] - (m + logf(s));
    }
    grid.sync();

    // v = log_nu - LSE_col(C + u)
    for (int item = blockIdx.x; item < B * ntile; item += gridDim.x) {
      const int b = item / ntile;
      const int col = (item - b * ntile) * 32 + lane;
      float m = -INFINITY, s = 0.f;
      if (col < N1) {
        const float* cb = C + (size_t)b * M1 * N1 + col;
        const float* ub = u + (size_t)b * M1;
        for (int r = warp; r < M1; r += kWarps) lse_push(m, s, cb[(size_t)r * N1] + ub[r]);
      }
      part_m[warp][lane] = m;
      part_s[warp][lane] = s;
      __syncthreads();
      if (warp == 0 && col < N1) {
#pragma unroll 4
        for (int w = 1; w < kWarps; ++w) lse_merge(m, s, part_m[w][lane], part_s[w][lane]);
        v[(size_t)b * N1 + col] = log_nu[(size_t)b * N1 + col] - (m + logf(s));
      }
      __syncthreads();  // partials consumed before the next tile writes them
    }
    grid.sync();
  }

  // out = C + u + v^T
  const long long total = (long long)rows * N1;
  for (long long e = gthread; e < total; e += nthreads) {
    const long long row = e / N1;
    const int col = (int)(e - row * N1);
    const int b = (int)(row / M1);
    out[e] = C[e] + u[row] + v[(size_t)b * N1 + col];
  }
}

}  // namespace

extern "C" {

// couplings (B, M1, N1), log_mu (B, M1), log_nu (B, N1), all float32,
// contiguous; u (B, M1) and v (B, N1) are scratch; out (B, M1, N1).
// B * M1 and B * N1 must fit in an int. Launches on `stream` of `device`
// and allocates nothing. Returns the CUDA status (0 = success).
int sinkhorn_launch(const float* C, const float* log_mu, const float* log_nu, int B,
                    int M1, int N1, int num_iters, float* u, float* v, float* out,
                    int device, void* stream) {
  if (B <= 0 || M1 <= 0 || N1 <= 0 || num_iters < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * M1 > 2147483647LL || (long long)B * N1 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // co-resident blocks only (a cooperative launch refuses more), and no
  // more than the larger half-step can use
  const long long row_blocks = ((long long)B * M1 + kWarps - 1) / kWarps;
  const long long col_blocks = (long long)B * ((N1 + 31) / 32);
  long long grid = (long long)sms * per_sm;
  const long long need = row_blocks > col_blocks ? row_blocks : col_blocks;
  if (need < grid) grid = need;
  void* args[] = {(void*)&C, (void*)&log_mu, (void*)&log_nu, (void*)&B, (void*)&M1,
                  (void*)&N1, (void*)&num_iters, (void*)&u, (void*)&v, (void*)&out};
  e = cudaLaunchCooperativeKernel((const void*)sinkhorn_kernel, dim3((unsigned)grid),
                                  dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* sinkhorn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
