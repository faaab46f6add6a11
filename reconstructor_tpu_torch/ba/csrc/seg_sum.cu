// Segmented row sums in a fixed order, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package sums per-observation rows
// into cameras and landmarks with XLA's jax.ops.segment_sum
// (reconstructor_tpu/ba/distributed.py:84-87, 119, 122, 128, 140), which
// adds in one order on its chip. PyTorch's index_add_ is float atomics on
// the card, so its order, and the last bits of every PCG solve, change
// from run to run. This kernel takes the sums of ba/distributed.py, in an
// order that depends only on the layout and the launch shape.
//
// Function: out[s, c] = sum over k in [offsets[s], offsets[s+1]) of
// values[perm[k], c], for every segment s < n_seg and column c < W.
// perm lists each segment's live rows in ascending row order (a stable
// sort of the segment index, built once per solve by
// ba/cuda_segsum.py::segment_layout); an empty segment gives exact zeros.
// Every output element is written, so the output needs no clearing.
//
// What bounds it on an H100: bytes. Each live row of values is read once,
// with its perm entry; offsets, the segment list and the output once. At
// the street problem's shapes (5e5 live rows) that is ~8 us for a
// (O, 12) -> cameras sum and ~4 us for (O, 3) -> landmarks, so one
// launch's fixed cost is of the same size.
//
// The design: no atomics and nothing scheduled by arrival. One launch
// holds two kinds of block, chosen per segment from its length when the
// layout is built (segment_layout puts the long ones first in seg_ids):
// - long segments (cameras: ~5,000 rows each on the street problem): one
//   block of THREADS threads per segment;
// - short segments (landmarks: a few rows each): one warp per segment,
//   WARPS segments a block.
// A group of G threads (the block, or the warp) splits a segment the same
// way: with R = G / W row phases, thread t takes column t % W and rows
// t / W, t / W + R, t / W + 2R, ... in order, into UNROLL accumulators
// that take turns (ILP) and are added in a fixed tree; the R partials of
// a column are then added in phase order from shared memory. Where W >= G
// each thread takes whole columns (c = t, t + G, ...) over every row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;           // a block: one long segment
constexpr int WARPS = THREADS / 32;    // or this many short ones
constexpr int UNROLL = 4;

// Sum of column c over the rows begin + phase, + stride, ... < end of the
// segment, in a fixed order: accumulator j takes the rows j, j + UNROLL,
// ... of the thread's sequence; the tail (< UNROLL rows) goes to
// accumulators 0, 1, ... in turn; then (a0 + a1) + (a2 + a3).
__device__ __forceinline__ float strided_sum(const float* __restrict__ values,
                                             const int* __restrict__ perm, int begin,
                                             int end, int phase, int stride, int W, int c) {
  float a[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) a[j] = 0.f;
  int i = begin + phase;
  for (; i + (UNROLL - 1) * stride < end; i += UNROLL * stride) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      a[j] += values[(int64_t)perm[i + j * stride] * W + c];
  }
#pragma unroll
  for (int j = 0; j < UNROLL - 1; ++j) {
    if (i < end) a[j] += values[(int64_t)perm[i] * W + c];
    i += stride;
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// One segment [begin, end) into out_row (W floats) by a group of G
// threads; t is the thread's rank in the group, part G floats of shared
// memory the group owns. BLOCK: the group is the whole block (else a warp).
template <bool BLOCK>
__device__ __forceinline__ void segment_sum(const float* __restrict__ values,
                                            const int* __restrict__ perm, int begin, int end,
                                            int W, float* __restrict__ out_row, float* part,
                                            int t, int G) {
  if (W >= G) {
    for (int c = t; c < W; c += G)
      out_row[c] = strided_sum(values, perm, begin, end, 0, 1, W, c);
    return;
  }
  const int R = G / W;
  float s = 0.f;
  if (t < R * W) s = strided_sum(values, perm, begin, end, t / W, R, W, t % W);
  part[t] = s;
  if (BLOCK) __syncthreads(); else __syncwarp();
  if (t < W) {
    float acc = part[t];
    for (int r = 1; r < R; ++r) acc += part[r * W + t];
    out_row[t] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
seg_sum_kernel(const float* __restrict__ values, const int* __restrict__ perm,
               const int* __restrict__ offsets, const int* __restrict__ seg_ids, int n_long,
               int n_seg, int W, float* __restrict__ out) {
  __shared__ float part[THREADS];
  const int b = blockIdx.x;
  if (b < n_long) {
    const int s = seg_ids[b];
    segment_sum<true>(values, perm, offsets[s], offsets[s + 1], W, out + (int64_t)s * W,
                      part, threadIdx.x, THREADS);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = n_long + (b - n_long) * WARPS + warp;
  if (k >= n_seg) return;             // the whole warp leaves together
  const int s = seg_ids[k];
  segment_sum<false>(values, perm, offsets[s], offsets[s + 1], W, out + (int64_t)s * W,
                     part + warp * 32, lane, 32);
}

}  // namespace

extern "C" {

// values (rows, W) float32; perm (live rows) int32; offsets (n_seg + 1)
// int32; seg_ids (n_seg) int32, the n_long long segments first; out
// (n_seg, W) float32. Returns the launch's cudaError_t (0: launched).
int seg_sum_launch(const float* values, const int* perm, const int* offsets,
                   const int* seg_ids, int n_long, int n_seg, int W, float* out,
                   void* stream) {
  if (n_seg <= 0 || W <= 0) return 0;
  const int blocks = n_long + (n_seg - n_long + WARPS - 1) / WARPS;
  seg_sum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      values, perm, offsets, seg_ids, n_long, n_seg, W, out);
  return (int)cudaGetLastError();
}

const char* seg_sum_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int seg_sum_threads() { return THREADS; }

}  // extern "C"
