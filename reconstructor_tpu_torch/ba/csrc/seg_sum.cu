// Segmented row sums in a fixed order, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package sums per-observation rows
// into cameras and landmarks with XLA's jax.ops.segment_sum
// (reconstructor_tpu/ba/distributed.py:84-87), which adds in one order on
// its chip. PyTorch's index_add_ is float atomics on the card, so its
// order, and the last bits of every PCG solve, change from run to run.
// This kernel takes the block sums of ba/distributed.py (g_c, g_p, H_cc,
// H_pp, once per LM iteration) in an order that depends only on the
// layout and the launch shape. The sums of the CG loop go through the
// fused kernel 6 (ba/csrc/schur_sums.cu).
//
// Function: out[s, c] = sum over k in [offsets[s], offsets[s+1]) of
// values[perm[k], c], for every segment s < n_seg and column c < W.
// perm lists each segment's live rows in ascending row order (a stable
// sort of the segment index, built once per solve by
// ba/cuda_segsum.py::segment_layout); an empty segment gives exact zeros.
// Every output element is written, so the output needs no clearing.
//
// What bounds it on an H100: bytes. Each live row of values is read once,
// with its perm entry; the layout and the output once. At the street
// problem's shapes (5e5 live rows) that is ~8 us for a (O, 12) -> cameras
// sum, ~87 us at W = 144 (H_cc) and ~3 us for (O, 3) -> landmarks.
//
// The design: no atomics on values, nothing ordered by arrival. Where W is
// a multiple of 4 (12, 144) the kernel works on float4 columns (Wv = W /
// 4), else on floats (Wv = W). One launch holds two kinds of block:
// - chunks of long segments (seg_common.cuh): a block of THREADS threads
//   a chunk of up to chunk_rows rows, so a camera of thousands of rows
//   runs on several SMs. With R = THREADS / Wv row phases, thread t takes
//   column t % Wv and the chunk's rows t / Wv, t / Wv + R, ... in order,
//   into UNROLL accumulators that take turns and are added in a fixed
//   tree; the R partials of a column are added in phase order from shared
//   memory; the chunks of a segment in chunk order (finish_segment).
// - short segments (fewer than LONG_ROWS rows: landmarks): Wv consecutive
//   threads a segment, one column each over every row, so no lane idles
//   at W = 3 or 9 (THREADS / Wv segments a block).

#include "seg_common.cuh"

namespace {

using namespace segsum;

constexpr int UNROLL = 4;

// Column c of the rows begin + phase, + stride, ... < end, in a fixed
// order: accumulator j takes the rows j, j + UNROLL, ... of the thread's
// sequence; the tail (< UNROLL rows) goes to accumulators 0, 1, ... in
// turn; then (a0 + a1) + (a2 + a3).
template <typename V>
__device__ __forceinline__ V strided_sum(const V* __restrict__ values,
                                         const int* __restrict__ perm, int begin, int end,
                                         int phase, int stride, int Wv, int c) {
  V a[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) a[j] = vzero<V>();
  int i = begin + phase;
  for (; i + (UNROLL - 1) * stride < end; i += UNROLL * stride) {
    int r[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) r[j] = __ldg(perm + i + j * stride);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) a[j] = vadd(a[j], __ldg(values + (int64_t)r[j] * Wv + c));
  }
#pragma unroll
  for (int j = 0; j < UNROLL - 1; ++j) {
    if (i < end) a[j] = vadd(a[j], __ldg(values + (int64_t)__ldg(perm + i) * Wv + c));
    i += stride;
  }
  return vadd(vadd(a[0], a[1]), vadd(a[2], a[3]));
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
seg_sum_kernel(const V* __restrict__ values, const int* __restrict__ perm, Chunks ch,
               int n_long, int n_chunks, int n_seg, int Wv, V* __restrict__ out) {
  __shared__ V part[THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  if (b < n_chunks) {
    const Chunk c = chunk_of(ch, b);
    V* dst = chunk_dst(ch, c, b, Wv, out);
    if (Wv >= THREADS) {
      for (int col = t; col < Wv; col += THREADS)
        dst[col] = strided_sum(values, perm, c.begin, c.end, 0, 1, Wv, col);
    } else {
      const int R = THREADS / Wv;
      V s = vzero<V>();
      if (t < R * Wv) s = strided_sum(values, perm, c.begin, c.end, t / Wv, R, Wv, t % Wv);
      part[t] = s;
      __syncthreads();
      if (t < Wv) {
        V acc = part[t];
        for (int r = 1; r < R; ++r) acc = vadd(acc, part[r * Wv + t]);
        dst[t] = acc;
      }
    }
    finish_segment(ch, c, b, Wv, out);
    return;
  }
  // short segments: Wv threads each (one segment a block where Wv > THREADS)
  const int per = Wv <= THREADS ? THREADS / Wv : 1;
  const int k = n_long + (b - n_chunks) * per + (Wv <= THREADS ? t / Wv : 0);
  if (k >= n_seg || (Wv <= THREADS && t >= per * Wv)) return;
  const int s = ch.seg_ids[k];
  const int begin = ch.offsets[s], end = ch.offsets[s + 1];
  for (int col = Wv <= THREADS ? t % Wv : t; col < Wv; col += THREADS)
    out[(int64_t)s * Wv + col] = strided_sum(values, perm, begin, end, 0, 1, Wv, col);
}

template <typename V>
int launch(const float* values, const int* perm, const Chunks& ch, int n_long, int n_chunks,
           int n_seg, int Wv, float* out, cudaStream_t stream) {
  const int per = Wv <= THREADS ? THREADS / Wv : 1;
  const int blocks = n_chunks + (n_seg - n_long + per - 1) / per;
  if (blocks > 0)
    seg_sum_kernel<V><<<blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const V*>(values), perm, ch, n_long, n_chunks, n_seg, Wv,
        reinterpret_cast<V*>(out));
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// values (rows, W) float32; perm (live rows) int32; offsets (n_seg + 1),
// seg_ids (n_seg), chunk_long (n_chunks), first_chunk (n_long + 1) int32;
// counters (n_long) int32, zero; scratch (n_chunks, W) float32; out
// (n_seg, W) float32. Returns the launch's cudaError_t (0: launched).
int seg_sum_launch(const float* values, const int* perm, const int* offsets, const int* seg_ids,
                   const int* chunk_long, const int* first_chunk, int chunk_rows, int* counters,
                   float* scratch, int n_long, int n_chunks, int n_seg, int W, float* out,
                   void* stream) {
  if (n_seg <= 0 || W <= 0) return 0;
  const Chunks ch{offsets, seg_ids, chunk_long, first_chunk, chunk_rows, counters, scratch};
  const cudaStream_t st = (cudaStream_t)stream;
  if (W % 4 == 0 && aligned16(values) && aligned16(out) && aligned16(scratch))
    return launch<float4>(values, perm, ch, n_long, n_chunks, n_seg, W / 4, out, st);
  return launch<float>(values, perm, ch, n_long, n_chunks, n_seg, W, out, st);
}

const char* seg_sum_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int seg_sum_threads() { return THREADS; }

}  // extern "C"
