// What the fixed-order segment sums of PCG share (kernels 5 and 6,
// ba/csrc/seg_sum.cu and ba/csrc/schur_sums.cu): the launch shape, the
// chunk table that splits a long segment over several blocks, and the
// second pass that adds a segment's chunk partials.
//
// The layout (ba/cuda_segsum.py::segment_layout, built once per solve)
// lists the segments of at least LONG_ROWS live rows first (n_long of
// them) and cuts each into chunks of chunk_rows rows: chunk j belongs to
// the long segment chunk_long[j], whose chunks are first_chunk[li] ..
// first_chunk[li + 1] - 1, in row order. A launch gives each chunk one
// block. A segment of one chunk writes its sums straight to the output;
// otherwise each chunk writes its partials to scratch, and the last block
// of the segment to arrive (an atomic counter per segment, reset by that
// block for the next launch) adds the partials in chunk order. Arrival
// chooses which block adds, never the order of the additions, so every
// sum depends only on the layout and the launch shape. No value is ever
// added atomically.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr int THREADS = 256;

struct Chunks {
  const int* offsets;      // (n_seg + 1): segment s holds rows offsets[s] .. offsets[s + 1] - 1
  const int* seg_ids;      // (n_seg): the n_long long segments first
  const int* chunk_long;   // (n_chunks): the long segment (index into seg_ids) of each chunk
  const int* first_chunk;  // (n_long + 1)
  int chunk_rows;
  int* counters;           // (n_long): zero between launches
  float* scratch;          // (n_chunks, W) partials
};

struct Chunk {
  int s;      // the segment
  int li;     // its index in the long list
  int k;      // this chunk's place in the segment
  int nk;     // the segment's chunks
  int begin;  // rows [begin, end) in layout order
  int end;
};

__device__ __forceinline__ Chunk chunk_of(const Chunks& ch, int j) {
  Chunk c;
  c.li = ch.chunk_long[j];
  c.s = ch.seg_ids[c.li];
  const int first = ch.first_chunk[c.li];
  c.nk = ch.first_chunk[c.li + 1] - first;
  c.k = j - first;
  c.begin = ch.offsets[c.s] + c.k * ch.chunk_rows;
  c.end = min(c.begin + ch.chunk_rows, ch.offsets[c.s + 1]);
  return c;
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Where chunk j of c writes its Wv partials: the output row itself when
// the segment has one chunk, else its row of scratch.
template <typename V>
__device__ __forceinline__ V* chunk_dst(const Chunks& ch, const Chunk& c, int j, int Wv, V* out) {
  return c.nk == 1 ? out + (int64_t)c.s * Wv : reinterpret_cast<V*>(ch.scratch) + (int64_t)j * Wv;
}

// Called by every thread of the block once chunk j's partials are written
// (chunk_dst). For a segment of several chunks, the last block to arrive
// adds the segment's partials in chunk order into its output row.
template <typename V>
__device__ __forceinline__ void finish_segment(const Chunks& ch, const Chunk& c, int j, int Wv,
                                               V* out) {
  if (c.nk == 1) return;
  __shared__ int last;
  __threadfence();               // this block's partials are visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&ch.counters[c.li], 1) == c.nk - 1;
    if (last) ch.counters[c.li] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const V* part = reinterpret_cast<const V*>(ch.scratch) + (int64_t)(j - c.k) * Wv;
  for (int col = threadIdx.x; col < Wv; col += THREADS) {
    V acc = __ldcg(part + col);  // L2: written by other blocks in this launch
    for (int k = 1; k < c.nk; ++k) acc = vadd(acc, __ldcg(part + (int64_t)k * Wv + col));
    out[(int64_t)c.s * Wv + col] = acc;
  }
}

}  // namespace segsum
