// The two sums over observations of PCG's implicit-Schur matvec, each a
// gather, a per-observation product and a fixed-order segment sum in one
// launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes each as an einsum and
// an XLA segment sum (reconstructor_tpu/ba/distributed.py:118-122, the
// rhs :128-129, the point step :140-141). The port ran a gather, an einsum
// and kernel 5 for each, three launches that wrote and read back an (O,
// 12) or (O, 3) operand and an (O, 3) or (O, 12) product. Two entry
// points, one template:
//   ytu_sum (DIR 0): out[l, j] = sum over the live rows o of landmark l of
//                    sum_i Y[o, i, j] u[cam_o, i]    (W^T u: (L, 3))
//   yz_sum  (DIR 1): out[c, i] = sum over the live rows o of camera c of
//                    sum_j Y[o, i, j] z[pt_o, j]     (W z: (C, 12))
// with Y (O, 12, 3) float32 the per-observation coupling Jc^T Jp. The
// layout (ba/cuda_segsum.py::segment_layout, once per solve) gives the
// rows of each segment in ascending row order (perm) and, in the same
// order, each row's index on the other side (other: its camera for
// ytu_sum, its landmark for yz_sum).
//
// What bounds it on an H100: bytes. Each live row of Y (144 B) is read
// once, with its perm and other entries; u (C x 12 floats) and z (L x 3)
// are small beside Y and stay in shared memory or L2. At the street
// problem (5e5 live rows) that is ~76 MB, ~23 us a direction at 3.35 TB/s;
// nothing of size O is written.
//
// The design: no atomics on values, nothing ordered by arrival. Each
// row's product is taken in a fixed order (fmaf over i, or over j, from
// the first term), and each segment's products are added in row order:
// - chunks of long segments (cameras, seg_common.cuh): a block of THREADS
//   threads a chunk; the chunk's rows of Y are staged THREADS at a time in
//   shared memory with 16-byte loads (nine threads a row, so a row gathered
//   through perm is still read as one run of 144 bytes); thread t takes the
//   chunk's rows t, t + THREADS, ... in order; the block adds its threads'
//   sums in a fixed tree (warp shuffles, then warps in order); the chunks
//   of a segment in chunk order (finish_segment).
// - short segments (landmarks: a few rows each): one thread a segment,
//   THREADS segments a block. For ytu_sum each block first stages u in
//   shared memory where it fits (C <= 768), else reads it through L1.

#include "seg_common.cuh"

namespace {

using namespace segsum;

constexpr int Y4 = 9;                       // a row of Y: 36 floats, 9 float4
constexpr int TILE = THREADS * Y4;          // float4s of staged rows (36,864 B)

template <int DIR> struct Dir;
template <> struct Dir<0> { static constexpr int OUT = 3, OPW = 12; };   // W^T u
template <> struct Dir<1> { static constexpr int OUT = 12, OPW = 3; };   // W z

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Element e = 3 i + j of a row held as 9 float4s.
__device__ __forceinline__ float yel(const float4* y, int e) { return comp(y[e >> 2], e & 3); }

// A row's product with its operand row op (OPW floats), in a fixed order.
template <int DIR>
__device__ __forceinline__ void row_product(const float4* y, const float* op, float* p) {
  if (DIR == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float a = yel(y, j) * op[0];
#pragma unroll
      for (int i = 1; i < 12; ++i) a = fmaf(yel(y, 3 * i + j), op[i], a);
      p[j] = a;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      float a = yel(y, 3 * i) * op[0];
      a = fmaf(yel(y, 3 * i + 1), op[1], a);
      p[i] = fmaf(yel(y, 3 * i + 2), op[2], a);
    }
  }
}

template <int DIR>
__device__ __forceinline__ void operand_row(const float* opnd, int idx, float* op) {
#pragma unroll
  for (int q = 0; q < Dir<DIR>::OPW; ++q) op[q] = opnd[(int64_t)idx * Dir<DIR>::OPW + q];
}

template <int DIR>
__global__ void __launch_bounds__(THREADS)
schur_sum_kernel(const float4* __restrict__ Y, const int* __restrict__ perm,
                 const int* __restrict__ other, const float* __restrict__ operand,
                 int n_operand, int stage, Chunks ch, int n_long, int n_chunks, int n_seg,
                 float* __restrict__ out) {
  constexpr int OUT = Dir<DIR>::OUT;
  __shared__ float4 tile[TILE];
  const int b = blockIdx.x, t = threadIdx.x;
  float p[OUT], op[Dir<DIR>::OPW];
  if (b < n_chunks) {
    __shared__ float warp_sum[THREADS / 32][OUT];
    const Chunk c = chunk_of(ch, b);
    float acc[OUT];
#pragma unroll
    for (int q = 0; q < OUT; ++q) acc[q] = 0.f;
    for (int r0 = c.begin; r0 < c.end; r0 += THREADS) {
      const int nr = min(THREADS, c.end - r0);
      for (int q = t; q < nr * Y4; q += THREADS) {
        const int rr = q / Y4;
        tile[q] = __ldg(Y + (int64_t)__ldg(perm + r0 + rr) * Y4 + (q - rr * Y4));
      }
      __syncthreads();
      if (t < nr) {
        float4 y[Y4];
#pragma unroll
        for (int m = 0; m < Y4; ++m) y[m] = tile[t * Y4 + m];
        operand_row<DIR>(operand, __ldg(other + r0 + t), op);
        row_product<DIR>(y, op, p);
#pragma unroll
        for (int q = 0; q < OUT; ++q) acc[q] += p[q];
      }
      __syncthreads();
    }
    const int lane = t & 31, warp = t >> 5;
#pragma unroll
    for (int q = 0; q < OUT; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sum[warp][q] = v;
    }
    __syncthreads();
    float* dst = chunk_dst(ch, c, b, OUT, out);
    if (t < OUT) {
      float a = warp_sum[0][t];
      for (int w = 1; w < THREADS / 32; ++w) a += warp_sum[w][t];
      dst[t] = a;
    }
    finish_segment(ch, c, b, OUT, out);
    return;
  }
  // short segments, one thread each
  const float* opnd = operand;
  if (DIR == 0 && stage) {
    float* u_s = reinterpret_cast<float*>(tile);
    for (int q = t; q < n_operand * Dir<DIR>::OPW; q += THREADS) u_s[q] = __ldg(operand + q);
    __syncthreads();
    opnd = u_s;
  }
  const int k = n_long + (b - n_chunks) * THREADS + t;
  if (k >= n_seg) return;
  const int s = ch.seg_ids[k];
  float acc[OUT];
#pragma unroll
  for (int q = 0; q < OUT; ++q) acc[q] = 0.f;
  for (int r = ch.offsets[s], end = ch.offsets[s + 1]; r < end; ++r) {
    const float4* row = Y + (int64_t)__ldg(perm + r) * Y4;
    float4 y[Y4];
#pragma unroll
    for (int m = 0; m < Y4; ++m) y[m] = __ldg(row + m);
    operand_row<DIR>(opnd, __ldg(other + r), op);
    row_product<DIR>(y, op, p);
#pragma unroll
    for (int q = 0; q < OUT; ++q) acc[q] += p[q];
  }
#pragma unroll
  for (int q = 0; q < OUT; ++q) out[(int64_t)s * OUT + q] = acc[q];
}

template <int DIR>
int launch(const float* Y, const int* perm, const int* other, const float* operand,
           int n_operand, const int* offsets, const int* seg_ids, const int* chunk_long,
           const int* first_chunk, int chunk_rows, int* counters, float* scratch, int n_long,
           int n_chunks, int n_seg, float* out, void* stream) {
  if (n_seg <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(Y) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const Chunks ch{offsets, seg_ids, chunk_long, first_chunk, chunk_rows, counters, scratch};
  const int stage = DIR == 0 && n_operand * Dir<DIR>::OPW <= TILE * 4;
  const int blocks = n_chunks + (n_seg - n_long + THREADS - 1) / THREADS;
  schur_sum_kernel<DIR><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(Y), perm, other, operand, n_operand, stage, ch, n_long,
      n_chunks, n_seg, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (rows, 12, 3) float32, 16-byte aligned; perm, other (live rows) int32
// in layout order; u (n_cam, 12) / z (n_pt, 3) float32; offsets (n_seg +
// 1), seg_ids (n_seg), chunk_long (n_chunks), first_chunk (n_long + 1)
// int32; counters (n_long) int32, zero; scratch (n_chunks, 12) float32 at
// least; out (n_seg, 3) / (n_seg, 12) float32. Returns the launch's
// cudaError_t (0: launched).
int ytu_sum_launch(const float* Y, const int* perm, const int* other, const float* u, int n_cam,
                   const int* offsets, const int* seg_ids, const int* chunk_long,
                   const int* first_chunk, int chunk_rows, int* counters, float* scratch,
                   int n_long, int n_chunks, int n_seg, float* out, void* stream) {
  return launch<0>(Y, perm, other, u, n_cam, offsets, seg_ids, chunk_long, first_chunk,
                   chunk_rows, counters, scratch, n_long, n_chunks, n_seg, out, stream);
}

int yz_sum_launch(const float* Y, const int* perm, const int* other, const float* z, int n_pt,
                  const int* offsets, const int* seg_ids, const int* chunk_long,
                  const int* first_chunk, int chunk_rows, int* counters, float* scratch,
                  int n_long, int n_chunks, int n_seg, float* out, void* stream) {
  return launch<1>(Y, perm, other, z, n_pt, offsets, seg_ids, chunk_long, first_chunk,
                   chunk_rows, counters, scratch, n_long, n_chunks, n_seg, out, stream);
}

const char* schur_sum_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
