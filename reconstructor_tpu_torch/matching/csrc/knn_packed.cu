// Packed-int32 top-2 kNN with the mutual-check column argmin, for Hopper (sm_90a).
//
// Replaces reconstructor_tpu/matching/pallas_knn.py::_knn_kernel_packed
// (the Pallas TPU kernel launched by _knn_topk2(..., packed=True)). Same
// function, per pair (i, j) of the pair table:
//   sim  = d_i . d_j^T                      (float32 accumulate; bf16 or f32 in)
//   di   = (int) clip((2 - 2 sim) * 2^17, 0, DMAX - 1),  DMAX = 2^19 - 1
//   di   = max(di, bias_j)                  (int32 bias: 0 valid / DMAX masked)
//   key  = (di << 12) | column              (one int min = value and lowest-index argmin)
//   best, second: the smallest and second-smallest key of the row (the
//       second excludes only the best key); a key >= DMAX << 12 (a masked
//       column) is written as 1e30, any other as (key >> 12) * 2^-17
//   arg = best & 4095
//   colarg: per column of image j, the smallest (max(di, bias_i) << 12) | row
//       over image i, & 4095.
// Twelve bits hold the slot, so K <= 4096 (the wrapper raises above).
//
// Rounding: quantise() (knn_wgmma.cuh) writes 2 - 2 sim and the scale by
// 2^17 with __fmul_rn / __fadd_rn so no FMA contraction changes where the
// truncation to an integer step falls, as in the TPU kernel.
//
// What bounds it on an H100: operations, as for knn_top2.cu. A pair is
// 2 * K^2 * D flops against ~K * D * 2 descriptor bytes in (~4,000 flops
// per byte at K = 4096, D = 128), far above the card's ridge; the (K, K)
// key matrix never leaves the SM.
//
// bf16 input: knn_top2.cu's design, on the same product (knn_wgmma.cuh):
// one block of two warpgroups per (pair, 128 rows of image i), the band in
// shared memory, image j through a cp.async ring of 128 x 128 stages,
// wgmma m64n128k16 in knn_top2.cu's k-step order, column tiles wholly past
// image j's extent (last valid slot + 1, from the wrapper) not computed.
// The epilogue is the packed one, and cheaper than knn_top2.cu's float
// one: per distance one quantisation, one int max with bias_j, a row key
// folded into the row's two smallest by one min and one max (the keys of
// a row are distinct, so no tie test and no argmin register), and a
// 32-bit column key, reduced by 32-bit shuffles and merged by a 32-bit
// atomicMin.
// - The column accumulator starts at DMAX << 12, not INT32_MAX: every
//   column's true minimum is at most row 0's key, (DMAX << 12) | 0, so the
//   start is exact, and a skipped column (all of its rows' keys are
//   (DMAX << 12) | row) needs no work and reads row 0, as on the TPU.
// - A masked row's column key, (DMAX << 12) | row, never lowers the
//   accumulator, so a warp whose 16 rows are all masked builds none.
// - The columns past the last computed tile give the row two candidates in
//   closed form: (DMAX << 12) | cs for the first skipped column cs, and
//   (DMAX << 12) | (cs + 1) (K - cs is a multiple of 128). Both read 1e30.
// float32 input keeps the SIMT product (64 x 64 tiles, float32 FMAs):
// TF32 tensor cores would keep about three decimal digits and change
// results.
//
// The TPU carried the column best across row tiles in a revisited int32
// accumulator, race-free only because a TPU grid runs in order. Blocks
// here run in parallel, so each block merges its tile's column-minimum key
// into the per-pair accumulator (the colarg output itself) with one 32-bit
// atomicMin per column: the key is exact and the minimum does not depend
// on the order the blocks run in. A second small kernel masks the keys
// down to row indices in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_wgmma.cuh"

namespace {

using namespace knn_wgmma;

constexpr int kD = 128;       // descriptor channels per slice of image j
constexpr int kMaxD = 512;    // widest descriptor (shared memory: (D + 128) x 68 floats)
constexpr int kTR = 64;       // rows of image i per block
constexpr int kTC = 64;       // columns of image j per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLds = kTR + 4; // shared row stride in floats (float4 aligned)
constexpr int kMaxK = 4096;   // slots addressable in the key's 12 low bits
constexpr float kBig = 1e30f;
constexpr int kColStart = kDmax << 12;   // the column accumulator's start

__device__ __forceinline__ float unpack(int key) {
  return key >= (kDmax << 12) ? kBig : (float)(key >> 12) * (1.f / kScale);
}

// ---------------------------------------------------------------------
// float32: SIMT product
// ---------------------------------------------------------------------

// channels [d0, d0 + width) of 64 consecutive descriptors (row-major, D
// values each) -> dst[d - d0][r]
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int D, int d0,
                                          int width, float* __restrict__ dst, int tid) {
#pragma unroll 4
  for (int e = tid; e < kTR * width; e += kThreads) {
    const int r = e / width;
    const int d = e - r * width;
    dst[d * kLds + r] = src[(size_t)r * D + d0 + d];
  }
}

__global__ void __launch_bounds__(kThreads)
knn_packed_kernel(const float* __restrict__ desc, const int* __restrict__ bias,
                  const int* __restrict__ pairs, int K, int D,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ arg_out, int* __restrict__ colacc) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;              // [D][kLds] rows of image i
  float* Bs = smem + D * kLds;   // [kD][kLds] current column tile slice of image j
  __shared__ int colpart[kThreads / 32][kTC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kTR;
  const int img_i = pairs[2 * p];
  const int img_j = pairs[2 * p + 1];
  const float* di_ptr = desc + ((size_t)img_i * K + row0) * D;
  const float* dj_ptr = desc + (size_t)img_j * K * D;
  const int* bi = bias + (size_t)img_i * K;
  const int* bj = bias + (size_t)img_j * K;

  load_tile(di_ptr, D, 0, D, As, tid);

  int bias_r[4], best[4], second[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bias_r[i] = bi[row0 + ty * 4 + i];
    best[i] = kIntMax;
    second[i] = kIntMax;
  }

  for (int c0 = 0; c0 < K; c0 += kTC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kD) {
      __syncthreads();  // As loaded / previous slice's Bs and colpart consumed
      load_tile(dj_ptr + (size_t)c0 * D, D, d0, kD, Bs, tid);
      __syncthreads();
      const float* Ad = As + d0 * kLds;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&Ad[d * kLds + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[d * kLds + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    int bcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bcol[j] = bj[c0 + tx * 4 + j];

    int cmin[4] = {kIntMax, kIntMax, kIntMax, kIntMax};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = max(quantise(acc[i][j], kDmax - 1), bcol[j]);
        push_key(best[i], second[i], (q << 12) | (c0 + tx * 4 + j));
        cmin[j] = min(cmin[j], (max(q, bias_r[i]) << 12) | row);
      }
    }
    // lanes l and l ^ 16 hold the same columns (two values of ty)
#pragma unroll
    for (int j = 0; j < 4; ++j) cmin[j] = min(cmin[j], __shfl_xor_sync(0xffffffffu, cmin[j], 16));
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) colpart[warp][tx * 4 + j] = cmin[j];
    }
    __syncthreads();
    if (tid < kTC) {
      int m = colpart[0][tid];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) m = min(m, colpart[w][tid]);
      atomicMin(&colacc[(size_t)p * K + c0 + tid], m);
    }
  }

  // merge the 16 partial top-2s of each row (lanes sharing ty)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) merge_keys(best[i], second[i], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = (size_t)p * K + row0 + ty * 4 + i;
      best_out[o] = unpack(best[i]);
      second_out[o] = unpack(second[i]);
      arg_out[o] = best[i] & 4095;
    }
  }
}

// ---------------------------------------------------------------------
// bf16: wgmma product (knn_wgmma.cuh)
// ---------------------------------------------------------------------

// two blocks an SM where two stages leave room for them (D = 128)
template <int S>
__global__ void __launch_bounds__(kWgThreads, S == 2 ? 2 : 1)
knn_packed_wgmma_kernel(const __nv_bfloat16* __restrict__ desc, const int* __restrict__ bias,
                        const int* __restrict__ pairs, const int* __restrict__ extent, int K,
                        int D, float* __restrict__ best_out, float* __restrict__ second_out,
                        int* __restrict__ arg_out, int* __restrict__ colacc) {
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must be 1024-byte aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nsub = D / 64;
  const int nslice = D / kSlice;
  uint8_t* As = smem;                                          // [nsub][128 rows][128 B]
  uint8_t* Bs = smem + nsub * kSubBytes;                       // [S][2][128 cols][128 B]
  int* colpart = reinterpret_cast<int*>(Bs + S * kStageBytes);   // [8][kTN]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kBand;
  const int img_i = pairs[2 * p];
  const int img_j = pairs[2 * p + 1];
  const __nv_bfloat16* di = desc + ((size_t)img_i * K + row0) * D;
  const __nv_bfloat16* dj = desc + (size_t)img_j * K * D;
  const int* bj = bias + (size_t)img_j * K;
  const int n_tiles = (extent[img_j] + kTN - 1) / kTN;   // tiles holding a valid column
  const int units = n_tiles * nslice;                     // (tile, channel slice) stages

  load_band(As, di, row0, K, D, tid);
#pragma unroll
  for (int u = 0; u < S - 1; ++u) ring_load<S>(Bs, dj, K, D, nslice, units, u, tid);

  // this thread's rows: g and g + 8 of its warp's 16 in its warpgroup's 64
  // (K is a multiple of 128, so both exist)
  const int ra = row0 + wg * 64 + (warp & 3) * 16 + g;
  const int rb = ra + 8;
  const int bias_a = bias[(size_t)img_i * K + ra];
  const int bias_b = bias[(size_t)img_i * K + rb];
  const bool keys_live = __any_sync(0xffffffffu, bias_a < kDmax || bias_b < kDmax);
  if (!keys_live)
    for (int c = lane; c < kTN; c += 32) colpart[warp * kTN + c] = kIntMax;
  int best_a = kIntMax, second_a = kIntMax, best_b = kIntMax, second_b = kIntMax;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();   // stage u landed for every thread; stage u - 1 consumed
    ring_load<S>(Bs, dj, K, D, nslice, units, u + S - 1, tid);
    const int t = u / nslice;
    const int s = u - t * nslice;
    mma_slice(acc, As, Bs + (u % S) * kStageBytes, wg, s);
    if (s != nslice - 1) continue;

    // epilogue of column tile t (the accumulator layout: knn_wgmma.cuh)
    const int c0 = t * kTN;
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) {
      int key[8];   // key[2 ii + e]: column 8 (4 qt + ii) + 2q + e
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * qt + ii;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * i + 2 * q + e;
          const int bc = __ldg(bj + col);
          const int qa = max(quantise(acc[4 * i + e], kDmax - 1), bc);
          const int qb = max(quantise(acc[4 * i + 2 + e], kDmax - 1), bc);
          push_key(best_a, second_a, (qa << 12) | col);
          push_key(best_b, second_b, (qb << 12) | col);
          key[2 * ii + e] = min((max(qa, bias_a) << 12) | ra, (max(qb, bias_b) << 12) | rb);
        }
      }
      if (!keys_live) continue;
      colpart[warp * kTN + scatter_col(qt, g, q)] = reduce_scatter8(key, g);
    }
    __syncthreads();
    if (tid < kTN) {
      int m = colpart[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) m = min(m, colpart[w * kTN + tid]);
      if (m < kColStart) atomicMin(&colacc[(size_t)p * K + c0 + tid], m);
    }
  }
  cp_async_wait<0>();

  // the columns past the last computed tile: all masked, in closed form
  // (there are at least 128 of them, so the two smallest keys exist)
  const int cs = n_tiles * kTN;
  if (q == 0 && cs < K) {
    push_key(best_a, second_a, kColStart | cs);
    push_key(best_b, second_b, kColStart | cs);
    push_key(best_a, second_a, kColStart | (cs + 1));
    push_key(best_b, second_b, kColStart | (cs + 1));
  }

  // merge the quad's partial top-2s of each row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    merge_keys(best_a, second_a, off);
    merge_keys(best_b, second_b, off);
  }
  if (q == 0) {
    const size_t oa = (size_t)p * K + ra;
    const size_t ob = (size_t)p * K + rb;
    best_out[oa] = unpack(best_a);
    second_out[oa] = unpack(second_a);
    arg_out[oa] = best_a & 4095;
    best_out[ob] = unpack(best_b);
    second_out[ob] = unpack(second_b);
    arg_out[ob] = best_b & 4095;
  }
}

__global__ void fill_kernel(int* __restrict__ x, int value, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] = value;
}

__global__ void key_to_slot_kernel(int* __restrict__ x, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] &= 4095;
}

template <int S>
cudaError_t launch_wgmma(const __nv_bfloat16* desc, const int* bias, const int* pairs,
                         const int* extent, int B, int K, int D, float* best, float* second,
                         int* arg, int* colacc, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      knn_packed_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  knn_packed_wgmma_kernel<S><<<dim3(K / kBand, B), kWgThreads, smem, stream>>>(
      desc, bias, pairs, extent, K, D, best, second, arg, colacc);
  return cudaGetLastError();
}

cudaError_t launch(const void* desc, int dtype, const int* bias, const int* pairs,
                   const int* extent, int B, int K, int D, float* best, float* second,
                   int* arg, int* colarg, cudaStream_t stream) {
  const long long n = (long long)B * K;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  fill_kernel<<<blocks, 256, 0, stream>>>(colarg, kColStart, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (dtype == 0) {
    const size_t smem = (size_t)(D + kD) * kLds * sizeof(float);
    // above 48 KB of dynamic shared memory a kernel must opt in (cheap;
    // set on every launch so it holds for whichever device is current)
    e = cudaFuncSetAttribute(knn_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    knn_packed_kernel<<<dim3(K / kTR, B), kThreads, smem, stream>>>(
        static_cast<const float*>(desc), bias, pairs, K, D, best, second, arg, colarg);
  } else {
    int dev = 0, stages = 0, smem = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = wgmma_plan(D, dev, &stages, &smem);
    if (e != cudaSuccess) return e;
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(desc);
    if (stages == 2)
      e = launch_wgmma<2>(d, bias, pairs, extent, B, K, D, best, second, arg, colarg, smem,
                          stream);
    else if (stages == 3)
      e = launch_wgmma<3>(d, bias, pairs, extent, B, K, D, best, second, arg, colarg, smem,
                          stream);
    else
      e = launch_wgmma<4>(d, bias, pairs, extent, B, K, D, best, second, arg, colarg, smem,
                          stream);
  }
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  key_to_slot_kernel<<<blocks, 256, 0, stream>>>(colarg, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 descriptors, 1 = bfloat16. desc (N, K, D) row-major,
// bias (N, K) int32 (0 valid / 2^19 - 1 masked), pairs (B, 2) int32,
// extent (N,) int32 (bf16 only: last valid slot + 1 of each image, 0 for
// none), outputs (B, K). K must be a multiple of 128 up to 4096, D a
// multiple of 128 up to 512; 0 < B <= 65535. Returns the CUDA status of
// the launches (0 = success).
int knn_packed_launch(const void* desc, int dtype, const int* bias, const int* pairs,
                      const int* extent, int B, int K, int D, float* best, float* second,
                      int* arg, int* colarg, void* stream) {
  if (K <= 0 || K % kTN != 0 || K > kMaxK || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && extent == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(desc, dtype, bias, pairs, extent, B, K, D, best, second, arg, colarg,
                     static_cast<cudaStream_t>(stream));
}

const char* knn_packed_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
