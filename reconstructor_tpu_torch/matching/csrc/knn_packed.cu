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
//       over image i, & 4095 (an accumulator that starts at INT32_MAX).
// Twelve bits hold the slot, so K <= 4096 (the wrapper raises above).
//
// Rounding: 2 - 2 sim and the scale by 2^17 are written with __fmul_rn /
// __fadd_rn so no FMA contraction changes where the truncation to an
// integer step falls; the product by -2 and by 2^17 are exact, so the one
// rounding is that of the subtraction, as in the TPU kernel.
//
// What bounds it on an H100: operations, as for knn_top2.cu. A pair is
// 2 * K^2 * D flops against ~K * D * 2 descriptor bytes in (~4,000 flops
// per byte at K = 4096, D = 128), far above the card's ridge. The design is
// knn_top2.cu's: the (K, K) key matrix never leaves the SM. A block owns 64
// rows of image i (all D channels in shared memory), streams image j
// through shared memory 64 columns by 128 channels at a time, accumulates
// each 64x64 tile's dot products as float32 FMAs on the SIMT units (bf16
// widens exactly to float32), and reduces the tile's keys in registers.
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

namespace {

constexpr int kD = 128;       // descriptor channels per slice of image j
constexpr int kMaxD = 512;    // widest descriptor (shared memory: (D + 128) x 68 floats)
constexpr int kTR = 64;       // rows of image i per block
constexpr int kTC = 64;       // columns of image j per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLds = kTR + 4; // shared row stride in floats (float4 aligned)
constexpr int kMaxK = 4096;   // slots addressable in the key's 12 low bits
constexpr int kDmax = (1 << 19) - 1;
constexpr float kScale = 131072.f;  // 2^17
constexpr float kBig = 1e30f;
constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// channels [d0, d0 + width) of 64 consecutive descriptors (row-major, D
// values each) -> dst[d - d0][r]
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int D, int d0,
                                          int width, float* __restrict__ dst, int tid) {
#pragma unroll 4
  for (int e = tid; e < kTR * width; e += kThreads) {
    const int r = e / width;
    const int d = e - r * width;
    dst[d * kLds + r] = to_f32(src[(size_t)r * D + d0 + d]);
  }
}

// the TPU kernel's quantisation of one similarity, before masking
__device__ __forceinline__ int quantise(float sim) {
  float t = __fmul_rn(__fadd_rn(2.f, __fmul_rn(-2.f, sim)), kScale);
  t = fminf(fmaxf(t, 0.f), (float)(kDmax - 1));
  return __float2int_rz(t);
}

__device__ __forceinline__ float unpack(int key) {
  return key >= (kDmax << 12) ? kBig : (float)(key >> 12) * (1.f / kScale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
knn_packed_kernel(const T* __restrict__ desc, const int* __restrict__ bias,
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
  const T* di_ptr = desc + ((size_t)img_i * K + row0) * D;
  const T* dj_ptr = desc + (size_t)img_j * K * D;
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
        const int q = max(quantise(acc[i][j]), bcol[j]);
        const int key = (q << 12) | (c0 + tx * 4 + j);
        if (key < best[i]) {
          second[i] = best[i];
          best[i] = key;
        } else {
          second[i] = min(second[i], key);
        }
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

  // merge the 16 partial top-2s of each row (lanes sharing ty); keys are
  // distinct (each holds its column), so no tie rule is needed
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int os = __shfl_xor_sync(0xffffffffu, second[i], off);
      if (ob < best[i]) {
        second[i] = min(os, best[i]);
        best[i] = ob;
      } else {
        second[i] = min(second[i], ob);
      }
    }
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

__global__ void fill_kernel(int* __restrict__ x, int value, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] = value;
}

__global__ void key_to_slot_kernel(int* __restrict__ x, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] &= 4095;
}

template <typename T>
cudaError_t launch(const void* desc, const int* bias, const int* pairs, int B, int K,
                   int D, float* best, float* second, int* arg, int* colarg,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(D + kD) * kLds * sizeof(float);
  // above 48 KB of dynamic shared memory a kernel must opt in (cheap;
  // set on every launch so it holds for whichever device is current)
  cudaError_t e = cudaFuncSetAttribute(
      knn_packed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * K;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  fill_kernel<<<blocks, 256, 0, stream>>>(colarg, kIntMax, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(K / kTR, B);
  knn_packed_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(desc), bias, pairs, K, D, best, second, arg, colarg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  key_to_slot_kernel<<<blocks, 256, 0, stream>>>(colarg, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 descriptors, 1 = bfloat16. desc (N, K, D) row-major,
// bias (N, K) int32 (0 valid / 2^19 - 1 masked), pairs (B, 2) int32,
// outputs (B, K). K must be a multiple of 64 up to 4096, D a multiple of
// 128 up to 512; 0 < B <= 65535. Returns the CUDA status of the launches
// (0 = success).
int knn_packed_launch(const void* desc, int dtype, const int* bias, const int* pairs,
                      int B, int K, int D, float* best, float* second, int* arg,
                      int* colarg, void* stream) {
  if (K <= 0 || K % kTC != 0 || K > kMaxK || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(desc, bias, pairs, B, K, D, best, second, arg, colarg, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(desc, bias, pairs, B, K, D, best, second, arg, colarg,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* knn_packed_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
