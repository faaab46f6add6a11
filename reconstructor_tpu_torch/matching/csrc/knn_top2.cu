// Exact top-2 kNN with the mutual-check column argmin, for Hopper (sm_90a).
//
// Replaces reconstructor_tpu/matching/pallas_knn.py::_knn_kernel (the
// Pallas TPU kernel launched by _knn_topk2). Same function, per pair
// (i, j) of the pair table:
//   sim  = d_i . d_j^T                 (float32 accumulate; bf16 or f32 in)
//   dist = max(2 - 2 sim, 0) + bias_j  (bias 0 valid / 1e30 masked, not inf)
//   best, second, arg: row minimum, second minimum (over every column but
//       arg), argmin with the lowest column index on ties
//   colarg: per column of image j, the argmin row over image i of
//       dist + bias_i, lowest row index on ties; 0 where that minimum is
//       not below 1e30 (the TPU kernel's accumulator never updates there).
//
// What bounds it on an H100: operations. A pair is 2 * K^2 * 128 flops
// against ~K * 128 * 2 descriptor bytes in, so at K = 4096 the work is
// ~4,000 flops per byte, far above the card's ~20 (f32 SIMT) to ~295
// (bf16 tensor core) flops-per-byte ridge. The design keeps the (K, K)
// distance matrix out of device memory entirely, as the TPU kernel keeps
// it in VMEM: a block owns 64 rows of image i (all D channels in shared
// memory), streams image j through shared memory 64 columns by 128
// channels at a time, accumulating each 64x64 tile's dot products over
// the D / 128 channel slices, and reduces the tile in registers. D is any
// multiple of 128 up to 512 (SIFT 128, SuperPoint 256), as the TPU
// kernel takes any multiple of 128. Products run as float32 FMAs on the SIMT units
// (bf16 inputs widen exactly to float32, so the bf16 path is the same
// bf16-in, f32-accumulate arithmetic as the TPU's MXU pass); tensor-core
// (wgmma) products are the next step for speed, not needed for
// correctness.
//
// The TPU carried the column argmin across row tiles in a revisited
// output block, which is race-free only because a TPU grid runs in order.
// Blocks here run in parallel, so each block folds its tile's column
// minima into a 64-bit key (float bits of dist + bias_i, which is >= 0,
// in the high word; row index in the low word) and merges it into a
// per-pair accumulator with one 64-bit atomicMin per column: the minimum
// key is the minimum distance with the lowest row on ties, whatever the
// order the blocks run in. A second small kernel turns the keys into row
// indices.

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
constexpr float kBig = 1e30f;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
knn_top2_kernel(const T* __restrict__ desc, const float* __restrict__ bias,
                const int* __restrict__ pairs, int K, int D,
                float* __restrict__ best_out, float* __restrict__ second_out,
                int* __restrict__ arg_out,
                unsigned long long* __restrict__ colbest) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;              // [D][kLds] rows of image i
  float* Bs = smem + D * kLds;   // [kD][kLds] current column tile slice of image j
  __shared__ unsigned long long colpart[kThreads / 32][kTC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kTR;
  const int img_i = pairs[2 * p];
  const int img_j = pairs[2 * p + 1];
  const T* di = desc + ((size_t)img_i * K + row0) * D;
  const T* dj = desc + (size_t)img_j * K * D;
  const float* bi = bias + (size_t)img_i * K;
  const float* bj = bias + (size_t)img_j * K;

  load_tile(di, D, 0, D, As, tid);

  float bias_r[4], best[4], second[4];
  int barg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bias_r[i] = bi[row0 + ty * 4 + i];
    best[i] = __int_as_float(0x7f800000);   // +inf
    second[i] = __int_as_float(0x7f800000);
    barg[i] = 0;
  }

  for (int c0 = 0; c0 < K; c0 += kTC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kD) {
      __syncthreads();  // As loaded / previous slice's Bs and colpart consumed
      load_tile(dj + (size_t)c0 * D, D, d0, kD, Bs, tid);
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

    float bcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bcol[j] = bj[c0 + tx * 4 + j];

    unsigned long long cmin[4] = {~0ull, ~0ull, ~0ull, ~0ull};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned row = (unsigned)(row0 + ty * 4 + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // this thread's columns, increasing
        const float dist = fmaxf(2.f - 2.f * acc[i][j], 0.f) + bcol[j];
        if (dist < best[i]) {
          second[i] = best[i];
          best[i] = dist;
          barg[i] = c0 + tx * 4 + j;
        } else {
          second[i] = fminf(second[i], dist);
        }
        const float dc = dist + bias_r[i];
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(dc) << 32) | row;
        cmin[j] = key < cmin[j] ? key : cmin[j];
      }
    }
    // lanes l and l ^ 16 hold the same columns (two values of ty)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, cmin[j], 16);
      cmin[j] = o < cmin[j] ? o : cmin[j];
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) colpart[warp][tx * 4 + j] = cmin[j];
    }
    __syncthreads();
    if (tid < kTC) {
      unsigned long long m = colpart[0][tid];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) m = colpart[w][tid] < m ? colpart[w][tid] : m;
      atomicMin(&colbest[(size_t)p * K + c0 + tid], m);
    }
  }

  // merge the 16 partial top-2s of each row (lanes sharing ty)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, barg[i], off);
      if (ob < best[i] || (ob == best[i] && oa < barg[i])) {
        second[i] = fminf(os, best[i]);
        best[i] = ob;
        barg[i] = oa;
      } else {
        second[i] = fminf(second[i], ob);
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = (size_t)p * K + row0 + ty * 4 + i;
      best_out[o] = best[i];
      second_out[o] = second[i];
      arg_out[o] = barg[i];
    }
  }
}

__global__ void knn_colarg_kernel(const unsigned long long* __restrict__ colbest,
                                  int* __restrict__ colarg, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const unsigned long long v = colbest[t];
    const float d = __uint_as_float((unsigned)(v >> 32));
    colarg[t] = d < kBig ? (int)(unsigned)(v & 0xffffffffull) : 0;
  }
}

template <typename T>
cudaError_t launch(const void* desc, const float* bias, const int* pairs, int B,
                   int K, int D, float* best, float* second, int* arg, int* colarg,
                   unsigned long long* colbest, cudaStream_t stream) {
  const size_t smem = (size_t)(D + kD) * kLds * sizeof(float);
  // above 48 KB of dynamic shared memory a kernel must opt in (cheap;
  // set on every launch so it holds for whichever device is current)
  cudaError_t e = cudaFuncSetAttribute(
      knn_top2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(colbest, 0xff, (size_t)B * K * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(K / kTR, B);
  knn_top2_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(desc), bias, pairs, K, D, best, second, arg, colbest);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * K;
  knn_colarg_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(colbest, colarg, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 descriptors, 1 = bfloat16. desc (N, K, D) row-major,
// bias (N, K) float32, pairs (B, 2) int32, outputs (B, K); colbest is
// (B, K) 64-bit scratch. K must be a multiple of 64, D a multiple of 128
// up to 512; 0 < B <= 65535. Returns the CUDA status of the launches
// (0 = success).
int knn_top2_launch(const void* desc, int dtype, const float* bias,
                    const int* pairs, int B, int K, int D, float* best, float* second,
                    int* arg, int* colarg, unsigned long long* colbest,
                    void* stream) {
  if (K <= 0 || K % kTC != 0 || B <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(desc, bias, pairs, B, K, D, best, second, arg, colarg, colbest,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(desc, bias, pairs, B, K, D, best, second, arg, colarg,
                                      colbest, s);
  return (int)cudaErrorInvalidValue;
}

const char* knn_top2_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
