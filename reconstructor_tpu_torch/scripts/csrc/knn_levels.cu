// The kNN kernel with its reductions switched on level by level, for
// Hopper (sm_90a): a profiling tool that splits a top-2 kNN kernel's time
// into its parts.
//
// Replaces scripts/profile_knn_kernel.py::make_kernel(level) and
// ::make_packed_kernel (the Pallas TPU kernels launched by that script's
// run). Per pair (i, j) of the pair table, with no masks:
//   dist = max(2 - 2 d_i . d_j^T, 0)       (float32 accumulate; bf16 or f32 in)
//   level 0: best = row min; arg = 0, second = best, colarg = 0
//   level 1: + arg = row argmin (lowest column on ties)
//   level 2: + second = row min over every column but arg
//   level 3: + colarg = column argmin over image i (lowest row on ties):
//            the top-2 kNN kernel (matching/csrc/knn_top2.cu) with zero bias
//   packed (4): keys (clip((2 - 2 sim) * 2^17, 0, 2^19 - 1) << 12) | slot,
//            one int min per reduction (the packed kernel,
//            matching/csrc/knn_packed.cu, without masks: clipped at 2^19 - 1,
//            no 1e30 sentinel); best and second are (key >> 12) * 2^-17,
//            arg and colarg the keys' slots. K <= 4096.
// Each level is its own template instance, so a lower level does none of
// the higher levels' work.
//
// What bounds it on an H100: operations (2 * K^2 * D flops a pair against
// ~K * D * 2 bytes in). The design is knn_top2.cu's: a block owns 64 rows
// of image i (all D channels in shared memory), streams image j through
// shared memory 64 columns by 128 channels at a time, accumulates each
// 64x64 tile's dot products as float32 FMAs (bf16 widens exactly), and
// reduces the tile in registers; the column reductions of levels 3 and
// packed merge across blocks with one atomicMin per column per block
// (64-bit (distance bits, row) keys at level 3, 32-bit packed keys), so
// the lowest row wins ties whatever the order the blocks run in. The file
// is self-contained: the build hashes this source alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kMaxD = 512;
constexpr int kTR = 64;
constexpr int kTC = 64;
constexpr int kThreads = 256;
constexpr int kLds = kTR + 4;
constexpr int kPacked = 4;
constexpr int kMaxK = 4096;   // the packed level's 12-bit slot
constexpr int kDmax = (1 << 19) - 1;
constexpr float kScale = 131072.f;
constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// Row state: float levels keep (best, second, arg); the packed level keeps
// two keys in the int fields.
struct Row {
  float best, second;
  int arg;
  int kbest, ksecond;
};

template <int LEVEL, typename T>
__global__ void __launch_bounds__(kThreads)
knn_level_kernel(const T* __restrict__ desc, const int* __restrict__ pairs, int K, int D,
                 float* __restrict__ best_out, float* __restrict__ second_out,
                 int* __restrict__ arg_out, unsigned long long* __restrict__ colbest,
                 int* __restrict__ colkey) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + D * kLds;
  __shared__ unsigned long long colpart[kThreads / 32][kTC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kTR;
  const T* di = desc + ((size_t)pairs[2 * p] * K + row0) * D;
  const T* dj = desc + (size_t)pairs[2 * p + 1] * K * D;

  load_tile(di, D, 0, D, As, tid);

  Row r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i].best = __int_as_float(0x7f800000);   // +inf
    r[i].second = __int_as_float(0x7f800000);
    r[i].arg = 0;
    r[i].kbest = kIntMax;
    r[i].ksecond = kIntMax;
  }

  for (int c0 = 0; c0 < K; c0 += kTC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kD) {
      __syncthreads();
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

    unsigned long long cmin[4] = {~0ull, ~0ull, ~0ull, ~0ull};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned row = (unsigned)(row0 + ty * 4 + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // this thread's columns, increasing
        const int col = c0 + tx * 4 + j;
        if (LEVEL == kPacked) {
          float t = __fmul_rn(__fadd_rn(2.f, __fmul_rn(-2.f, acc[i][j])), kScale);
          const int q = __float2int_rz(fminf(fmaxf(t, 0.f), (float)kDmax));
          const int key = (q << 12) | col;
          if (key < r[i].kbest) {
            r[i].ksecond = r[i].kbest;
            r[i].kbest = key;
          } else {
            r[i].ksecond = min(r[i].ksecond, key);
          }
          const unsigned long long ck = (unsigned long long)((q << 12) | (int)row);
          cmin[j] = ck < cmin[j] ? ck : cmin[j];
        } else {
          const float dist = fmaxf(2.f - 2.f * acc[i][j], 0.f);
          if (LEVEL == 0) {
            r[i].best = fminf(r[i].best, dist);
          } else if (dist < r[i].best) {
            r[i].second = r[i].best;
            r[i].best = dist;
            r[i].arg = col;
          } else if (LEVEL >= 2) {
            r[i].second = fminf(r[i].second, dist);
          }
          if (LEVEL == 3) {
            const unsigned long long key =
                ((unsigned long long)__float_as_uint(dist) << 32) | row;
            cmin[j] = key < cmin[j] ? key : cmin[j];
          }
        }
      }
    }
    if (LEVEL >= 3) {
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
        if (LEVEL == kPacked)
          atomicMin(&colkey[(size_t)p * K + c0 + tid], (int)m);
        else
          atomicMin(&colbest[(size_t)p * K + c0 + tid], m);
      }
    }
  }

  // merge the 16 partial results of each row (lanes sharing ty)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      if (LEVEL == kPacked) {
        const int ob = __shfl_xor_sync(0xffffffffu, r[i].kbest, off);
        const int os = __shfl_xor_sync(0xffffffffu, r[i].ksecond, off);
        if (ob < r[i].kbest) {
          r[i].ksecond = min(os, r[i].kbest);
          r[i].kbest = ob;
        } else {
          r[i].ksecond = min(r[i].ksecond, ob);
        }
      } else if (LEVEL == 0) {
        r[i].best = fminf(r[i].best, __shfl_xor_sync(0xffffffffu, r[i].best, off));
      } else {
        const float ob = __shfl_xor_sync(0xffffffffu, r[i].best, off);
        const float os = __shfl_xor_sync(0xffffffffu, r[i].second, off);
        const int oa = __shfl_xor_sync(0xffffffffu, r[i].arg, off);
        if (ob < r[i].best || (ob == r[i].best && oa < r[i].arg)) {
          r[i].second = fminf(os, r[i].best);
          r[i].best = ob;
          r[i].arg = oa;
        } else {
          r[i].second = fminf(r[i].second, ob);
        }
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = (size_t)p * K + row0 + ty * 4 + i;
      if (LEVEL == kPacked) {
        best_out[o] = (float)(r[i].kbest >> 12) * (1.f / kScale);
        second_out[o] = (float)(r[i].ksecond >> 12) * (1.f / kScale);
        arg_out[o] = r[i].kbest & 4095;
      } else {
        best_out[o] = r[i].best;
        second_out[o] = LEVEL >= 2 ? r[i].second : r[i].best;
        arg_out[o] = LEVEL >= 1 ? r[i].arg : 0;
      }
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

__global__ void colarg_kernel(const unsigned long long* __restrict__ colbest,
                              int* __restrict__ colarg, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) colarg[t] = (int)(unsigned)(colbest[t] & 0xffffffffull);
}

template <int LEVEL, typename T>
cudaError_t launch(const void* desc, const int* pairs, int B, int K, int D, float* best,
                   float* second, int* arg, int* colarg, unsigned long long* colbest,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(D + kD) * kLds * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      knn_level_kernel<LEVEL, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * K;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (LEVEL == 3) {
    e = cudaMemsetAsync(colbest, 0xff, (size_t)n * sizeof(unsigned long long), stream);
  } else if (LEVEL == kPacked) {
    fill_kernel<<<blocks, 256, 0, stream>>>(colarg, kIntMax, n);
    e = cudaGetLastError();
  } else {
    e = cudaMemsetAsync(colarg, 0, (size_t)n * sizeof(int), stream);
  }
  if (e != cudaSuccess) return e;
  const dim3 grid(K / kTR, B);
  knn_level_kernel<LEVEL, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(desc), pairs, K, D, best, second, arg, colbest, colarg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (LEVEL == 3) {
    colarg_kernel<<<blocks, 256, 0, stream>>>(colbest, colarg, n);
  } else if (LEVEL == kPacked) {
    key_to_slot_kernel<<<blocks, 256, 0, stream>>>(colarg, n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_level(int level, const void* desc, const int* pairs, int B, int K, int D,
                         float* best, float* second, int* arg, int* colarg,
                         unsigned long long* colbest, cudaStream_t s) {
  switch (level) {
    case 0: return launch<0, T>(desc, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case 1: return launch<1, T>(desc, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case 2: return launch<2, T>(desc, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case 3: return launch<3, T>(desc, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case kPacked:
      return launch<kPacked, T>(desc, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// level: 0-3, or 4 for the packed variant. dtype: 0 = float32 descriptors,
// 1 = bfloat16. desc (N, K, D) row-major, pairs (B, 2) int32, outputs
// (B, K); colbest is (B, K) 64-bit scratch (read at level 3 only). K must
// be a multiple of 64 (and at most 4096 for the packed level), D a
// multiple of 128 up to 512; 0 < B <= 65535. Returns the CUDA status of
// the launches (0 = success).
int knn_levels_launch(int level, const void* desc, int dtype, const int* pairs, int B, int K,
                      int D, float* best, float* second, int* arg, int* colarg,
                      unsigned long long* colbest, void* stream) {
  if (K <= 0 || K % kTC != 0 || B <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (level == kPacked && K > kMaxK) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_level<float>(level, desc, pairs, B, K, D, best, second, arg, colarg,
                                    colbest, s);
  if (dtype == 1)
    return (int)launch_level<__nv_bfloat16>(level, desc, pairs, B, K, D, best, second, arg,
                                            colarg, colbest, s);
  return (int)cudaErrorInvalidValue;
}

const char* knn_levels_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
