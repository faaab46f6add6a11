// The kNN kernel with its reductions switched on level by level, for
// Hopper (sm_90a): a profiling tool that splits the top-2 kNN kernel's
// (matching/csrc/knn_top2.cu) time into its parts.
//
// Replaces scripts/profile_knn_kernel.py::make_kernel(level) and
// ::make_packed_kernel (the Pallas TPU kernels launched by that script's
// run). Per pair (i, j) of the pair table, with no masks:
//   dist = max(2 - 2 d_i . d_j^T, 0)       (float32 accumulate; bf16 or f32 in)
//   level 0: best = row min; arg = 0, second = best, colarg = 0
//   level 1: + arg = row argmin (lowest column on ties)
//   level 2: + second = row min over every column but arg
//   level 3: + colarg = column argmin over image i (lowest row on ties):
//            the top-2 kNN kernel with zero bias
//   packed (4): keys (clip((2 - 2 sim) * 2^17, 0, 2^19 - 1) << 12) | slot,
//            one int min per reduction (the packed kernel,
//            matching/csrc/knn_packed.cu, without masks: clipped at 2^19 - 1,
//            no 1e30 sentinel); best and second are (key >> 12) * 2^-17,
//            arg and colarg the keys' slots. K <= 4096.
// Each level is its own template instance, so a lower level does none of
// the higher levels' work.
//
// What bounds it on an H100: operations (2 * K^2 * D flops a pair against
// ~K * D * 2 bytes in).
//
// bf16 input: the top-2 kNN kernel's own product (knn_wgmma.cuh, reached
// by a relative include, which nvcc resolves from this file's directory):
// one block of two warpgroups per (pair, 128 rows of image i), the band in
// shared memory, image j through the cp.async ring, wgmma m64n128k16 in
// the same k-step order, the same pipeline stages and blocks per SM
// (wgmma_plan). No tile is skipped: the level kernel has no masks. Each
// level runs only its part of knn_top2.cu's epilogue, in its layout:
// level 0 one fminf a distance, level 1 the argmin's compare and select,
// level 2 the second min (push_top2, in knn_top2.cu's chains), level 3
// also the 64-bit (distance bits, row) column keys with their 7-shuffle
// reduce-scatter and 64-bit atomicMin, exactly as knn_top2.cu; the packed
// level 32-bit keys, one int min and max a row key, a 32-bit
// reduce-scatter and atomicMin for the columns. knn_top2.cu writes the
// same product loop inline rather than calling the header (its compiled
// code is held as it was), so level 3 == knn_top2.cu with zero bias is not
// shared code but a check, bit for bit, on exact, unnormalised and random
// unit inputs (chip_smoke.py); with it the levels split that kernel's
// epilogue.
// float32 input keeps the SIMT product (64 x 64 tiles, float32 FMAs):
// TF32 tensor cores would keep about three decimal digits and change
// results.
//
// The column reductions of levels 3 and packed merge across blocks with
// one atomicMin per column per block, so the lowest row wins ties
// whatever the order the blocks run in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../matching/csrc/knn_wgmma.cuh"

namespace {

using namespace knn_wgmma;

constexpr int kD = 128;
constexpr int kMaxD = 512;
constexpr int kTR = 64;
constexpr int kTC = 64;
constexpr int kThreads = 256;
constexpr int kLds = kTR + 4;
constexpr int kPacked = 4;
constexpr int kMaxK = 4096;   // the packed level's 12-bit slot

// ---------------------------------------------------------------------
// float32: SIMT product
// ---------------------------------------------------------------------

__device__ __forceinline__ void load_tile(const float* __restrict__ src, int D, int d0,
                                          int width, float* __restrict__ dst, int tid) {
#pragma unroll 4
  for (int e = tid; e < kTR * width; e += kThreads) {
    const int r = e / width;
    const int d = e - r * width;
    dst[d * kLds + r] = src[(size_t)r * D + d0 + d];
  }
}

// Row state: float levels keep (best, second, arg); the packed level keeps
// two keys in the int fields.
struct Row {
  float best, second;
  int arg;
  int kbest, ksecond;
};

template <int LEVEL>
__global__ void __launch_bounds__(kThreads)
knn_level_kernel(const float* __restrict__ desc, const int* __restrict__ pairs, int K, int D,
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
  const float* di = desc + ((size_t)pairs[2 * p] * K + row0) * D;
  const float* dj = desc + (size_t)pairs[2 * p + 1] * K * D;

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
          const int q = quantise(acc[i][j], kDmax);
          push_key(r[i].kbest, r[i].ksecond, (q << 12) | col);
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
        merge_keys(r[i].kbest, r[i].ksecond, off);
      } else if (LEVEL == 0) {
        r[i].best = fminf(r[i].best, __shfl_xor_sync(0xffffffffu, r[i].best, off));
      } else {
        merge_top2(r[i].best, r[i].second, r[i].arg, off);
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

// ---------------------------------------------------------------------
// bf16: wgmma product (knn_wgmma.cuh)
// ---------------------------------------------------------------------

// level 1's row state: the running min and its lowest column
__device__ __forceinline__ void push_min(float& best, int& arg, float d, int col) {
  if (d < best) {
    best = d;
    arg = col;
  }
}

__device__ __forceinline__ void join_min(float& best, int& arg, float ob, int oa) {
  if (ob < best || (ob == best && oa < arg)) {
    best = ob;
    arg = oa;
  }
}

// two blocks an SM where two stages leave room for them (D = 128), as
// knn_top2.cu
template <int LEVEL, int S>
__global__ void __launch_bounds__(kWgThreads, S == 2 ? 2 : 1)
knn_level_wgmma_kernel(const __nv_bfloat16* __restrict__ desc, const int* __restrict__ pairs,
                       int K, int D, float* __restrict__ best_out,
                       float* __restrict__ second_out, int* __restrict__ arg_out,
                       unsigned long long* __restrict__ colbest, int* __restrict__ colkey) {
  using Key = typename std::conditional<LEVEL == kPacked, int, unsigned long long>::type;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must be 1024-byte aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nsub = D / 64;
  const int nslice = D / kSlice;
  uint8_t* As = smem;                                          // [nsub][128 rows][128 B]
  uint8_t* Bs = smem + nsub * kSubBytes;                       // [S][2][128 cols][128 B]
  Key* colpart = reinterpret_cast<Key*>(Bs + S * kStageBytes);   // [8][kTN]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kBand;
  const __nv_bfloat16* di = desc + ((size_t)pairs[2 * p] * K + row0) * D;
  const __nv_bfloat16* dj = desc + (size_t)pairs[2 * p + 1] * K * D;
  const int units = (K / kTN) * nslice;   // every (tile, channel slice) stage

  load_band(As, di, row0, K, D, tid);
#pragma unroll
  for (int u = 0; u < S - 1; ++u) ring_load<S>(Bs, dj, K, D, nslice, units, u, tid);

  // this thread's rows: g and g + 8 of its warp's 16 in its warpgroup's 64
  // (K is a multiple of 128, so both exist)
  const int ra = row0 + wg * 64 + (warp & 3) * 16 + g;
  const int rb = ra + 8;
  const float inf = __int_as_float(0x7f800000);
  // the float levels' running row state, in knn_top2.cu's chains (even and
  // odd columns where one block has an SM's registers); the packed level's
  // two smallest keys
  constexpr int kChains = S == 2 ? 1 : 2;
  float best_a[2] = {inf, inf}, second_a[2] = {inf, inf};
  float best_b[2] = {inf, inf}, second_b[2] = {inf, inf};
  int arg_a[2] = {0, 0}, arg_b[2] = {0, 0};
  int kbest_a = kIntMax, ksecond_a = kIntMax, kbest_b = kIntMax, ksecond_b = kIntMax;

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
      Key key[8];   // key[2 ii + e]: column 8 (4 qt + ii) + 2q + e
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * qt + ii;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * i + 2 * q + e;
          const int ch = e % kChains;
          if constexpr (LEVEL == kPacked) {
            const int qa = quantise(acc[4 * i + e], kDmax);
            const int qb = quantise(acc[4 * i + 2 + e], kDmax);
            push_key(kbest_a, ksecond_a, (qa << 12) | col);
            push_key(kbest_b, ksecond_b, (qb << 12) | col);
            key[2 * ii + e] = min((qa << 12) | ra, (qb << 12) | rb);
          } else {
            const float dist_a = fmaxf(2.f - 2.f * acc[4 * i + e], 0.f);
            const float dist_b = fmaxf(2.f - 2.f * acc[4 * i + 2 + e], 0.f);
            if constexpr (LEVEL == 0) {
              best_a[ch] = fminf(best_a[ch], dist_a);
              best_b[ch] = fminf(best_b[ch], dist_b);
            } else if constexpr (LEVEL == 1) {
              push_min(best_a[ch], arg_a[ch], dist_a, col);
              push_min(best_b[ch], arg_b[ch], dist_b, col);
            } else {
              push_top2(best_a[ch], second_a[ch], arg_a[ch], dist_a, col);
              push_top2(best_b[ch], second_b[ch], arg_b[ch], dist_b, col);
            }
            if constexpr (LEVEL == 3) {
              const unsigned long long ka =
                  ((unsigned long long)__float_as_uint(dist_a) << 32) | (unsigned)ra;
              const unsigned long long kb =
                  ((unsigned long long)__float_as_uint(dist_b) << 32) | (unsigned)rb;
              key[2 * ii + e] = ka < kb ? ka : kb;
            }
          }
        }
      }
      if constexpr (LEVEL >= 3) colpart[warp * kTN + scatter_col(qt, g, q)] = reduce_scatter8(key, g);
    }
    if constexpr (LEVEL >= 3) {
      __syncthreads();
      if (tid < kTN) {
        Key m = colpart[tid];
#pragma unroll
        for (int w = 1; w < 8; ++w) m = colpart[w * kTN + tid] < m ? colpart[w * kTN + tid] : m;
        if constexpr (LEVEL == kPacked)
          atomicMin(&colkey[(size_t)p * K + c0 + tid], m);
        else
          atomicMin(&colbest[(size_t)p * K + c0 + tid], m);
      }
    }
  }
  cp_async_wait<0>();

  // one chain per row, then the quad's partial results of each row (lowest
  // column on ties)
  if constexpr (LEVEL == kPacked) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      merge_keys(kbest_a, ksecond_a, off);
      merge_keys(kbest_b, ksecond_b, off);
    }
  } else if constexpr (LEVEL == 0) {
    best_a[0] = fminf(best_a[0], best_a[kChains - 1]);
    best_b[0] = fminf(best_b[0], best_b[kChains - 1]);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      best_a[0] = fminf(best_a[0], __shfl_xor_sync(0xffffffffu, best_a[0], off));
      best_b[0] = fminf(best_b[0], __shfl_xor_sync(0xffffffffu, best_b[0], off));
    }
  } else if constexpr (LEVEL == 1) {
    if (kChains == 2) {
      join_min(best_a[0], arg_a[0], best_a[1], arg_a[1]);
      join_min(best_b[0], arg_b[0], best_b[1], arg_b[1]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      join_min(best_a[0], arg_a[0], __shfl_xor_sync(0xffffffffu, best_a[0], off),
               __shfl_xor_sync(0xffffffffu, arg_a[0], off));
      join_min(best_b[0], arg_b[0], __shfl_xor_sync(0xffffffffu, best_b[0], off),
               __shfl_xor_sync(0xffffffffu, arg_b[0], off));
    }
  } else {
    if (kChains == 2) {
      join_top2(best_a[0], second_a[0], arg_a[0], best_a[1], second_a[1], arg_a[1]);
      join_top2(best_b[0], second_b[0], arg_b[0], best_b[1], second_b[1], arg_b[1]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      merge_top2(best_a[0], second_a[0], arg_a[0], off);
      merge_top2(best_b[0], second_b[0], arg_b[0], off);
    }
  }
  if (q == 0) {
    const size_t oa = (size_t)p * K + ra;
    const size_t ob = (size_t)p * K + rb;
    if constexpr (LEVEL == kPacked) {
      best_out[oa] = (float)(kbest_a >> 12) * (1.f / kScale);
      second_out[oa] = (float)(ksecond_a >> 12) * (1.f / kScale);
      arg_out[oa] = kbest_a & 4095;
      best_out[ob] = (float)(kbest_b >> 12) * (1.f / kScale);
      second_out[ob] = (float)(ksecond_b >> 12) * (1.f / kScale);
      arg_out[ob] = kbest_b & 4095;
    } else {
      best_out[oa] = best_a[0];
      second_out[oa] = LEVEL >= 2 ? second_a[0] : best_a[0];
      arg_out[oa] = LEVEL >= 1 ? arg_a[0] : 0;
      best_out[ob] = best_b[0];
      second_out[ob] = LEVEL >= 2 ? second_b[0] : best_b[0];
      arg_out[ob] = LEVEL >= 1 ? arg_b[0] : 0;
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

template <int LEVEL, int S>
cudaError_t launch_wgmma(const __nv_bfloat16* desc, const int* pairs, int B, int K, int D,
                         float* best, float* second, int* arg, int* colarg,
                         unsigned long long* colbest, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(knn_level_wgmma_kernel<LEVEL, S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  knn_level_wgmma_kernel<LEVEL, S><<<dim3(K / kBand, B), kWgThreads, smem, stream>>>(
      desc, pairs, K, D, best, second, arg, colbest, colarg);
  return cudaGetLastError();
}

template <int LEVEL>
cudaError_t launch(const void* desc, int dtype, const int* pairs, int B, int K, int D,
                   float* best, float* second, int* arg, int* colarg,
                   unsigned long long* colbest, cudaStream_t stream) {
  const long long n = (long long)B * K;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaError_t e;
  if (LEVEL == 3) {
    e = cudaMemsetAsync(colbest, 0xff, (size_t)n * sizeof(unsigned long long), stream);
  } else if (LEVEL == kPacked) {
    fill_kernel<<<blocks, 256, 0, stream>>>(colarg, kIntMax, n);
    e = cudaGetLastError();
  } else {
    e = cudaMemsetAsync(colarg, 0, (size_t)n * sizeof(int), stream);
  }
  if (e != cudaSuccess) return e;
  if (dtype == 0) {
    const size_t smem = (size_t)(D + kD) * kLds * sizeof(float);
    e = cudaFuncSetAttribute(knn_level_kernel<LEVEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    knn_level_kernel<LEVEL><<<dim3(K / kTR, B), kThreads, smem, stream>>>(
        static_cast<const float*>(desc), pairs, K, D, best, second, arg, colbest, colarg);
  } else {
    int dev = 0, stages = 0, smem = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = wgmma_plan(D, dev, &stages, &smem);
    if (e != cudaSuccess) return e;
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(desc);
    if (stages == 2)
      e = launch_wgmma<LEVEL, 2>(d, pairs, B, K, D, best, second, arg, colarg, colbest, smem,
                                 stream);
    else if (stages == 3)
      e = launch_wgmma<LEVEL, 3>(d, pairs, B, K, D, best, second, arg, colarg, colbest, smem,
                                 stream);
    else
      e = launch_wgmma<LEVEL, 4>(d, pairs, B, K, D, best, second, arg, colarg, colbest, smem,
                                 stream);
  }
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (LEVEL == 3) {
    colarg_kernel<<<blocks, 256, 0, stream>>>(colbest, colarg, n);
  } else if (LEVEL == kPacked) {
    key_to_slot_kernel<<<blocks, 256, 0, stream>>>(colarg, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// level: 0-3, or 4 for the packed variant. dtype: 0 = float32 descriptors,
// 1 = bfloat16. desc (N, K, D) row-major, pairs (B, 2) int32, outputs
// (B, K); colbest is (B, K) 64-bit scratch (read at level 3 only). K must
// be a multiple of 128 (and at most 4096 for the packed level), D a
// multiple of 128 up to 512; 0 < B <= 65535. Returns the CUDA status of
// the launches (0 = success).
int knn_levels_launch(int level, const void* desc, int dtype, const int* pairs, int B, int K,
                      int D, float* best, float* second, int* arg, int* colarg,
                      unsigned long long* colbest, void* stream) {
  if (K <= 0 || K % kTN != 0 || B <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (level == kPacked && K > kMaxK) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
    case 0: return (int)launch<0>(desc, dtype, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case 1: return (int)launch<1>(desc, dtype, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case 2: return (int)launch<2>(desc, dtype, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case 3: return (int)launch<3>(desc, dtype, pairs, B, K, D, best, second, arg, colarg, colbest, s);
    case kPacked:
      return (int)launch<kPacked>(desc, dtype, pairs, B, K, D, best, second, arg, colarg, colbest,
                                  s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* knn_levels_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
