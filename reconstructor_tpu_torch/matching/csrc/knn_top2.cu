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
// What bounds it on an H100: operations. A pair is 2 * K^2 * D flops
// against ~K * D * 2 descriptor bytes in, so at K = 4096 the work is
// ~4,000 flops per byte, far above the card's ~295 (bf16 tensor core)
// flops-per-byte ridge. The (K, K) distance matrix never reaches device
// memory, as the TPU kernel kept it in VMEM.
//
// bf16 input (the path's default), the design that answers that bound
// (its product, knn_wgmma.cuh, is shared with knn_packed.cu and
// scripts/csrc/knn_levels.cu):
// - one block of two warpgroups per (pair, 128 rows of image i); the
//   band's bf16 descriptors stay in shared memory, all D channels, in the
//   128-byte-swizzled K-major layout that wgmma descriptors read;
// - image j streams through a ring of 2-4 shared-memory stages of 128
//   columns x 128 channels, filled by cp.async so the next stage's copy
//   overlaps the current product (two blocks share an SM at D = 128);
// - the product is wgmma.mma_async m64n128k16 (bf16 in, float32
//   accumulators in registers, D / 16 k-steps a column tile); bf16
//   products are exact in float32, only the order of the sums differs
//   from a SIMT loop;
// - the epilogue reads the accumulators in wgmma's layout (each row's
//   128 columns over a quad of lanes, 32 each, in increasing order) and
//   keeps the running row best / second / arg (in two independent chains,
//   even and odd columns, where one block has an SM's registers: D >=
//   256); the quad merges them at the end, lowest column on ties. A column's 16 rows of a warp lie on 8
//   lanes; their 64-bit column keys are reduced by a reduce-scatter over
//   those lanes (7 shuffles for 8 columns, not 24), then across the
//   block's 8 warps in shared memory;
// - column tiles wholly past image j's extent (last valid slot + 1, from
//   the wrapper) are not computed: each such column would give exactly
//   fl(d + 1e30) = 1e30, so the skipped region gives a row one candidate
//   (1e30, first skipped column), and a second 1e30 when it spans more
//   than one column; it adds nothing to colarg. Row bands are never
//   skipped: the row outputs of masked rows of image i are defined. A
//   masked row's column keys are >= 1e30, which colarg never reports, so
//   a warp whose 16 rows are all masked builds no column keys.
// What bounds this design: with the product on the tensor cores, the
// epilogue is the kernel. Per 128 x 128 tile a thread runs ~1,000
// instructions (distance, row top-2, column keys and their reduction),
// so 8 warps issue ~8,000 warp-instructions against ~1,100 clocks of
// tensor-core work for the tile; the row top-2 and the 64-bit column
// keys are most of it. Making it faster means fewer epilogue
// instructions per distance (or a cheaper column argmin), not a faster
// product.
// float32 input keeps the SIMT product (64 x 64 tiles, float32 FMAs):
// TF32 tensor cores would keep about three decimal digits and change
// results.
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

#include "knn_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------
// float32: SIMT product
// ---------------------------------------------------------------------

constexpr int kD = 128;       // descriptor channels per slice of image j
constexpr int kMaxD = 512;    // widest descriptor (shared memory: (D + 128) x 68 floats)
constexpr int kTR = 64;       // rows of image i per block
constexpr int kTC = 64;       // columns of image j per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLds = kTR + 4; // shared row stride in floats (float4 aligned)
constexpr float kBig = 1e30f;

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
knn_top2_kernel(const float* __restrict__ desc, const float* __restrict__ bias,
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
  const float* di = desc + ((size_t)img_i * K + row0) * D;
  const float* dj = desc + (size_t)img_j * K * D;
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


// ---------------------------------------------------------------------
// bf16: wgmma product
// ---------------------------------------------------------------------
// The tile constants, the cp.async / wgmma / swizzle helpers, the row
// top-2 helpers and the launch plan are knn_wgmma.cuh's, shared with the
// packed and level kernels. This kernel writes its band load, stage ring,
// product loop and column-key reduce-scatter inline: the header's
// functions for them issue the same instructions in the same k-step
// order, but here they changed the compiled code (registers and spills),
// and this kernel's code is held as it was.
using namespace knn_wgmma;

// two blocks an SM where two stages leave room for them (D = 128)
template <int S>
__global__ void __launch_bounds__(kWgThreads, S == 2 ? 2 : 1)
knn_top2_wgmma_kernel(const __nv_bfloat16* __restrict__ desc, const float* __restrict__ bias,
                      const int* __restrict__ pairs, const int* __restrict__ extent, int K,
                      int D, float* __restrict__ best_out, float* __restrict__ second_out,
                      int* __restrict__ arg_out, unsigned long long* __restrict__ colbest) {
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must be 1024-byte aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nsub = D / 64;
  const int nslice = D / kSlice;
  uint8_t* As = smem;                                   // [nsub][128 rows][128 B]
  uint8_t* Bs = smem + nsub * kSubBytes;                // [S][2][128 cols][128 B]
  unsigned long long* colpart =
      reinterpret_cast<unsigned long long*>(Bs + S * kStageBytes);   // [8][kTN]

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
  const float* bj = bias + (size_t)img_j * K;
  const int n_tiles = (extent[img_j] + kTN - 1) / kTN;   // tiles holding a valid column
  const int units = n_tiles * nslice;                     // (tile, channel slice) stages

  // the band: 128 rows x D channels (rows past K read as 0)
  const int chunks = D / 8;
  for (int e = tid; e < kBand * chunks; e += kWgThreads) {
    const int r = e / chunks;
    const int ch = e - r * chunks;
    uint8_t* dst = As + (ch >> 3) * kSubBytes + swz(r, ch & 7);
    if (row0 + r < K) cp_async16(dst, di + (size_t)r * D + ch * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  auto load_unit = [&](int u) {
    if (u < units) {
      const int t = u / nslice;
      const int s = u - t * nslice;
      uint8_t* stage = Bs + (u % S) * kStageBytes;
      const int c0 = t * kTN;
      for (int e = tid; e < kTN * 16; e += kWgThreads) {
        const int col = e >> 4;
        const int ch = e & 15;
        uint8_t* dst = stage + (ch >> 3) * kSubBytes + swz(col, ch & 7);
        if (c0 + col < K) cp_async16(dst, dj + (size_t)(c0 + col) * D + s * kSlice + ch * 8);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < S - 1; ++u) load_unit(u);

  // this thread's rows: g and g + 8 of its warp's 16 in its warpgroup's 64
  const int ra = row0 + wg * 64 + (warp & 3) * 16 + g;
  const int rb = ra + 8;
  const float bias_a = ra < K ? bias[(size_t)img_i * K + ra] : 0.f;
  const float bias_b = rb < K ? bias[(size_t)img_i * K + rb] : 0.f;
  const float inf = __int_as_float(0x7f800000);
  // a masked row's column keys are >= 1e30, which colarg never reports: a
  // warp whose 16 rows are all masked (or past K) adds no column keys
  const bool keys_live =
      __any_sync(0xffffffffu, (ra < K && bias_a < kBig) || (rb < K && bias_b < kBig));
  if (!keys_live)
    for (int c = lane; c < kTN; c += 32) colpart[warp * kTN + c] = ~0ull;
  // running top-2 of each row; with registers to spare (one block an SM)
  // in two chains, even and odd columns, that the epilogue updates
  // independently and that are merged at the end
  constexpr int kChains = S == 2 ? 1 : 2;
  float best_a[2] = {inf, inf}, second_a[2] = {inf, inf};
  float best_b[2] = {inf, inf}, second_b[2] = {inf, inf};
  int arg_a[2] = {0, 0}, arg_b[2] = {0, 0};

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();   // stage u landed for every thread; stage u - 1 consumed
    load_unit(u + S - 1);
    const int t = u / nslice;
    const int s = u - t * nslice;
    const uint8_t* stage = Bs + (u % S) * kStageBytes;

    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kSlice / 16; ++kk) {
      const int sub = kk >> 2;
      const int within = (kk & 3) * 32;
      const uint64_t da = gmma_desc(As + (2 * s + sub) * kSubBytes + wg * 64 * 128 + within);
      const uint64_t db = gmma_desc(stage + sub * kSubBytes + within);
      wgmma_m64n128k16(acc, da, db, (s > 0 || kk > 0) ? 1 : 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (s != nslice - 1) continue;

    // epilogue of column tile t: acc[4i + e] is (row g, column 8i + 2q + e),
    // acc[4i + 2 + e] is (row g + 8, the same column). A column's 16 rows
    // in this warp lie on the 8 lanes of one q; their keys are reduced in
    // quarters of the tile (8 columns a lane) by a reduce-scatter over
    // those lanes: each exchange halves the columns a lane holds, so 7
    // shuffles leave every lane one column's minimum, where a butterfly
    // per column would take 24.
    const int c0 = t * kTN;
    const int b0 = g & 1, b1 = (g >> 1) & 1, b2 = (g >> 2) & 1;
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) {
      unsigned long long key[8];   // key[2 ii + e]: column 8 (4 qt + ii) + 2q + e
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * qt + ii;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * i + 2 * q + e;
          const float bc = col < K ? __ldg(bj + col) : inf;
          const float dist_a = fmaxf(2.f - 2.f * acc[4 * i + e], 0.f) + bc;
          const float dist_b = fmaxf(2.f - 2.f * acc[4 * i + 2 + e], 0.f) + bc;
          push_top2(best_a[e % kChains], second_a[e % kChains], arg_a[e % kChains], dist_a, col);
          push_top2(best_b[e % kChains], second_b[e % kChains], arg_b[e % kChains], dist_b, col);
          const unsigned long long ka =
              ra < K ? ((unsigned long long)__float_as_uint(dist_a + bias_a) << 32) | (unsigned)ra
                     : ~0ull;
          const unsigned long long kb =
              rb < K ? ((unsigned long long)__float_as_uint(dist_b + bias_b) << 32) | (unsigned)rb
                     : ~0ull;
          key[2 * ii + e] = ka < kb ? ka : kb;
        }
      }
      if (!keys_live) continue;
      // lanes g and g ^ 1 (then ^ 2, ^ 4): each keeps the half of its
      // columns its bit of g selects and takes the partner's keys for it
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned long long give = b0 ? key[k] : key[k + 4];
        const unsigned long long keep = b0 ? key[k + 4] : key[k];
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, give, 4);
        key[k] = o < keep ? o : keep;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const unsigned long long give = b1 ? key[k] : key[k + 2];
        const unsigned long long keep = b1 ? key[k + 2] : key[k];
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, give, 8);
        key[k] = o < keep ? o : keep;
      }
      {
        const unsigned long long give = b2 ? key[0] : key[1];
        const unsigned long long keep = b2 ? key[1] : key[0];
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, give, 16);
        key[0] = o < keep ? o : keep;
      }
      // key[0] is entry 4 b0 + 2 b1 + b2 = 2 ii + e of the quarter
      colpart[warp * kTN + 8 * (4 * qt + 2 * b0 + b1) + 2 * q + b2] = key[0];
    }
    __syncthreads();
    if (tid < kTN && c0 + tid < K) {
      unsigned long long m = colpart[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) m = colpart[w * kTN + tid] < m ? colpart[w * kTN + tid] : m;
      atomicMin(&colbest[(size_t)p * K + c0 + tid], m);
    }
  }
  cp_async_wait<0>();

  // one chain per row, then the columns past the last computed tile: all
  // masked, each exactly 1e30
  if (kChains == 2) {
    join_top2(best_a[0], second_a[0], arg_a[0], best_a[1], second_a[1], arg_a[1]);
    join_top2(best_b[0], second_b[0], arg_b[0], best_b[1], second_b[1], arg_b[1]);
  }
  const int cs = n_tiles * kTN;
  if (q == 0 && cs < K) {
    push_top2(best_a[0], second_a[0], arg_a[0], kBig, cs);
    push_top2(best_b[0], second_b[0], arg_b[0], kBig, cs);
    if (K - cs > 1) {
      second_a[0] = fminf(second_a[0], kBig);
      second_b[0] = fminf(second_b[0], kBig);
    }
  }

  // merge the quad's partial top-2s of each row, lowest column on ties
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    merge_top2(best_a[0], second_a[0], arg_a[0], off);
    merge_top2(best_b[0], second_b[0], arg_b[0], off);
  }
  if (q == 0) {
    if (ra < K) {
      const size_t o = (size_t)p * K + ra;
      best_out[o] = best_a[0];
      second_out[o] = second_a[0];
      arg_out[o] = arg_a[0];
    }
    if (rb < K) {
      const size_t o = (size_t)p * K + rb;
      best_out[o] = best_b[0];
      second_out[o] = second_b[0];
      arg_out[o] = arg_b[0];
    }
  }
}

template <int S>
cudaError_t launch_wgmma(const __nv_bfloat16* desc, const float* bias, const int* pairs,
                         const int* extent, int B, int K, int D, float* best, float* second,
                         int* arg, unsigned long long* colbest, size_t smem,
                         cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      knn_top2_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((K + kBand - 1) / kBand, B);
  knn_top2_wgmma_kernel<S><<<grid, kWgThreads, smem, stream>>>(desc, bias, pairs, extent, K,
                                                               D, best, second, arg, colbest);
  return cudaGetLastError();
}

cudaError_t launch(const void* desc, int dtype, const float* bias, const int* pairs,
                   const int* extent, int B, int K, int D, float* best, float* second,
                   int* arg, int* colarg, unsigned long long* colbest, cudaStream_t stream) {
  cudaError_t e =
      cudaMemsetAsync(colbest, 0xff, (size_t)B * K * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  if (dtype == 0) {
    const size_t smem = (size_t)(D + kD) * kLds * sizeof(float);
    // above 48 KB of dynamic shared memory a kernel must opt in (cheap;
    // set on every launch so it holds for whichever device is current)
    e = cudaFuncSetAttribute(knn_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    knn_top2_kernel<<<dim3(K / kTR, B), kThreads, smem, stream>>>(
        static_cast<const float*>(desc), bias, pairs, K, D, best, second, arg, colbest);
  } else {
    int dev = 0, stages = 0, smem = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = wgmma_plan(D, dev, &stages, &smem);
    if (e != cudaSuccess) return e;
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(desc);
    if (stages == 2)
      e = launch_wgmma<2>(d, bias, pairs, extent, B, K, D, best, second, arg, colbest, smem,
                          stream);
    else if (stages == 3)
      e = launch_wgmma<3>(d, bias, pairs, extent, B, K, D, best, second, arg, colbest, smem,
                          stream);
    else
      e = launch_wgmma<4>(d, bias, pairs, extent, B, K, D, best, second, arg, colbest, smem,
                          stream);
  }
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * K;
  knn_colarg_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(colbest, colarg, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 descriptors, 1 = bfloat16. desc (N, K, D) row-major,
// bias (N, K) float32, pairs (B, 2) int32, extent (N,) int32 (bf16 only:
// last valid slot + 1 of each image, 0 for none), outputs (B, K); colbest
// is (B, K) 64-bit scratch. K must be a multiple of 64, D a multiple of
// 128 up to 512; 0 < B <= 65535. Returns the CUDA status of the launches
// (0 = success).
int knn_top2_launch(const void* desc, int dtype, const float* bias, const int* pairs,
                    const int* extent, int B, int K, int D, float* best, float* second,
                    int* arg, int* colarg, unsigned long long* colbest, void* stream) {
  if (K <= 0 || K % kTC != 0 || B <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && extent == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(desc, dtype, bias, pairs, extent, B, K, D, best, second, arg, colarg,
                     colbest, static_cast<cudaStream_t>(stream));
}

// the bf16 kernel's launch at width D on `device`: out[0] pipeline stages,
// out[1] dynamic shared memory bytes. Returns the CUDA status.
int knn_top2_wgmma_plan(int D, int device, int* out) {
  if (D <= 0 || D % kD != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  return (int)wgmma_plan(D, device, &out[0], &out[1]);
}

const char* knn_top2_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
