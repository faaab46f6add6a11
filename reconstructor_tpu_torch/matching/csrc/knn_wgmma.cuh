// The bf16 tensor-core product shared by the top-2 kNN kernels for Hopper
// (sm_90a): knn_top2.cu (the top-2 kNN kernel), knn_packed.cu (its
// packed-int32 variant) and scripts/csrc/knn_levels.cu (the kernel split
// level by level).
//
// The product, one block of two warpgroups per (pair, 128 rows of image i):
// - the band's bf16 descriptors stay in shared memory, all D channels, in
//   the 128-byte-swizzled K-major layout that wgmma descriptors read
//   (load_band);
// - image j streams through a ring of S shared-memory stages of 128
//   columns x 128 channels, filled by cp.async so the next stage's copy
//   overlaps the current product (ring_load);
// - each stage is multiplied by wgmma.mma_async m64n128k16 (bf16 in,
//   float32 accumulators in registers) in one fixed k-step order
//   (mma_slice), so every kernel that calls it computes the same float
//   for every (row, column) of a pair;
// - wgmma_plan picks S and the dynamic shared memory for width D, the same
//   for all three kernels.
// The accumulator layout the epilogues read: acc[4i + e] is (row g,
// column 8i + 2q + e) and acc[4i + 2 + e] is (row g + 8, the same column),
// with g = lane / 4, q = lane % 4, in the warp's 16 rows of its
// warpgroup's 64. The epilogues live in the kernels; the row top-2 and
// packed-key helpers and the reduce-scatter of column keys that they share
// are here. knn_top2.cu takes the constants, the instruction wrappers,
// the row top-2 helpers and the plan from here, but writes its band load,
// ring, product loop and reduce-scatter inline, the same instructions in
// the same order: calling these functions changed its compiled code
// (registers, spills), which is held as it was. The packed and level
// kernels call them.
//
// The build hashes a kernel source together with every file it includes
// with quotes (utils/cuda_build.py), so an edit here rebuilds all three.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn_wgmma {

constexpr int kBand = 128;         // rows of image i per block (two warpgroups)
constexpr int kTN = 128;           // columns of image j per tile
constexpr int kSlice = 128;        // channels per pipeline stage
constexpr int kWgThreads = 256;
constexpr int kSubBytes = 128 * 128;           // 128 rows x 64 channels of bf16
constexpr int kStageBytes = 2 * kSubBytes;     // 128 columns x 128 channels
constexpr int kColpartBytes = 8 * kTN * 8;     // 8 warps x 128 columns of 64-bit keys

// packed keys: distances in [0, 4] scaled by 2^17 into 19 bits, shifted
// over a 12-bit slot; kDmax marks a masked slot
constexpr int kDmax = (1 << 19) - 1;
constexpr float kScale = 131072.f;  // 2^17
constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory written by this thread (cp.async, stores) visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a K-major operand in the 128-byte swizzle: rows of 64 channels (128 B)
// at a 128 B pitch, 8-row atoms 1024 B apart (stride byte offset); the
// leading byte offset is unused for this layout
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of the 16-byte chunk c8 (0..7) of row r in a swizzled sub-block
__device__ __forceinline__ int swz(int r, int c8) { return r * 128 + ((c8 ^ (r & 7)) << 4); }

// the band: 128 rows x D channels from di (rows past K - row0 read as 0)
// into As[D / 64][128 rows][128 B], by cp.async (committed with the ring's
// first group)
__device__ __forceinline__ void load_band(uint8_t* As, const __nv_bfloat16* di, int row0, int K,
                                          int D, int tid) {
  const int chunks = D / 8;
  for (int e = tid; e < kBand * chunks; e += kWgThreads) {
    const int r = e / chunks;
    const int ch = e - r * chunks;
    uint8_t* dst = As + (ch >> 3) * kSubBytes + swz(r, ch & 7);
    if (row0 + r < K) cp_async16(dst, di + (size_t)r * D + ch * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// unit u of the ring (column tile u / nslice, channel slice u % nslice of
// image j) into stage u % S (columns past K read as 0); a unit at or past
// `units` loads nothing, but every call commits one cp.async group so the
// consumer's wait count stays fixed
template <int S>
__device__ __forceinline__ void ring_load(uint8_t* Bs, const __nv_bfloat16* dj, int K, int D,
                                          int nslice, int units, int u, int tid) {
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
}

// acc += warpgroup wg's 64 band rows x the stage's 128 columns over channel
// slice s (acc is overwritten at s == 0); returns with the product done
__device__ __forceinline__ void mma_slice(float (&acc)[64], const uint8_t* As,
                                          const uint8_t* stage, int wg, int s) {
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
}

// the stages and dynamic shared memory at width D: D = 128 takes two
// stages, so that two blocks share an SM; wider, up to 4. The shared
// memory holds the band, the ring, 8 warps x 128 column keys of 64 bits
// and 1024 bytes of alignment slack.
inline cudaError_t wgmma_plan(int D, int device, int* stages, int* smem) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const int fixed = (D / 64) * kSubBytes + kColpartBytes + 1024;   // + alignment slack
  int s = D == 128 ? 2 : (optin - fixed) / kStageBytes;
  s = s > 4 ? 4 : s;
  if (s < 2) return cudaErrorInvalidConfiguration;
  *stages = s;
  *smem = fixed + s * kStageBytes;
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// epilogue helpers
// ---------------------------------------------------------------------

__device__ __forceinline__ void push_top2(float& best, float& second, int& arg, float d,
                                          int col) {
  if (d < best) {
    second = best;
    best = d;
    arg = col;
  } else {
    second = fminf(second, d);
  }
}

// fold the partial top-2 (ob, os, oa) into (best, second, arg), lowest
// column on ties
__device__ __forceinline__ void join_top2(float& best, float& second, int& arg, float ob,
                                          float os, int oa) {
  if (ob < best || (ob == best && oa < arg)) {
    second = fminf(os, best);
    best = ob;
    arg = oa;
  } else {
    second = fminf(second, ob);
  }
}

// merge the partial top-2 of lane ^ off into this lane's
__device__ __forceinline__ void merge_top2(float& best, float& second, int& arg, int off) {
  const float ob = __shfl_xor_sync(0xffffffffu, best, off);
  const float os = __shfl_xor_sync(0xffffffffu, second, off);
  const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
  join_top2(best, second, arg, ob, os, oa);
}

// the TPU kernels' quantisation of one similarity: (int) clip((2 - 2 sim)
// * 2^17, 0, hi). __fmul_rn / __fadd_rn keep any FMA contraction from
// moving a step: the products by -2 and 2^17 are exact, so the one
// rounding is the subtraction's, as on the TPU
__device__ __forceinline__ int quantise(float sim, int hi) {
  float t = __fmul_rn(__fadd_rn(2.f, __fmul_rn(-2.f, sim)), kScale);
  t = fminf(fmaxf(t, 0.f), (float)hi);
  return __float2int_rz(t);
}

// a row's two smallest packed keys. The keys of a row are distinct (each
// holds its column), so one int min is value and lowest-column argmin,
// and no tie rule is needed
__device__ __forceinline__ void push_key(int& best, int& second, int key) {
  second = min(second, max(best, key));
  best = min(best, key);
}

// merge the two smallest keys of lane ^ off into this lane's
__device__ __forceinline__ void merge_keys(int& best, int& second, int off) {
  const int ob = __shfl_xor_sync(0xffffffffu, best, off);
  const int os = __shfl_xor_sync(0xffffffffu, second, off);
  second = min(min(second, os), max(best, ob));
  best = min(best, ob);
}

// A quarter tile's column keys (64-bit distance keys or 32-bit packed
// ones): key[2 ii + e] is the smaller of this lane's two rows' keys for
// column 8 (4 qt + ii) + 2q + e of the tile. A column's 16 rows in the
// warp lie on the 8 lanes of one q; each exchange between them halves the
// columns a lane holds (the half its bit of g selects, taking the
// partner's keys for it), so 7 shuffles leave every lane the warp's
// minimum of one column, where a butterfly per column would take 24.
// Returns that minimum; scatter_col gives its column in the tile.
template <typename Key>
__device__ __forceinline__ Key reduce_scatter8(Key (&key)[8], int g) {
  const int b0 = g & 1, b1 = (g >> 1) & 1, b2 = (g >> 2) & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Key give = b0 ? key[k] : key[k + 4];
    const Key keep = b0 ? key[k + 4] : key[k];
    const Key o = __shfl_xor_sync(0xffffffffu, give, 4);
    key[k] = o < keep ? o : keep;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Key give = b1 ? key[k] : key[k + 2];
    const Key keep = b1 ? key[k + 2] : key[k];
    const Key o = __shfl_xor_sync(0xffffffffu, give, 8);
    key[k] = o < keep ? o : keep;
  }
  const Key give = b2 ? key[0] : key[1];
  const Key keep = b2 ? key[1] : key[0];
  const Key o = __shfl_xor_sync(0xffffffffu, give, 16);
  return o < keep ? o : keep;
}

// the column (in the tile) of reduce_scatter8's result: entry
// 4 b0 + 2 b1 + b2 = 2 ii + e of quarter qt
__device__ __forceinline__ int scatter_col(int qt, int g, int q) {
  return 8 * (4 * qt + 2 * (g & 1) + ((g >> 1) & 1)) + 2 * q + ((g >> 2) & 1);
}

}  // namespace knn_wgmma
