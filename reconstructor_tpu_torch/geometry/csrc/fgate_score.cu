// Inlier counts of the F-gate's hypotheses, scored in one launch, for
// Hopper (sm_90a): kernel 7.
//
// Replaces no Pallas kernel: the JAX package scores its hypotheses with
// plain jnp (reconstructor_tpu/geometry/fgate.py, filter_pairs_scalarized),
// which XLA fuses into one loop, so the TPU never holds the scores. The
// port ran the same arithmetic eagerly: each of _sampson9's ~34 float
// operations, then `d < thr`, `& mask` and the sum, wrote a (B, H, S)
// tensor to device memory (B = 512 pairs, H = 512 hypotheses, S = 960
// strided slots: ~1 GB each, ~71 GB a chunk). This kernel does what XLA's
// fusion did: the scores live in registers and only the counts are
// written.
//
// Function: counts[b, h] = number of strided slots j (slot k = j * stride
// < K) with mask[b, k] set and sampson(f[b, h], pts1[b, k], pts2[b, k])
// < thr, where sampson is geometry/cuda_fgate.py::sampson9 in its exact
// order of operations:
//   l1 = (f00 x1 + f01 y1) + f02, l2 = (f10 x1 + f11 y1) + f12,
//   l3 = (f20 x1 + f21 y1) + f22, m1 = (f00 x2 + f10 y2) + f20,
//   m2 = (f01 x2 + f11 y2) + f21, e = (x2 l1 + y2 l2) + l3,
//   denom = ((l1 l1 + l2 l2) + m1 m1) + m2 m2,
//   d = (e e) / max(denom, 1e-12)   (a NaN denom stays NaN, as torch.clamp)
// Every product, sum and the quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn: nvcc would otherwise contract a*b+c
// into one fma), so each d, and every count, equals the plain chain's bit
// for bit, and the argmax over hypotheses picks the same winner.
//
// What bounds it on an H100: float32 operations. At the cell's chunk
// ~252 M Sampson evaluations of ~35 operations (~8.8 GFLOP, ~0.13 ms at
// 67 TF/s); it reads only the chunk's points, masks and hypotheses (~33 MB)
// and writes B x H counts.
//
// The design: a block of THREADS threads takes THREADS hypotheses of one
// pair (grid: ceil(H / THREADS) x B), each thread one hypothesis's nine
// entries in registers. The block stages the pair's strided slots TILE at
// a time: each thread tests PER consecutive slots' masks, a block prefix
// scan (warp shuffles, then the warps' totals) gives each valid slot its
// place, and the valid slots are written in slot order, compacted, to
// shared memory as float4 (x1, y1, x2, y2), so masked slots cost nothing.
// Then every thread walks the staged slots; all threads read the same slot
// at once, which shared memory serves as a broadcast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;             // strided slots staged at once
constexpr int PER = TILE / THREADS;    // slots each thread tests

__device__ __forceinline__ float lin(float a, float x, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__global__ void __launch_bounds__(THREADS)
sampson_count_kernel(const float* __restrict__ f, const float* __restrict__ pts1,
                     const float* __restrict__ pts2, const unsigned char* __restrict__ mask,
                     int H, int K, int stride, float thr, int64_t* __restrict__ counts) {
  __shared__ float4 slots[TILE];
  __shared__ int warp_total[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y;
  const int h = blockIdx.x * THREADS + t;
  const bool live = h < H;

  float F[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) F[i] = live ? __ldg(f + ((int64_t)b * H + h) * 9 + i) : 0.f;

  const float* p1 = pts1 + (int64_t)b * K * 2;
  const float* p2 = pts2 + (int64_t)b * K * 2;
  const unsigned char* m = mask + (int64_t)b * K;
  const int S = (K + stride - 1) / stride;
  int count = 0;

  for (int t0 = 0; t0 < S; t0 += TILE) {
    // which of this thread's PER slots are valid, and where they go
    const int j0 = t0 + t * PER;
    bool valid[PER];
    int nv = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = j0 + q;
      valid[q] = j < S && __ldg(m + (int64_t)j * stride) != 0;
      nv += valid[q];
    }
    int incl = nv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int pos = incl - nv, n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_total[w];
      pos += w < warp ? s : 0;
      n += s;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (valid[q]) {
        const int64_t k = (int64_t)(j0 + q) * stride;
        slots[pos++] = make_float4(__ldg(p1 + 2 * k), __ldg(p1 + 2 * k + 1),
                                   __ldg(p2 + 2 * k), __ldg(p2 + 2 * k + 1));
      }
    }
    __syncthreads();

    if (live) {
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float4 p = slots[s];
        const float l1 = lin(F[0], p.x, F[1], p.y, F[2]);
        const float l2 = lin(F[3], p.x, F[4], p.y, F[5]);
        const float l3 = lin(F[6], p.x, F[7], p.y, F[8]);
        const float m1 = lin(F[0], p.z, F[3], p.w, F[6]);
        const float m2 = lin(F[1], p.z, F[4], p.w, F[7]);
        const float e = lin(p.z, l1, p.w, l2, l3);
        float den = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(l1, l1), __fmul_rn(l2, l2)),
                                        __fmul_rn(m1, m1)),
                              __fmul_rn(m2, m2));
        den = den < 1e-12f ? 1e-12f : den;
        count += __fdiv_rn(__fmul_rn(e, e), den) < thr;
      }
    }
    __syncthreads();   // the next tile overwrites slots and warp_total
  }
  if (live) counts[(int64_t)b * H + h] = count;
}

}  // namespace

extern "C" {

// f (B, H, 9) float32; pts1, pts2 (B, K, 2) float32; mask (B, K) bool (one
// byte a slot); counts (B, H) int64; all contiguous. B <= 65535. Returns
// the launch's cudaError_t (0: launched, or nothing to launch).
int sampson_count_launch(const float* f, const float* pts1, const float* pts2,
                         const unsigned char* mask, int B, int H, int K, int stride, float thr,
                         int64_t* counts, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const dim3 grid((H + THREADS - 1) / THREADS, B);
  sampson_count_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(f, pts1, pts2, mask, H, K,
                                                                    stride, thr, counts);
  return (int)cudaGetLastError();
}

const char* sampson_count_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
