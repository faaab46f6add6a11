// PCG's 3 x 3 point-block products, out[l] = H_pp^-1[l] v[l] over every
// landmark in one streaming pass, for Hopper (sm_90a): kernel 8.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (reconstructor_tpu/ba/distributed.py:120, the rhs :127, the point step
// :142). The port ran each as torch.einsum("lij,lj->li") on a strided
// (L, 3, 3) view of the inverse's planes, which PyTorch turns into a copy
// of the blocks and a cuBLAS batched gemv with one 3 x 3 problem a batch
// entry: ~0.85-1.1 ns a landmark whatever the bytes, once every CG
// iteration and twice a trial (ba/distributed.py, _schur_matvec and
// _lm_step_pcg).
//
// Function: h9 (9, L) float32, plane 3 i + j holding entry (i, j) of every
// landmark's block (ba/lm.py::_inv3x3_soa's layout, read in place); v and
// out (L, 3) float32, contiguous:
//   out[l, i] = (fma(a1, x1, a0 x0) + a2 x2) + 0    with a_j = h9[3i + j, l],
//                                                    x_j = v[l, j]
// That order is the kernel's contract. A float32 solve is sensitive to the
// last bit: a change of rounding anywhere in PCG moves the LM iterations a
// solve takes, which decide its time more than any speed-up. So every
// product, fma and sum is written with __fmul_rn / __fmaf_rn / __fadd_rn,
// which nvcc neither contracts nor reorders, and the result is fixed by
// the inputs alone (cuda_blocks.block3_matvec_reference computes it on any
// device). The order is the one the einsum it replaces took on an H100
// (torch 2.11.0+cu128) at the benchmark's L = 2^20 and 2^23, where kernel 8
// equals it bit for bit; the final + 0 is that einsum's epilogue (it never
// returned -0). cuBLAS's batched gemv split the dot product otherwise,
// (fma(a2, x2, a0 x0) + a1 x1) + 0, for a last chunk of 12,998 .. 37,292
// of its 65,535-problem chunks (e.g. L = 2^14); kernel 8 does not follow
// that dispatch, so there its last bits differ from the retired einsum's.
//
// What bounds it on an H100: bytes. Each landmark reads 9 + 3 floats and
// writes 3 (60 B; 503 MB at L = 8,388,608, 0.150 ms at 3.35 TB/s); there
// is no reuse. The design: one thread a landmark, so a warp reads 128
// contiguous bytes of each of the 9 plane streams and 384 of v, and writes
// 384 of out. It runs at ~90% of the bound at L = 8,388,608; a variant
// with 16-byte loads (a thread 4 landmarks) measured the same within 0.5%.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// One output: (fma(a1, x1, a0 x0) + a2 x2) + 0.
__device__ __forceinline__ float row3(float a0, float a1, float a2, float x0, float x1,
                                      float x2) {
  return __fadd_rn(__fadd_rn(__fmaf_rn(a1, x1, __fmul_rn(a0, x0)), __fmul_rn(a2, x2)), 0.f);
}

__global__ void __launch_bounds__(THREADS)
block3_matvec_kernel(const float* __restrict__ h9, const float* __restrict__ v,
                     float* __restrict__ out, int64_t L) {
  const int64_t l = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = __ldg(h9 + k * L + l);
  const float x = __ldg(v + 3 * l), y = __ldg(v + 3 * l + 1), z = __ldg(v + 3 * l + 2);
  float* o = out + 3 * l;
  o[0] = row3(h[0], h[1], h[2], x, y, z);
  o[1] = row3(h[3], h[4], h[5], x, y, z);
  o[2] = row3(h[6], h[7], h[8], x, y, z);
}

}  // namespace

extern "C" {

// h9 (9, L), v (L, 3), out (L, 3): float32, contiguous, on one card.
// Returns the launch's cudaError_t (0: launched; L = 0 launches nothing).
int block3_matvec_launch(const float* h9, const float* v, float* out, long long L,
                         void* stream) {
  if (L <= 0) return 0;
  block3_matvec_kernel<<<(unsigned)((L + THREADS - 1) / THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(h9, v, out, L);
  return (int)cudaGetLastError();
}

const char* block3_matvec_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
