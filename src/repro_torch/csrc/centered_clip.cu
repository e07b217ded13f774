// One unmasked CenteredClip iteration for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel centered_clip_iter_fwd of
// src/repro/kernels/centered_clip/kernel.py:48:
//
//   out = v + mean_i (x_i - v) * min(1, tau / max(|x_i - v|, 1e-12))
//
// x (k, D) float32, the compacted survivors of a sequential round
// (1 <= k <= 64); v (D,) float32 -> out (D,).  The norm is each row's full
// L2 norm over all D columns.  tau is fixed, or adaptive: the median of the
// k row norms, the midpoint of the two middle ranks for an even k
// (jnp.median, reference core/aggregation.py:134).
//
// Bound on an H100: device memory.  At the sequential engine's shape
// (k = 10, D = 162,417,408) the function reads x once and v and writes out:
// (k + 2) * D * 4 bytes = 7.80 GB -> 2.33 ms at 3.35 TB/s; about 4
// operations a float read.
//
// Design: the TPU kernel walks its grid in order and carries the squared
// norms in VMEM scratch from the first pass over x to the second.  Here
// blocks run in parallel, so, as masked_cc_iter_f32 in masked_agg.cu, the
// iteration is three launches on the caller's stream with no host sync and
// no atomics (two launches give the same bits):
//   (a) cc_sqnorm_partial (agg_common.cuh): per-(row, block) partial squared
//       norms, shape (k, n_blocks);
//   (b) one block adds the partials in block order, takes the norms, tau
//       (the same sorting network over the k norms) and the k scales;
//   (c) one thread per column: out = v + (sum_i (x_i - v) * s_i) * (1 / k),
//       rows in order, round-to-nearest multiply and add in the sum, and
//       the last multiply and add of v fused into one rounding.
// The mean multiplies the sum by a float32 1/k, and the add of v is fused
// with it, as XLA compiles the reference's body; masked_cc_iter divides the masked sum by k,
// which rounds differently, so this kernel has its own entry point and its
// own plain version.
//
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "agg_common.cuh"

namespace {

template <int NP>
__global__ void __launch_bounds__(kThreads)
cc_dense_finalize(const float* __restrict__ partial, int nblk, int n, float tau_fixed,
                  int adaptive, float* __restrict__ s_out) {
  __shared__ float sq[NP];
  sum_partials<NP>(partial, nblk, n, sq);
  if (threadIdx.x != 0) return;
  float nrm[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) nrm[i] = i < n ? sqrtf(sq[i]) : INFINITY;
  float tau = tau_fixed;
  if (adaptive) {
    float v[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) v[i] = nrm[i];
    oddeven_sort<NP>(v);
    tau = rank_mid<NP>(v, n);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i < n) s_out[i] = clip_scale(tau, nrm[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
cc_dense_apply(const float* __restrict__ x, const float* __restrict__ v,
               const float* __restrict__ s, float* __restrict__ out, int n, long long d) {
  __shared__ float ss[kMaxN];
  __shared__ float inv_k;
  if (threadIdx.x < n) ss[threadIdx.x] = s[threadIdx.x];
  if (threadIdx.x == 0) inv_k = __fdiv_rn(1.f, (float)n);
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const float vc = v[c];
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const float df = __fsub_rn(x[(long long)i * d + c], vc);
    acc = __fadd_rn(acc, __fmul_rn(df, ss[i]));
  }
  out[c] = __fmaf_rn(acc, inv_k, vc);
}

template <int NP>
struct CcDenseLaunch {
  static cudaError_t run(const float* x, const float* v, float* out, float* partial, int nblk,
                         float* scales, int n, long long d, float tau, int adaptive,
                         cudaStream_t s) {
    const long long chunk = (d + nblk - 1) / nblk;
    cc_sqnorm_partial<NP><<<nblk, kThreads, 0, s>>>(x, v, partial, n, d, chunk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cc_dense_finalize<NP><<<1, kThreads, 0, s>>>(partial, nblk, n, tau, adaptive, scales);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cc_dense_apply<<<blocks_for(d, kThreads), kThreads, 0, s>>>(x, v, scales, out, n, d);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// partial: (n, nblk) float scratch; scales: (n,) float scratch.
int cc_iter_f32(const void* x, const void* v, void* out, void* partial, int nblk, void* scales,
                int n, long long d, float tau, int adaptive, void* stream) {
  if (n < 1 || n > kMaxN || nblk < 1 || d < 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch_np<CcDenseLaunch>(n, (const float*)x, (const float*)v, (float*)out,
                                         (float*)partial, nblk, (float*)scales, n, d, tau,
                                         adaptive, (cudaStream_t)stream);
}

}  // extern "C"
