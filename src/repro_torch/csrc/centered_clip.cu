// Unmasked CenteredClip iterations for Hopper (sm_90a), as a chain.
// cc_chain_f32 replaces the Pallas TPU kernel
// centered_clip_iter_fwd of src/repro/kernels/centered_clip/kernel.py:48,
// one iteration of
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
// (k = 10, D = 162,417,408) the chain reads x and v0 once and writes v_T:
// (k + 2) * D * 4 bytes = 7.80 GB -> 2.33 ms at 3.35 TB/s for any number
// of iterations (0.78 ms an iteration at the aggregator's 3); about 5
// operations an element an iteration.  The chain forms each iteration's
// norms from x and the previous output, so it reads the stack iters + 1
// times, its dependency floor: ((iters + 1) k D + (2 iters + 1) D) * 4
// bytes = 30.53 GB -> 9.115 ms for 3, 3.04 ms an iteration
// (agg_common.cuh names a two-read form).
//
// Design: the TPU kernel walks its grid in order and carries the squared
// norms in VMEM scratch from the first pass over x to the second.  Here
// blocks run in parallel, so, as masked_agg.cu's chain, iters iterations
// from v0 are 1 + 2 iters launches on the caller's stream with no host sync
// and no atomics, reading the stack iters + 1 times (agg_common.cuh):
//   (a) cc_norm_pass: per-(row, block) partial squared norms, shape
//       (k, n_blocks), 16-byte loads where the layout allows;
//   (b) cc_dense_finalize, one block: adds the partials in block order,
//       takes the norms, tau (the same sorting network over the k norms)
//       and the k scales;
//   (c) cc_apply_pass: out = v + (sum_i (x_i - v) * s_i) * (1 / k), rows in
//       order, round-to-nearest multiply and add in the sum, and the last
//       multiply and add of v fused into one rounding; then, but for the
//       last iteration, the next partial squared norms from the rows it
//       holds.
// The mean multiplies the sum by a float32 1/k, and the add of v is fused
// with it, as XLA compiles the reference's body; masked_cc_iter divides the
// masked sum by k, which rounds differently, so this file has its own entry
// point and its own plain version.  The wrapper's single iteration
// (cc_iter) is the chain at iters = 1, bit-equal to one step of a longer
// chain.
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

// (c)'s last step: acc * (1 / k) + v in one rounding
struct DenseMean {
  static __device__ __forceinline__ float scalar(const float*, int n) {
    return __fdiv_rn(1.f, (float)n);
  }
  static __device__ __forceinline__ float apply(float acc, float inv_k, float vc) {
    return __fmaf_rn(acc, inv_k, vc);
  }
};

template <int NP>
struct CcDenseChainLaunch {
  static cudaError_t run(const float* x, const float* v0, float* out, float* partial, int nblk,
                         long long chunk, int vec, float* scales, int n, long long d, int iters,
                         float tau, int adaptive, cudaStream_t s) {
    auto fin = [=](cudaStream_t st) {
      cc_dense_finalize<NP><<<1, kThreads, 0, st>>>(partial, nblk, n, tau, adaptive, scales);
    };
    return run_chain_vec<NP, DenseMean>(vec, x, v0, out, partial, nblk, chunk, scales, nullptr,
                                        n, d, iters, fin, s);
  }
};

}  // namespace

extern "C" {

// iters >= 1 CenteredClip iterations from v0 into out, on the layout
// (nblk, chunk, vec) of chain_plan (kernels/cc_chain.py).  partial:
// (n, nblk) float scratch; scales: (n,) float scratch.
int cc_chain_f32(const void* x, const void* v0, void* out, void* partial, int nblk,
                 long long chunk, int vec, void* scales, int n, long long d, int iters,
                 float tau, int adaptive, void* stream) {
  if (iters < 1 || !chain_layout_ok(n, d, nblk, chunk, vec, x, v0, out))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_np<CcDenseChainLaunch>(n, (const float*)x, (const float*)v0, (float*)out,
                                              (float*)partial, nblk, chunk, vec, (float*)scales,
                                              n, d, iters, tau, adaptive, (cudaStream_t)stream);
}

}  // extern "C"
