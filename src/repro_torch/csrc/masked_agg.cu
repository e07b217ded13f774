// Masked robust aggregation over an (N, D) float32 update stack, for Hopper
// (sm_90a).  Three kernels replace the Pallas TPU kernels of
// src/repro/kernels/masked_agg/kernel.py:
//
//   masked_median_f32    <- masked_median_fwd   (kernel.py:133)
//   masked_cc_chain_f32  <- masked_cc_iter_fwd  (kernel.py:192)
//   masked_krum_d2_f32   <- masked_krum_d2_fwd  (kernel.py:234)
//
// All three are bound by device memory on an H100 (3.35 TB/s): at the swarm
// round's shapes (N = 10, D = 162,417,408) each reads the stack once or
// twice and does a few operations per byte.  Bounds, counting each input
// read once and each output written once:
//   median   (N + 1) * D * 4 bytes  = 7.15 GB -> 2.13 ms
//   cc_chain (N + 2) * D * 4 bytes  = 7.80 GB -> 2.33 ms, for any iters
//            (x and v0 read, v_T written: 0.78 ms an iteration at 3)
//   krum_d2  N * D * 4 bytes        = 6.50 GB -> 1.94 ms
//            (2 N^2 D = 32.5 GFLOP at 67 TFLOP/s fp32 is 0.49 ms, below it)
// The chain forms each iteration's norms from x and the previous output,
// so it reads the stack iters + 1 times, its dependency floor:
// ((iters + 1) N D + (2 iters + 1) D) * 4 bytes = 30.53 GB -> 9.115 ms for
// 3 iterations, 3.04 ms an iteration (agg_common.cuh names a two-read form).
//
// Design.  On the TPU one core walks the grid in order and carries sums in
// VMEM scratch; here blocks run in parallel with nothing carried between
// them, so every cross-column reduction is split into per-block partials
// and a second pass that adds them in a fixed order (deterministic, no
// atomics).
//
// - median: one thread per column.  It loads the N values of its column
//   (neighbouring threads read neighbouring addresses of each row), puts
//   +inf in masked and padding slots, sorts NP = next_pow2(N) values in
//   registers with Batcher's odd-even merge network (the compare-exchange
//   order of oddeven_merge_pairs in kernel.py), and selects the two middle
//   ranks of the kept count k: (v[(k-1)/2] + v[k/2]) * 0.5, NaN for k = 0.
//   A compare-exchange swaps iff b < a, so the sort is a permutation and the
//   result is bit-equal to the plain version, signed zeros included.
// - cc_chain: iters >= 1 iterations from v0 in 1 + 2 iters launches on
//   the device with no host sync, reading the stack iters + 1 times (the
//   chain of agg_common.cuh):
//   (a) cc_norm_pass: per-block partial squared norms sum_c (x_ic - v_c)^2,
//       shape (N, n_blocks), 16-byte loads where the layout allows;
//   (b) cc_finalize, one block: adds the partials in block order, takes the
//       norms, the adaptive tau (the masked median of the norms, same
//       network), the kept count k and the per-node weights w_i = m_i *
//       min(1, tau / max(|x_i - v|, 1e-12)).  NaN propagates as in
//       torch.minimum;
//   (c) cc_apply_pass: out = v + (sum_i (x_i - v) * w_i) / k, in node order
//       with round-to-nearest mul and add (no contraction), the plain
//       version's exact arithmetic; then, but for the last iteration, the
//       next partial squared norms from the rows it holds.
//   The wrapper's single iteration (masked_cc_iter) is the chain at
//   iters = 1, bit-equal to one step of a longer chain.
// - krum_d2: each block walks its own run of 128-column tiles, stages each
//   tile in shared memory (rows padded by one word against bank
//   conflicts), and accumulates the upper triangle of the N x N gram
//   matrix with fp32 FMAs, one pair per thread: a sum per tile, then the
//   tile sums (a run of ~1e5 columns summed in one register would lose
//   ~1e-5 of the squared norms).  A one-block pass adds the
//   block partials in block order and forms d2_ij = G_ii + G_jj - 2 G_ij.
//   No tensor cores and no TF32.
//
// N <= 64 for every kernel (NP in {2, ..., 64}); the Python wrapper raises
// above.  Each entry point returns cudaGetLastError().  The sorting network,
// the chain's passes and the clip scale are shared with centered_clip.cu
// (agg_common.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "agg_common.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kMaxPairsPerThread = (kMaxN * (kMaxN + 1) / 2 + kThreads - 1) / kThreads;

template <int NP>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              float* __restrict__ out, int n, long long d) {
  __shared__ float sm[kMaxN];
  if (threadIdx.x < kMaxN) sm[threadIdx.x] = threadIdx.x < n ? mask[threadIdx.x] : 0.f;
  __syncthreads();
  int k = 0;
  for (int i = 0; i < n; ++i) k += sm[i] > 0.f;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float v[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) v[i] = (i < n && sm[i] > 0.f) ? x[(long long)i * d + c] : INFINITY;
  oddeven_sort<NP>(v);
  out[c] = rank_mid<NP>(v, k);
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
cc_finalize(const float* __restrict__ partial, int nblk, const float* __restrict__ mask,
            int n, float tau_fixed, int adaptive, float* __restrict__ w_out,
            float* __restrict__ k_out) {
  __shared__ float sq[NP];
  sum_partials<NP>(partial, nblk, n, sq);
  if (threadIdx.x != 0) return;
  float nrm[NP], m[NP];
  int kept = 0;
  float ksum = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    m[i] = i < n ? mask[i] : 0.f;
    nrm[i] = i < n ? sqrtf(sq[i]) : 0.f;
    if (i < n) {
      kept += m[i] > 0.f;
      ksum += m[i];
    }
  }
  float tau = tau_fixed;
  if (adaptive) {
    float v[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) v[i] = (i < n && m[i] > 0.f) ? nrm[i] : INFINITY;
    oddeven_sort<NP>(v);
    tau = rank_mid<NP>(v, kept);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i < n) w_out[i] = __fmul_rn(clip_scale(tau, nrm[i]), m[i]);
  }
  k_out[0] = ksum < 1.f ? 1.f : ksum;
}

// (c)'s last step: v + acc / k, k the kept count clamped to >= 1 (cc_finalize's kf)
struct MaskedMean {
  static __device__ __forceinline__ float scalar(const float* kf, int) { return kf[0]; }
  static __device__ __forceinline__ float apply(float acc, float k, float vc) {
    return __fadd_rn(vc, __fdiv_rn(acc, k));
  }
};

__device__ __forceinline__ void pair_of(int p, int n, int& i, int& j) {
  i = 0;
  while (p >= n - i) {
    p -= n - i;
    ++i;
  }
  j = i + p;
}

__global__ void __launch_bounds__(kThreads)
krum_gram_partial(const float* __restrict__ x, float* __restrict__ partial, int n,
                  long long d, long long chunk) {
  __shared__ float tile[kMaxN][kTile + 1];
  const int npairs = n * (n + 1) / 2;
  int pi[kMaxPairsPerThread], pj[kMaxPairsPerThread];
  float acc[kMaxPairsPerThread];
#pragma unroll
  for (int q = 0; q < kMaxPairsPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    pi[q] = pj[q] = 0;
    if (p < npairs) pair_of(p, n, pi[q], pj[q]);
    acc[q] = 0.f;
  }
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(d, start + chunk);
  for (long long t0 = start; t0 < end; t0 += kTile) {
    const int cols = (int)min((long long)kTile, end - t0);
    for (int idx = threadIdx.x; idx < n * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx % kTile;
      tile[r][c] = c < cols ? x[(long long)r * d + t0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxPairsPerThread; ++q) {
      if (threadIdx.x + q * kThreads < npairs) {
        const float* a = tile[pi[q]];
        const float* b = tile[pj[q]];
        float s = 0.f;  // per-tile sum first: two short sums round less than one long one
        for (int c = 0; c < kTile; ++c) s = fmaf(a[c], b[c], s);
        acc[q] += s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kMaxPairsPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    if (p < npairs) partial[(long long)blockIdx.x * npairs + p] = acc[q];
  }
}

__global__ void __launch_bounds__(kThreads)
krum_d2_finalize(const float* __restrict__ partial, int nblk, int n, float* __restrict__ d2) {
  __shared__ float g[kMaxN * (kMaxN + 1) / 2];
  const int npairs = n * (n + 1) / 2;
  for (int p = threadIdx.x; p < npairs; p += kThreads) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += partial[(long long)b * npairs + p];
    g[p] = s;
  }
  __syncthreads();
  // index of pair (i, j), i <= j, in the row-major upper triangle
  auto at = [n](int i, int j) { return i * n - i * (i - 1) / 2 + (j - i); };
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    const float gij = i <= j ? g[at(i, j)] : g[at(j, i)];
    d2[e] = __fsub_rn(__fadd_rn(g[at(i, i)], g[at(j, j)]), __fmul_rn(2.f, gij));
  }
}

template <int NP>
struct MedianLaunch {
  static cudaError_t run(const float* x, const float* mask, float* out, int n, long long d,
                         cudaStream_t s) {
    median_kernel<NP><<<blocks_for(d, kThreads), kThreads, 0, s>>>(x, mask, out, n, d);
    return cudaGetLastError();
  }
};

template <int NP>
struct CcChainLaunch {
  static cudaError_t run(const float* x, const float* v0, const float* mask, float* out,
                         float* partial, int nblk, long long chunk, int vec, float* w, float* kf,
                         int n, long long d, int iters, float tau, int adaptive,
                         cudaStream_t s) {
    auto fin = [=](cudaStream_t st) {
      cc_finalize<NP><<<1, kThreads, 0, st>>>(partial, nblk, mask, n, tau, adaptive, w, kf);
    };
    return run_chain_vec<NP, MaskedMean>(vec, x, v0, out, partial, nblk, chunk, w, kf, n, d,
                                         iters, fin, s);
  }
};

}  // namespace

extern "C" {

int masked_median_f32(const void* x, const void* mask, void* out, int n, long long d,
                      void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  return (int)dispatch_np<MedianLaunch>(n, (const float*)x, (const float*)mask, (float*)out,
                                        n, d, (cudaStream_t)stream);
}

// iters >= 1 masked CenteredClip iterations from v0 into out, on the layout
// (nblk, chunk, vec) of chain_plan (kernels/cc_chain.py).  partial:
// (n, nblk) float scratch; w: (n,) and kf: (1,) float scratch.
int masked_cc_chain_f32(const void* x, const void* v0, const void* mask, void* out,
                        void* partial, int nblk, long long chunk, int vec, void* w, void* kf,
                        int n, long long d, int iters, float tau, int adaptive, void* stream) {
  if (iters < 1 || !chain_layout_ok(n, d, nblk, chunk, vec, x, v0, out))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_np<CcChainLaunch>(n, (const float*)x, (const float*)v0,
                                         (const float*)mask, (float*)out, (float*)partial, nblk,
                                         chunk, vec, (float*)w, (float*)kf, n, d, iters, tau,
                                         adaptive, (cudaStream_t)stream);
}

// partial: (nblk, n (n + 1) / 2) float scratch; d2: (n, n) float.
int masked_krum_d2_f32(const void* x, void* partial, int nblk, void* d2, int n, long long d,
                       void* stream) {
  if (n < 1 || n > kMaxN || nblk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long chunk = (d + nblk - 1) / nblk;
  chunk = (chunk + kTile - 1) / kTile * kTile;
  krum_gram_partial<<<nblk, kThreads, 0, s>>>((const float*)x, (float*)partial, n, d, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  krum_d2_finalize<<<1, kThreads, 0, s>>>((const float*)partial, nblk, n, (float*)d2);
  return (int)cudaGetLastError();
}

}  // extern "C"
