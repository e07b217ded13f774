// Device code shared by the CenteredClip kernels of masked_agg.cu and
// centered_clip.cu: Batcher's odd-even sorting network, the midpoint of the
// two middle ranks, the per-block partial squared norms of an (N, D) stack,
// and the dispatch on NP = next_pow2(N) in {2, ..., 64}.  Each including
// file is its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Batcher's odd-even merge sort, ascending, NP a power of two.
template <int NP>
__device__ __forceinline__ void oddeven_sort(float (&v)[NP]) {
#pragma unroll
  for (int p = 1; p < NP; p <<= 1) {
#pragma unroll
    for (int k = p; k >= 1; k >>= 1) {
#pragma unroll
      for (int j = k % p; j < NP - k; j += 2 * k) {
#pragma unroll
        for (int i = 0; i < k; ++i) {
          if (i < NP - j - k && (i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            const float a = v[i + j], b = v[i + j + k];
            const bool s = b < a;
            v[i + j] = s ? b : a;
            v[i + j + k] = s ? a : b;
          }
        }
      }
    }
  }
}

// (v[lo] + v[hi]) * 0.5 of the two middle ranks of the first k sorted
// values; k = 0 selects no low rank and gives NaN.
template <int NP>
__device__ __forceinline__ float rank_mid(const float (&v)[NP], int k) {
  const int lo_idx = k >= 1 ? (k - 1) / 2 : -1;
  const int hi_idx = k / 2;
  float lo = qnan(), hi = qnan();
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    lo = (r == lo_idx) ? v[r] : lo;
    hi = (r == hi_idx) ? v[r] : hi;
  }
  return (lo + hi) * 0.5f;
}

// partial[i, b] = sum over block b's run of columns c of (x_ic - v_c)^2,
// shape (n, gridDim.x); the thread holds one accumulator per row.
template <int NP>
__global__ void __launch_bounds__(kThreads)
cc_sqnorm_partial(const float* __restrict__ x, const float* __restrict__ v,
                  float* __restrict__ partial, int n, long long d, long long chunk) {
  float acc[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i] = 0.f;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(d, start + chunk);
  for (long long c = start + threadIdx.x; c < end; c += blockDim.x) {
    const float vc = v[c];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) {
        const float df = x[(long long)i * d + c] - vc;
        acc[i] = fmaf(df, df, acc[i]);
      }
    }
  }
  __shared__ float red[kThreads / 32][NP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    partial[(long long)threadIdx.x * gridDim.x + blockIdx.x] = s;
  }
}

// The squared norm of each of the n rows from its (n, nblk) partials, added
// in block order (lanes stride the blocks, then a fixed shuffle tree), into
// shared sq[0..n).  Every thread of the block calls it.
template <int NP>
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial, int nblk, int n,
                                             float (&sq)[NP]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kThreads / 32) {
    float s = 0.f;
    for (int b = lane; b < nblk; b += 32) s += partial[(long long)i * nblk + b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sq[i] = s;
  }
  __syncthreads();
}

// min(1, tau / max(norm, 1e-12)), with NaN propagating as in torch.minimum /
// torch.maximum and jnp.minimum / jnp.maximum (fminf / fmaxf drop it).
__device__ __forceinline__ float clip_scale(float tau, float norm) {
  const float den = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
  const float r = __fdiv_rn(tau, den);
  return isnan(r) ? r : fminf(1.f, r);
}

inline unsigned blocks_for(long long work, int per_block) {
  return (unsigned)((work + per_block - 1) / per_block);
}

template <template <int> class Launch, typename... Args>
cudaError_t dispatch_np(int n, Args... args) {
  if (n <= 2) return Launch<2>::run(args...);
  if (n <= 4) return Launch<4>::run(args...);
  if (n <= 8) return Launch<8>::run(args...);
  if (n <= 16) return Launch<16>::run(args...);
  if (n <= 32) return Launch<32>::run(args...);
  return Launch<64>::run(args...);
}

}  // namespace
