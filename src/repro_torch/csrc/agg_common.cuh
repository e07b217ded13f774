// Device code shared by the kernels of masked_agg.cu and centered_clip.cu:
// Batcher's odd-even sorting network, the midpoint of the two middle ranks,
// the CenteredClip chain's two streaming passes over an (N, D) stack and
// their layout, the column loads and the block reduction (which
// masked_agg.cu's streaming median and krum d2 also use), the clip scale,
// and the dispatch on NP = next_pow2(N) in {2, ..., 64}.  Each including
// file is its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ----------------------------- the CenteredClip chain -----------------------------
// Iteration t+1's norms |x_i - v_{t+1}|, formed from x and v_{t+1}, need all
// of v_{t+1}, and the stack is ~130x the L2 at the swarm's width; so a
// design that forms each iteration's norms directly reads the stack
// iters + 1 times for iters iterations from v0 (the dependency floor).  The
// chain reaches that floor:
//   (a) cc_norm_pass: per-(row, block) partial squared norms against v0;
//   then, for each iteration t,
//   (b) the including file's one-block finalize (the weights from the
//       partials),
//   (c) cc_apply_pass: v_{t+1} from x, v_t and the weights, and, unless t is
//       the last iteration, the next iteration's partial squared norms from
//       the x_i values it already holds in registers;
// 1 + 2 iters launches on one stream, no host sync, no atomics.  The floor
// is not the function's bound: v_t stays in v0 + span{x_i - v0}, so every
// iteration's norms follow from the Gram matrix of {x_i - v0}, which one
// pass can form, and a second pass writes v_T -- two reads for any iters
// (untried: the norms then come out of a difference of large terms).
//
// Layout, shared by (a) and (c): block b walks the columns [b chunk,
// min(d, (b + 1) chunk)), chunk a multiple of 4; thread t takes VEC
// neighbouring columns at start + VEC t, then every VEC kThreads.  VEC = 4
// (16-byte loads of every row) where d % 4 == 0, x, v0 and out are 16-byte
// aligned and n <= 32 (the rows of a step stay in registers), else 1.  The
// grid is a few waves of chain_min_blocks<NP>() blocks an SM (the launch
// bound) times the SM count, as chain_plan in kernels/cc_chain.py computes
// it (4 waves: tools/cc_chain_probe.py read the chain 5% faster than at
// one wave on an H100); the entry points take its (nblk, chunk, vec) and
// check them.  (a) and (c) add each thread's squared terms in the same
// column order and reduce them through the same tree (write_partials), so
// a chain of iters iterations is bit-equal to iters chains of one.

// resident blocks an SM of a pass, by NP = 2, 4, 8, 16, 32, 64: the
// launch bound's minimum (kernels/cc_chain.py BLOCKS_PER_SM, held equal by
// a CPU test)
constexpr int kChainMinBlocks[6] = {4, 4, 3, 2, 1, 1};

template <int NP>
constexpr int chain_min_blocks() {
  int i = 0;
  while ((2 << i) < NP) ++i;
  return kChainMinBlocks[i];
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Is (nblk, chunk, vec) a layout the passes take: runs of a multiple of 4
// columns that cover [0, d) once, none empty, and 16-byte loads only where
// n <= 32, d % 4 == 0 and x, v0 and out are 16-byte aligned?
inline bool chain_layout_ok(int n, long long d, int nblk, long long chunk, int vec,
                            const void* x, const void* v0, const void* out) {
  if (n < 1 || n > kMaxN || d < 1 || nblk < 1 || chunk < 4 || chunk % 4) return false;
  if ((long long)(nblk - 1) * chunk >= d || (long long)nblk * chunk < d) return false;
  if (vec == 1) return true;
  return vec == 4 && n <= 32 && d % 4 == 0 && aligned16(x) && aligned16(v0) && aligned16(out);
}

template <int VEC>
struct Cols {
  float e[VEC];
};

// x: each pass reads it once, so its lines are evicted first
template <int VEC>
__device__ __forceinline__ Cols<VEC> load_stream(const float* p) {
  Cols<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    r.e[0] = t.x, r.e[1] = t.y, r.e[2] = t.z, r.e[3] = t.w;
  } else {
    r.e[0] = __ldcs(p);
  }
  return r;
}

// v: may be the buffer (c) writes (the chain updates out in place)
template <int VEC>
__device__ __forceinline__ Cols<VEC> load_cols(const float* p) {
  Cols<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.e[0] = t.x, r.e[1] = t.y, r.e[2] = t.z, r.e[3] = t.w;
  } else {
    r.e[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_cols(float* p, const Cols<VEC>& c) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(c.e[0], c.e[1], c.e[2], c.e[3]);
  } else {
    *p = c.e[0];
  }
}

// sq[i] += (x_ic - v_c)^2 over the VEC columns, in column order
template <int NP, int VEC>
__device__ __forceinline__ void add_sq(float (&sq)[NP], int i, const Cols<VEC>& xi,
                                       const Cols<VEC>& v) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float df = __fsub_rn(xi.e[j], v.e[j]);
    sq[i] = __fmaf_rn(df, df, sq[i]);
  }
}

// partial[i, blockIdx.x] = the block's sum of sq[i]: a shuffle tree in each
// warp, then the warps in order.
template <int NP>
__device__ __forceinline__ void write_partials(const float (&sq)[NP],
                                               float* __restrict__ partial, int n) {
  __shared__ float red[kThreads / 32][NP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = sq[i];
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

// (a): partial squared norms of the n rows against v, shape (n, gridDim.x).
template <int NP, int VEC>
__global__ void __launch_bounds__(kThreads, chain_min_blocks<NP>())
cc_norm_pass(const float* __restrict__ x, const float* __restrict__ v,
             float* __restrict__ partial, int n, long long d, long long chunk) {
  float sq[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) sq[i] = 0.f;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(d, start + chunk);
  for (long long c = start + VEC * threadIdx.x; c < end; c += VEC * kThreads) {
    const Cols<VEC> vc = load_cols<VEC>(v + c);
    Cols<VEC> xr[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) xr[i] = load_stream<VEC>(x + (long long)i * d + c);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) add_sq<NP, VEC>(sq, i, xr[i], vc);
    }
  }
  write_partials<NP>(sq, partial, n);
}

// (c): out = Step::apply(sum_i (x_i - v) * w_i, Step's scalar, v) column by
// column, rows in order with round-to-nearest multiply and add (no
// contraction); with EMIT, also the partial squared norms of the rows
// against out, as (a) would compute them from out.  v and out may be the
// same buffer: each thread reads a column of v before it writes that column.
template <int NP, int VEC, bool EMIT, class Step>
__global__ void __launch_bounds__(kThreads, chain_min_blocks<NP>())
cc_apply_pass(const float* __restrict__ x, const float* v, const float* __restrict__ w,
              const float* __restrict__ kf, float* out, float* __restrict__ partial, int n,
              long long d, long long chunk) {
  __shared__ float sw[NP];
  __shared__ float sk;
  if (threadIdx.x < n) sw[threadIdx.x] = w[threadIdx.x];
  if (threadIdx.x == 0) sk = Step::scalar(kf, n);
  __syncthreads();
  const float k = sk;
  float sq[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) sq[i] = 0.f;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(d, start + chunk);
  for (long long c = start + VEC * threadIdx.x; c < end; c += VEC * kThreads) {
    const Cols<VEC> vc = load_cols<VEC>(v + c);
    Cols<VEC> xr[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) xr[i] = load_stream<VEC>(x + (long long)i * d + c);
    }
    Cols<VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (i < n) acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(xr[i].e[j], vc.e[j]), sw[i]));
      }
      o.e[j] = Step::apply(acc, k, vc.e[j]);
    }
    store_cols<VEC>(out + c, o);
    if constexpr (EMIT) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (i < n) add_sq<NP, VEC>(sq, i, xr[i], o);
      }
    }
  }
  if constexpr (EMIT) write_partials<NP>(sq, partial, n);
}

// The chain on stream s: (a), then fin(s) (the file's finalize, (b), which
// reads partial and writes w and kf) and (c) for each iteration.  out is
// written by the first (c) and updated in place by the later ones.
template <int NP, int VEC, class Step, class Fin>
cudaError_t run_chain(const float* x, const float* v0, float* out, float* partial, int nblk,
                      long long chunk, const float* w, const float* kf, int n, long long d,
                      int iters, Fin fin, cudaStream_t s) {
  cc_norm_pass<NP, VEC><<<nblk, kThreads, 0, s>>>(x, v0, partial, n, d, chunk);
  cudaError_t e = cudaGetLastError();
  const float* v = v0;
  for (int t = 0; t < iters && e == cudaSuccess; ++t) {
    fin(s);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    if (t + 1 < iters) {
      cc_apply_pass<NP, VEC, true, Step><<<nblk, kThreads, 0, s>>>(x, v, w, kf, out, partial,
                                                                   n, d, chunk);
    } else {
      cc_apply_pass<NP, VEC, false, Step><<<nblk, kThreads, 0, s>>>(x, v, w, kf, out, partial,
                                                                    n, d, chunk);
    }
    e = cudaGetLastError();
    v = out;
  }
  return e;
}

// run_chain at the vector width vec (4 only up to NP = 32: the rows of a
// step are held in registers).
template <int NP, class Step, class Fin>
cudaError_t run_chain_vec(int vec, const float* x, const float* v0, float* out, float* partial,
                          int nblk, long long chunk, const float* w, const float* kf, int n,
                          long long d, int iters, Fin fin, cudaStream_t s) {
  if (vec == 4) {
    if constexpr (NP <= 32) {
      return run_chain<NP, 4, Step>(x, v0, out, partial, nblk, chunk, w, kf, n, d, iters, fin, s);
    }
    return cudaErrorInvalidValue;
  }
  return run_chain<NP, 1, Step>(x, v0, out, partial, nblk, chunk, w, kf, n, d, iters, fin, s);
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
