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
// more and does a few operations per byte.  Bounds, counting each input
// read once and each output written once:
//   median   (K + 1) * D * 4 bytes  = 7.15 GB -> 2.13 ms (K = 10 kept rows)
//   cc_chain (N + 2) * D * 4 bytes  = 7.80 GB -> 2.33 ms, for any iters
//            (x and v0 read, v_T written: 0.78 ms an iteration at 3)
//   krum_d2  N * D * 4 bytes        = 6.50 GB -> 1.94 ms
//            (N (N + 1) D = 17.9 GFLOP at 67 TFLOP/s fp32 is 0.27 ms, below it)
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
// - median and krum_d2 stream the stack once, each thread VEC neighbouring
//   columns at a time (16-byte streaming loads of every row it reads, VEC =
//   4, where d % 4 == 0 and x and out are 16-byte aligned, else VEC = 1),
//   striding over D by the whole grid: thread t of block b takes the
//   columns (b kThreads + t) VEC + s gridDim.x kThreads VEC, s = 0, 1, ...
//   The host picks the grid (stream_grid in kernels/masked_agg/ops.py) and
//   the entry points check it.
// - median: each block compacts the mask into the list of the K kept rows
//   (K is the same for every column, and stays on the device: no host
//   sync), and the whole grid takes one branch of a switch on K.  For
//   K <= 16 a thread loads only the K kept rows and sorts each column's K
//   values with Knuth's merge exchange for exactly K inputs (Batcher's;
//   TAOCP vol. 3, 5.2.2, Algorithm M; 31 comparators at K = 10), K a
//   compile-time constant, so the compiler drops every select the two middle
//   ranks (K - 1) / 2 and K / 2 do not need (29 comparators kept at
//   K = 10); out = (v[(K-1)/2] + v[K/2]) * 0.5.  Above K = 16 (n <= 64) a
//   thread takes its columns one at a time: masked rows are +inf, and
//   Batcher's odd-even network sorts NP = next_pow2(N) values (the order of
//   oddeven_merge_pairs in kernel.py), the ranks chosen by a runtime index.
//   K = 0 writes NaN without reading x.  A compare-exchange swaps iff
//   b < a, so a sort is a permutation and the result is bit-equal to the
//   plain version, which runs the same networks, signed zeros included.
// - cc_chain: iters >= 1 iterations from v0 in 1 + 2 iters launches on
//   the device with no host sync, reading the stack iters + 1 times (the
//   chain of agg_common.cuh):
//   (a) cc_norm_pass: per-block partial squared norms sum_c (x_ic - v_c)^2,
//       shape (N, n_blocks), 16-byte loads where the layout allows;
//   (b) cc_finalize, one block: adds the partials in block order, takes the
//       norms, the adaptive tau (the masked median of the norms, the padded
//       odd-even network), the kept count k and the per-node weights w_i =
//       m_i * min(1, tau / max(|x_i - v|, 1e-12)).  NaN propagates as in
//       torch.minimum;
//   (c) cc_apply_pass: out = v + (sum_i (x_i - v) * w_i) / k, in node order
//       with round-to-nearest mul and add (no contraction), the plain
//       version's exact arithmetic; then, but for the last iteration, the
//       next partial squared norms from the rows it holds.
//   The wrapper's single iteration (masked_cc_iter) is the chain at
//   iters = 1, bit-equal to one step of a longer chain.
// - krum_d2, N <= 16: each thread accumulates the N (N + 1) / 2 products
//   x_i . x_j of its columns in registers (fp32 FMAs, the VEC columns of a
//   step in order, then the next step), N a compile-time constant; the
//   block reduces them through write_partials' fixed tree into (pairs,
//   blocks) partials.  N > 16: each block walks its own run of 128-column
//   tiles, stages each tile in shared memory (rows padded by one word
//   against bank conflicts) and accumulates one pair a thread, a sum per
//   tile, then the tile sums.  Either way a one-block pass adds the block
//   partials in block order and forms d2_ij = G_ii + G_jj - 2 G_ij.  No
//   tensor cores and no TF32.
//
// N <= 64 for every kernel; the Python wrapper raises above.  Each entry
// point returns cudaGetLastError().  The odd-even network, the chain's
// passes, the clip scale and the column loads are shared with
// centered_clip.cu (agg_common.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "agg_common.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kMaxPairsPerThread = (kMaxN * (kMaxN + 1) / 2 + kThreads - 1) / kThreads;
// the median's exact networks and krum's register Gram go up to 16 rows
// (MAX_EXACT in kernels/masked_agg/ops.py, held equal by a CPU test)
constexpr int kMaxExact = 16;

__host__ __device__ constexpr int ceil_log2(int k) {
  int t = 0;
  while ((1 << t) < k) ++t;
  return t;
}

// ------------------------------------ layout --------------------------------------
// Is (nblk, vec) a layout the streaming kernels take: at least one block,
// and 16-byte loads only where d % 4 == 0 and x and out are 16-byte aligned?
inline bool stream_layout_ok(long long d, int nblk, int vec, const void* x, const void* out) {
  if (d < 0 || nblk < 1) return false;
  if (vec == 1) return true;
  return vec == 4 && d % 4 == 0 && aligned16(x) && (out == nullptr || aligned16(out));
}

// this thread's first column and the grid's stride over D
template <int VEC>
__device__ __forceinline__ long long first_col() {
  return ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
}
template <int VEC>
__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * kThreads * VEC;
}

// ------------------------------------ median --------------------------------------
// swap iff b < a: ties never move
__device__ __forceinline__ void cx(float& a, float& b) {
  const bool s = b < a;
  const float lo = s ? b : a, hi = s ? a : b;
  a = lo;
  b = hi;
}

// Knuth's merge exchange for exactly k inputs, in the order of
// merge_exchange_pairs (kernels/masked_agg/ops.py): for p = top, top/2, ...,
// 1 (top the largest power of two below k), a pass (d = p, r = 0), then one
// (d = q - p, r = p) for q = top, top/2, ... while q > p; a pass compares
// (i, i + d) for every i < k - d with i & p == r.  Returns the m-th pair,
// or {the pair count, 0} for an m past the last.
struct Pair {
  int a, b;
};
__host__ __device__ constexpr Pair merge_exchange_pair(int k, int m) {
  int count = 0;
  if (k >= 2) {
    const int top = 1 << (ceil_log2(k) - 1);
    for (int p = top; p > 0; p >>= 1) {
      for (int q = 2 * top; q > p; q >>= 1) {
        const int dd = q == 2 * top ? p : q - p;  // q = 2 top: the pass (p, 0)
        const int r = q == 2 * top ? 0 : p;
        for (int i = 0; i < k - dd; ++i) {
          if ((i & p) == r) {
            if (count == m) return {i, i + dd};
            ++count;
          }
        }
      }
    }
  }
  return {count, 0};
}

template <int A, int B, int K>
__device__ __forceinline__ void cx_at(float (&v)[K]) {
  cx(v[A], v[B]);
}

// every pair's indices are template arguments, evaluated by the compiler:
// the network is straight-line code on registers for any K (unrolled loops
// left v in local memory at K = 9..16 but 12)
template <int K, int... M>
__device__ __forceinline__ void merge_exchange_seq(float (&v)[K],
                                                   std::integer_sequence<int, M...>) {
  (cx_at<merge_exchange_pair(K, M).a, merge_exchange_pair(K, M).b>(v), ...);
}

// sort v ascending with the merge exchange network for exactly K inputs
template <int K>
__device__ __forceinline__ void merge_exchange(float (&v)[K]) {
  merge_exchange_seq<K>(v, std::make_integer_sequence<int, merge_exchange_pair(K, -1).a>{});
}

// K <= 16 kept rows (their indices in rows[0..K)): load only them, sort
// each column's K values, write the midpoint of ranks (K - 1) / 2 and K / 2;
// K = 0 writes NaN.
template <int K, int VEC>
__device__ __forceinline__ void median_kept(const float* __restrict__ x, const int* rows,
                                            float* __restrict__ out, long long d) {
  if constexpr (K == 0) {
    Cols<VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.e[j] = qnan();
    for (long long c = first_col<VEC>(); c < d; c += grid_stride<VEC>()) store_cols<VEC>(out + c, o);
  } else {
    const float* row[K];
#pragma unroll
    for (int s = 0; s < K; ++s) row[s] = x + (long long)rows[s] * d;
    for (long long c = first_col<VEC>(); c < d; c += grid_stride<VEC>()) {
      Cols<VEC> r[K];
#pragma unroll
      for (int s = 0; s < K; ++s) r[s] = load_stream<VEC>(row[s] + c);
      Cols<VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v[K];
#pragma unroll
        for (int s = 0; s < K; ++s) v[s] = r[s].e[j];
        merge_exchange<K>(v);
        o.e[j] = (v[(K - 1) / 2] + v[K / 2]) * 0.5f;
      }
      store_cols<VEC>(out + c, o);
    }
  }
}

// K > 16 (so NP >= 32): column by column, masked rows +inf, the odd-even
// network over NP slots and the ranks by a runtime index.
template <int NP, int VEC>
__device__ __forceinline__ void median_padded(const float* __restrict__ x, const float* sm,
                                              float* __restrict__ out, int n, int k,
                                              long long d) {
  for (long long c = first_col<VEC>(); c < d; c += grid_stride<VEC>()) {
    Cols<VEC> o;
#pragma unroll 1
    for (int j = 0; j < VEC; ++j) {
      float v[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i)
        v[i] = (i < n && sm[i] > 0.f) ? __ldcs(x + (long long)i * d + c + j) : INFINITY;
      oddeven_sort<NP>(v);
      o.e[j] = rank_mid<NP>(v, k);
    }
    store_cols<VEC>(out + c, o);
  }
}

// the branch of the kept count k: median_kept<K> for K = k <= min(NP, 16),
// else median_padded
template <int NP, int VEC, int K>
__device__ __forceinline__ void median_switch(int k, const float* __restrict__ x,
                                              const float* sm, const int* rows,
                                              float* __restrict__ out, int n, long long d) {
  if constexpr (K <= kMaxExact && K <= NP) {
    if (k == K) {
      median_kept<K, VEC>(x, rows, out, d);
    } else {
      median_switch<NP, VEC, K + 1>(k, x, sm, rows, out, n, d);
    }
  } else if constexpr (NP > kMaxExact) {
    median_padded<NP, VEC>(x, sm, out, n, k, d);
  }
}

template <int NP, int VEC>
__global__ void __launch_bounds__(kThreads, NP <= 32 ? 2 : 1)
median_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              float* __restrict__ out, int n, long long d) {
  __shared__ float sm[kMaxN];
  __shared__ int rows[kMaxN];
  __shared__ int sk;
  if (threadIdx.x < n) sm[threadIdx.x] = mask[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int i = 0; i < n; ++i) {
      if (sm[i] > 0.f) rows[k++] = i;
    }
    sk = k;
  }
  __syncthreads();
  median_switch<NP, VEC, 0>(sk, x, sm, rows, out, n, d);
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

// ----------------------------------- krum d2 --------------------------------------
// index of pair (i, j), i <= j, in the row-major upper triangle of an n x n matrix
__host__ __device__ constexpr int pair_index(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

// resident blocks an SM of krum_gram_stream: two while its accumulators
// and a step's loaded values fit 128 registers a thread (n <= 10), else one
template <int N>
constexpr int krum_min_blocks() {
  return N * (N + 1) / 2 + 4 * N <= 100 ? 2 : 1;
}

// N <= 16: partial[p, blockIdx.x] = the block's sum of x_i . x_j over its
// threads' columns, p = pair_index(i, j, N); each thread sums its columns'
// products in one register a pair, the VEC columns of a step in order.
template <int N, int VEC>
__global__ void __launch_bounds__(kThreads, krum_min_blocks<N>())
krum_gram_stream(const float* __restrict__ x, float* __restrict__ partial, long long d) {
  constexpr int P = N * (N + 1) / 2;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  for (long long c = first_col<VEC>(); c < d; c += grid_stride<VEC>()) {
    Cols<VEC> r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = load_stream<VEC>(x + (long long)i * d + c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = i; j < N; ++j) {
          const int p = pair_index(i, j, N);
          acc[p] = fmaf(r[i].e[e], r[j].e[e], acc[p]);
        }
      }
    }
  }
  write_partials<P>(acc, partial, P);
}

__device__ __forceinline__ void pair_of(int p, int n, int& i, int& j) {
  i = 0;
  while (p >= n - i) {
    p -= n - i;
    ++i;
  }
  j = i + p;
}

// N > 16: block b walks the columns [b chunk, min(d, (b + 1) chunk)) in
// 128-column tiles staged in shared memory, one pair a thread; writes
// partial[p, b] as krum_gram_stream does.
__global__ void __launch_bounds__(kThreads)
krum_gram_tiles(const float* __restrict__ x, float* __restrict__ partial, int n,
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
    if (p < npairs) partial[(long long)p * gridDim.x + blockIdx.x] = acc[q];
  }
}

// one block: G_p = the sum of partial[p, 0..nblk) in block order, then
// d2_ij = G_ii + G_jj - 2 G_ij
__global__ void __launch_bounds__(kThreads)
krum_d2_finalize(const float* __restrict__ partial, int nblk, int n, float* __restrict__ d2) {
  __shared__ float g[kMaxN * (kMaxN + 1) / 2];
  const int npairs = n * (n + 1) / 2;
  for (int p = threadIdx.x; p < npairs; p += kThreads) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += partial[(long long)p * nblk + b];
    g[p] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    const float gij = i <= j ? g[pair_index(i, j, n)] : g[pair_index(j, i, n)];
    d2[e] = __fsub_rn(__fadd_rn(g[pair_index(i, i, n)], g[pair_index(j, j, n)]),
                      __fmul_rn(2.f, gij));
  }
}

// the Gram partials of an (n, d) stack: krum_gram_stream at the exact n up
// to 16, krum_gram_tiles above
template <int N>
cudaError_t krum_gram(const float* x, float* partial, int nblk, int vec, int n, long long d,
                      cudaStream_t s) {
  if constexpr (N <= kMaxExact) {
    if (n != N) return krum_gram<N + 1>(x, partial, nblk, vec, n, d, s);
    if (vec == 4) {
      krum_gram_stream<N, 4><<<nblk, kThreads, 0, s>>>(x, partial, d);
    } else {
      krum_gram_stream<N, 1><<<nblk, kThreads, 0, s>>>(x, partial, d);
    }
  } else {
    long long chunk = (d + nblk - 1) / nblk;
    chunk = (chunk + kTile - 1) / kTile * kTile;
    krum_gram_tiles<<<nblk, kThreads, 0, s>>>(x, partial, n, d, chunk);
  }
  return cudaGetLastError();
}

template <int NP>
struct MedianLaunch {
  static cudaError_t run(const float* x, const float* mask, float* out, int nblk, int vec,
                         int n, long long d, cudaStream_t s) {
    if (vec == 4) {
      median_kernel<NP, 4><<<nblk, kThreads, 0, s>>>(x, mask, out, n, d);
    } else {
      median_kernel<NP, 1><<<nblk, kThreads, 0, s>>>(x, mask, out, n, d);
    }
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

// The masked median of the (n, d) stack into out, on the grid (nblk, vec)
// of stream_grid (kernels/masked_agg/ops.py).
int masked_median_f32(const void* x, const void* mask, void* out, int nblk, int vec, int n,
                      long long d, void* stream) {
  if (n < 1 || n > kMaxN || !stream_layout_ok(d, nblk, vec, x, out))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_np<MedianLaunch>(n, (const float*)x, (const float*)mask, (float*)out,
                                        nblk, vec, n, d, (cudaStream_t)stream);
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

// krum's (n, n) squared distances into d2, on the grid (nblk, vec) of
// stream_grid (vec unused above 16 rows).  partial: (n (n + 1) / 2, nblk)
// float scratch.
int masked_krum_d2_f32(const void* x, void* partial, int nblk, int vec, void* d2, int n,
                       long long d, void* stream) {
  if (n < 1 || n > kMaxN || !stream_layout_ok(d, nblk, vec, x, nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = krum_gram<1>((const float*)x, (float*)partial, nblk, vec, n, d, s);
  if (e != cudaSuccess) return (int)e;
  krum_d2_finalize<<<1, kThreads, 0, s>>>((const float*)partial, nblk, n, (float*)d2);
  return (int)cudaGetLastError();
}

}  // extern "C"
