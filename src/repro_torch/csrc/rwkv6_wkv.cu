// RWKV6 WKV recurrence, forward, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel wkv_scan_fwd of
// src/repro/kernels/rwkv6_wkv/kernel.py:73.
//
// Per (batch, head), with K = V = head dim and the decay w_t in (0, 1)^K:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{K x V}
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// r, k, v, w (B, S, H, K) in the model's layout, contiguous, bfloat16 or
// float32; u (H, K) and s0 (B, H, K, K) float32 (s0 may be null: zeros);
// y (B, S, H, K) in r's type and s_final (B, H, K, K) float32.  Everything is
// computed to float32 accuracy; log w is taken here, clamped at -80.  Any S
// (the ragged last chunk is padded with zero r, k, v and log w = 0, which
// adds nothing), K a multiple of 16 up to 128.
//
// Bound on an H100: bytes.  At rwkv6-1.6b's served prefill (B 1, S 32,768,
// H 32, K 64, bf16) the kernel moves 672 MB of r, k, v, w and y (0.20 ms at
// 3.35 TB/s); the recurrence's 4 K^2 flops per token and head (17.2 GFLOP)
// take 0.017 ms at the bf16 tensor-core rate, where the products run (the
// hi/lo split's three passes and the chunk form raise the kernel's own
// floor above that).
//
// Design: a chunk-parallel scan in three launches, chunks of kC = 64 tokens
// cut into sub-chunks of 16.  cl is the inclusive cumulative log decay
// within a sub-chunk, el = cl one token earlier (0 at its first token), T_i
// the total of sub-chunk i; sums of T run left to right.  Every decay factor
// below is exp of a sum that is <= 0, so strong decays cannot overflow (the
// TPU kernel's form scales k by exp(-cs), which does: ROADMAP queue 3), and
// no exponent is the difference of two long sums.
//   1. wkv_chunk_state, grid (chunk, batch * head): the chunk's change of
//      the state, dS = sum_s kd_s v_s^T with kd_s = k_s exp(T_i - cl_s)
//      exp(sum_{i' > i} T_i') (s in sub-chunk i), written transposed to a float32
//      scratch (B, H, n_chunks, V, K), and its decay exp(sum_i T_i) per
//      channel to a second one.
//   2. chunk_scan::state_pass, grid (state elements, batch * head): the
//      state each chunk starts from, S <- exp(D) S + dS over the chunks, in
//      place of dS; s0 seeds it, the last value is s_final.
//   3. wkv_chunk_out, grid (chunk, batch * head): r, k and cl are staged
//      channel-major.  Warp i first computes the scores inside its
//      sub-chunk i on the CUDA cores, pairwise,
//        A[t][s] = sum_c r_t k_s exp(el_t - cl_s) (s < t), A[t][t] = (r_t k_t) . u;
//      then r becomes r exp(el) and k becomes k exp(T_j - cl) in place
//      (j = the token's sub-chunk), and warp i computes for its 16 query
//      tokens, in float32 registers,
//        the state's share  (r_t exp(el_t) exp(G_i)) . S_in,  G_i = sum_{i' < i} T_i';
//        the scores of earlier sub-chunks j < i
//          A[t][s] = (r_t exp(el_t) exp(sum_{j < i' < i} T_i')) . (k_s exp(T_j - cl_s)),
//        every factor <= 1 (the reference token is the key sub-chunk's end);
//        y = state's share + A . V.
// The chunk products (dS, the state's share, the scores, A . V) run on the
// tensor cores as mma.sync m16n8k16 in bf16 with float32 accumulators.  A
// float32 operand (the decayed r and k, kd, A, the state) is split into a
// bf16 hi and lo term and the product takes hi.hi + hi.lo + lo.hi, so it
// keeps float32 accuracy (the products of the TPU kernel are float32); v of
// the bf16 model is exact in one term (and kept in bf16 in shared memory).
// Loads are 16 bytes a thread, all issued before any is used.  The chunk's
// cumulative sums run one thread per (channel, sub-chunk) in registers.  One
// block of 128 threads a chunk: 512 blocks a head at the served shape,
// where the simple design's 128 blocks each walked the whole sequence.  The
// scratch is 4 K^2 bytes a chunk and head (268 MB at the served shape),
// written once, read and written by the state pass and read once.
// No atomics and a fixed order everywhere: two launches give the same bits.
//
// The entry point returns cudaGetLastError().

#include <type_traits>

#include "chunk_scan.cuh"

namespace {

using namespace chunk_scan;

constexpr int kC = 64;                // tokens per chunk
constexpr int kSub = 16;              // tokens per sub-chunk: one k-step of mma.sync
constexpr int kNSub = kC / kSub;
constexpr int kThreads = 32 * kNSub;  // warp i: sub-chunk i in wkv_chunk_out
constexpr int kMaxK = 128;
constexpr int kLdD = 24;              // row stride of the diagonal score blocks
constexpr float kLogWMin = -80.f;
constexpr int kPairs = kNSub * (kNSub - 1) / 2;  // (query, key) sub-chunk pairs, key first

__device__ __forceinline__ int pair(int i, int j) { return i * (i - 1) / 2 + j; }

// Ts[lo][c] + ... + Ts[hi - 1][c], left to right (0 when empty)
__device__ __forceinline__ float left_sum(const float* Ts, int K, int c, int lo, int hi) {
  float acc = 0.f;
  for (int j = lo; j < hi; ++j) acc += Ts[j * K + c];
  return acc;
}

// row stride of v in wkv_chunk_out, in elements of T: read down a column
// without bank conflicts (4-byte words 8 banks apart a row pair for bf16)
template <typename T, int K>
__host__ __device__ constexpr int out_ldv() {
  return sizeof(T) == 4 ? K + 4 : K + 8;
}

// log of a bfloat16 w from a table of 128 logs, one per mantissa: w = 2^e m
// with m in [1, 2); where m >= 1.42 the table holds log(m / 2) and e is one
// higher, so a w near 1 takes its entry as it is (no cancellation) and any
// other w is e ln2 + L[m] with |log w| >= 0.34: within two ulp of logf.  Zero
// and subnormal w give kLogWMin, as the clamp would.
constexpr int kLogSplit = 54;  // first mantissa byte with m >= sqrt(2)

__device__ __forceinline__ void fill_log_table(float* Lt) {
  for (int f = threadIdx.x; f < 128; f += kThreads) {
    const float m = 1.f + f * (1.f / 128.f);
    Lt[f] = logf(f >= kLogSplit ? 0.5f * m : m);
  }
}

template <typename T>
__device__ __forceinline__ float log_w(T x, const float* Lt) {
  if constexpr (std::is_same<T, bf16>::value) {
    const unsigned bits = __bfloat16_as_ushort(x);
    const int ex = (bits >> 7) & 0xff, f = bits & 0x7f;
    if (ex == 0) return kLogWMin;
    const float e = (float)(ex - 127 + (f >= kLogSplit));
    // ln 2 in two parts: e * hi is exact for |e| < 2^9
    return fmaxf(fmaf(e, 0.693145751953125f, fmaf(e, 1.428606765330187e-06f, Lt[f])), kLogWMin);
  } else {
    return fmaxf(logf(to_f(x)), kLogWMin);
  }
}

// The log decay of the thread's tasks (channel c, sub-chunk i): load() issues
// the loads of w over the sub-chunks' tokens (so they fly across a barrier),
// scan() takes the inclusive cumulative sums of log w into cl and each
// sub-chunk's total into Ts[i][c].  Tokens past S have log w = 0.  Lt:
// fill_log_table's.
template <typename T, int K>
struct LogDecay {
  static constexpr int kPer = (kNSub * K + kThreads - 1) / kThreads;  // tasks a thread
  T wv[kPer][kSub];

  __device__ __forceinline__ void load(const T* __restrict__ w, long long base, long long tok,
                                       int t0, int S) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = threadIdx.x + m * kThreads, i = e / K, c = e - i * K;
#pragma unroll
      for (int tt = 0; tt < kSub; ++tt) {
        const int t = t0 + i * kSub + tt;
        if (e < kNSub * K && t < S) wv[m][tt] = w[base + (long long)t * tok + c];
      }
    }
  }
  __device__ __forceinline__ void scan(int t0, int S, float* Ts, const float* Lt,
                                       float (&cl)[kPer][kSub]) const {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = threadIdx.x + m * kThreads;
      if (e < kNSub * K) {
        const int i = e / K, c = e - i * K;
        float run = 0.f;
#pragma unroll
        for (int tt = 0; tt < kSub; ++tt) {
          run += t0 + i * kSub + tt < S ? log_w(wv[m][tt], Lt) : 0.f;
          cl[m][tt] = run;
        }
        Ts[i * K + c] = run;
      }
    }
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_state(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ w,
                float* __restrict__ ds, float* __restrict__ decay, int S, int H, int nc) {
  constexpr int LD = K + 4;  // rows read down a column: conflict-free
  constexpr int kPer = LogDecay<T, K>::kPer;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float smem[];
  float* Vs = smem;            // [kC][LD] v
  float* Kd = Vs + kC * LD;    // [kC][LD] k, then kd
  float* Ts = Kd + kC * LD;    // [kNSub][K] sub-chunk totals of log w
  float* Rx = Ts + kNSub * K;  // [kNSub][K] exp(the totals of the later sub-chunks)
  float* Lt = Rx + kNSub * K;  // [128] the log table

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t0 = chunk * kC;
  const long long tok = (long long)H * K;
  const long long base = (long long)b * S * tok + (long long)h * K;

  LogDecay<T, K> ld;
  {
    Tile<T, kC, K, kThreads, false> tv, tk;
    tv.load(v + base + (long long)t0 * tok, tok, S - t0, K);
    tk.load(k + base + (long long)t0 * tok, tok, S - t0, K);
    ld.load(w, base, tok, t0, S);
    fill_log_table(Lt);
    tv.store_rows(Vs, LD, K);
    tk.store_rows(Kd, LD, K);
  }
  __syncthreads();  // k and the log table are staged
  {
    // kd = k exp(T_i - cl) exp(the totals of the later sub-chunks); the
    // first factor here, by the thread of (channel, sub-chunk)
    float cl[kPer][kSub];
    ld.scan(t0, S, Ts, Lt, cl);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads;
      if (e < kNSub * K) {
        const int i = e / K, c = e - i * K;
        const float ti = cl[m][kSub - 1];
#pragma unroll
        for (int tt = 0; tt < kSub; ++tt) Kd[(i * kSub + tt) * LD + c] *= __expf(ti - cl[m][tt]);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < K; c += kThreads) {
    for (int j = 0; j < kNSub; ++j) Rx[j * K + c] = expf(left_sum(Ts, K, c, j + 1, kNSub));
    decay[((long long)bh * nc + chunk) * K + c] = expf(left_sum(Ts, K, c, 0, kNSub));
  }
  __syncthreads();

  // dS^T[j][c] = sum_s v[s][j] kd[s][c]; warp w takes the row tiles w, w + 4, ...
  const int gr = lane >> 2, qd = lane & 3;
  float* out = ds + ((long long)bh * nc + chunk) * K * K;
  for (int mt = warp; mt < K / 16; mt += kThreads / 32) {
    float acc[K / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      FragA a;
      frag_a<kF32>(a, lane, [&](int rr, int cc) { return Vs[(16 * ks + cc) * LD + 16 * mt + rr]; });
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt) {
        FragB bb;
        frag_b<true>(bb, lane, [&](int kk, int nn) {
          return Kd[(16 * ks + kk) * LD + 8 * nt + nn] * Rx[ks * K + 8 * nt + nn];  // k-step = sub-chunk
        });
        mma_split<kF32, true>(acc[nt], a, bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      float* o = out + (long long)(16 * mt + gr) * K + 8 * nt + 2 * qd;
      store2(o, acc[nt][0], acc[nt][1]);
      store2(o + 8 * K, acc[nt][2], acc[nt][3]);
    }
  }
}

// Channel-major tiles of wkv_chunk_out keep channels c and c + 1 of a token
// side by side: (c, t) at (c / 2) kPL + 2 t + c % 2.  A fragment's channel
// pair is one 8-byte load, and so is a pair of the pairwise scores; kPL = 8
// (mod 32) keeps both free of bank conflicts.
constexpr int kPL = 2 * (kC + 4);

__device__ __forceinline__ float2 pair_at(const float* X, int c, int t) {
  return *reinterpret_cast<const float2*>(X + (c >> 1) * kPL + 2 * t);
}

// the A fragment of tokens t0 .. t0 + 15 by channels c0 .. c0 + 15 of a
// pair-interleaved tile, channel c scaled by g[c]
__device__ __forceinline__ void frag_a_tok(FragA& a, const float* X, int t0, int c0,
                                           const float* g, int lane) {
  const int t = t0 + (lane >> 2), c = c0 + 2 * (lane & 3);
  const float2 g0 = *reinterpret_cast<const float2*>(g + c);
  const float2 g1 = *reinterpret_cast<const float2*>(g + c + 8);
  const float2 x0 = pair_at(X, c, t), x1 = pair_at(X, c, t + 8);
  const float2 x2 = pair_at(X, c + 8, t), x3 = pair_at(X, c + 8, t + 8);
  split<true>(x0.x * g0.x, x0.y * g0.y, a.hi[0], a.lo[0]);
  split<true>(x1.x * g0.x, x1.y * g0.y, a.hi[1], a.lo[1]);
  split<true>(x2.x * g1.x, x2.y * g1.y, a.hi[2], a.lo[2]);
  split<true>(x3.x * g1.x, x3.y * g1.y, a.hi[3], a.lo[3]);
}

// the B fragment (k = channels c0 .. c0 + 15, n = tokens s0 .. s0 + 7) of a
// pair-interleaved tile
__device__ __forceinline__ void frag_b_tok(FragB& b, const float* X, int s0, int c0, int lane) {
  const int s = s0 + (lane >> 2), c = c0 + 2 * (lane & 3);
  const float2 x0 = pair_at(X, c, s), x1 = pair_at(X, c + 8, s);
  split<true>(x0.x, x0.y, b.hi[0], b.lo[0]);
  split<true>(x1.x, x1.y, b.hi[1], b.lo[1]);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 3)
wkv_chunk_out(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ w, const float* __restrict__ u,
              const float* __restrict__ s_in, T* __restrict__ y, int S, int H, int nc) {
  constexpr int LV = out_ldv<T, K>();  // v, token-major in its own type, read down a column
  constexpr int kPer = LogDecay<T, K>::kPer;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float smem[];
  float* Rc = smem;                    // [K / 2][kPL] r, then r exp(el)
  float* Kc = Rc + K / 2 * kPL;        // [K / 2][kPL] k, then k exp(T_j - cl)
  float* Cc = Kc + K / 2 * kPL;        // [K / 2][kPL] cl
  float* Ts = Cc + K / 2 * kPL;        // [kNSub][K] sub-chunk totals
  float* Us = Ts + kNSub * K;          // [K] u
  float* Gx = Us + K;                  // [kNSub][K] exp(G_i)
  float* Fx = Gx + kNSub * K;          // [kPairs][K] exp(sum_{j < i' < i} T_i'), pair (i, j), j < i
  float* Lt = Fx + kPairs * K;         // [128] the log table
  float* Ad = Lt + 128;                // [kNSub][kSub][kLdD] the scores inside each sub-chunk
  T* Vs = reinterpret_cast<T*>(Ad + kNSub * kSub * kLdD);  // [kC][LV] v (exact in T)

  const int tid = threadIdx.x, lane = tid & 31, i = tid >> 5;
  const int chunk = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t0 = chunk * kC;
  const long long tok = (long long)H * K;
  const long long base = (long long)b * S * tok + (long long)h * K;

  {
    Tile<T, kC, K, kThreads, true> tr, tk;
    Tile<T, kC, K, kThreads, false> tv;
    LogDecay<T, K> ld;
    const long long off = base + (long long)t0 * tok;
    tr.load(r + off, tok, S - t0, K);
    tk.load(k + off, tok, S - t0, K);
    tv.load(v + off, tok, S - t0, K);
    ld.load(w, base, tok, t0, S);
    fill_log_table(Lt);
    for (int c = tid; c < K; c += kThreads) Us[c] = u[(long long)h * K + c];
    __syncthreads();  // the log table
    float cl[kPer][kSub];
    ld.scan(t0, S, Ts, Lt, cl);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads;
      if (e < kNSub * K) {
        const int ii = e / K, c = e - ii * K;
        float* dst = Cc + (c >> 1) * kPL + 2 * ii * kSub + (c & 1);
#pragma unroll
        for (int tt = 0; tt < kSub; ++tt) dst[2 * tt] = cl[m][tt];
      }
    }
    tr.store_pairs(Rc, kPL, K);
    tk.store_pairs(Kc, kPL, K);
    tv.store_raw(Vs, LV, K);
  }
  __syncthreads();

  const int gr = lane >> 2, qd = lane & 3;

  // the scores inside sub-chunk i, pairwise on the CUDA cores: lane takes the
  // entries lane, lane + 32, ... of the strict lower triangle (120 of them),
  // two channels a step; then the diagonal's (r_t k_t) . u
  float* Ai = Ad + i * kSub * kLdD;
  for (int e = lane; e < kSub * (kSub - 1) / 2; e += 32) {
    int tt = (int)((1.f + sqrtf(1.f + 8.f * e)) * 0.5f);  // e = tt (tt - 1) / 2 + ss
    if (tt * (tt - 1) / 2 > e) --tt;
    if ((tt + 1) * tt / 2 <= e) ++tt;
    const int ss = e - tt * (tt - 1) / 2;
    const int t = i * kSub + tt, s = i * kSub + ss;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int c = 0; c < K; c += 2) {
      const float2 rv = pair_at(Rc, c, t), kv = pair_at(Kc, c, s);
      const float2 ev = pair_at(Cc, c, t - 1), cv = pair_at(Cc, c, s);  // el_t = cl_{t-1}
      a0 = fmaf(rv.x * kv.x, __expf(ev.x - cv.x), a0);
      a1 = fmaf(rv.y * kv.y, __expf(ev.y - cv.y), a1);
    }
    Ai[tt * kLdD + ss] = a0 + a1;
  }
  if (lane < kSub) {
    const int t = i * kSub + lane;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int c = 0; c < K; c += 2) {
      const float2 rv = pair_at(Rc, c, t), kv = pair_at(Kc, c, t);
      a0 = fmaf(rv.x * kv.x, Us[c], a0);
      a1 = fmaf(rv.y * kv.y, Us[c + 1], a1);
    }
    Ai[lane * kLdD + lane] = a0 + a1;
  }
  for (int e = lane; e < kSub * kSub; e += 32) {
    const int tt = e / kSub, ss = e - tt * kSub;
    if (ss > tt) Ai[tt * kLdD + ss] = 0.f;
  }
  __syncthreads();  // the pairs have read the raw r and k

  // the decayed r and k, in place, and the tables of exp(G_i) and of the gaps
  for (int e = tid; e < K / 2 * kC; e += kThreads) {
    const int cp = e / kC, t = e - cp * kC, c = 2 * cp;
    const float2 el = (t & (kSub - 1)) ? pair_at(Cc, c, t - 1) : make_float2(0.f, 0.f);
    const float2 cv = pair_at(Cc, c, t);
    const float* tj = Ts + (t / kSub) * K + c;
    float2* rp = reinterpret_cast<float2*>(Rc + cp * kPL + 2 * t);
    float2* kp = reinterpret_cast<float2*>(Kc + cp * kPL + 2 * t);
    float2 rv = *rp, kv = *kp;
    rv.x *= __expf(el.x);
    rv.y *= __expf(el.y);
    kv.x *= __expf(tj[0] - cv.x);
    kv.y *= __expf(tj[1] - cv.y);
    *rp = rv;
    *kp = kv;
  }
  for (int c = tid; c < K; c += kThreads) {
    for (int ii = 0; ii < kNSub; ++ii) {
      Gx[ii * K + c] = expf(left_sum(Ts, K, c, 0, ii));
      for (int j = 0; j < ii; ++j) Fx[pair(ii, j) * K + c] = expf(left_sum(Ts, K, c, j + 1, ii));
    }
  }
  __syncthreads();

  // the incoming state's share: (r exp(el) exp(G_i)) . S_in, S_in^T from the scratch
  float yacc[K / 8][4] = {};
  const float* sp = s_in + ((long long)bh * nc + chunk) * K * K;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    FragA a;
    frag_a_tok(a, Rc, i * kSub, 16 * ks, Gx + i * K, lane);
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      FragB bb;
      frag_b_rows<true>(bb, sp + (8 * nt) * K + 16 * ks, K, lane);
      mma_split<true, true>(yacc[nt], a, bb);
    }
  }

  // the scores of the earlier sub-chunks j < i, the reference at j's end
  float sacc[kNSub - 1][2][4] = {};
#pragma unroll
  for (int j = 0; j < kNSub - 1; ++j) {
    if (j < i) {
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
        FragA a;
        frag_a_tok(a, Rc, i * kSub, 16 * ks, Fx + pair(i, j) * K, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          FragB bb;
          frag_b_tok(bb, Kc, j * kSub + 8 * nt, 16 * ks, lane);
          mma_split<true, true>(sacc[j][nt], a, bb);
        }
      }
    }
  }

  // y += A . V over the key sub-chunks 0 .. i
  auto add_av = [&](const FragA& a, int j) {
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      FragB bb;
      frag_b<kF32>(bb, lane, [&](int kk, int nn) { return to_f(Vs[(j * kSub + kk) * LV + 8 * nt + nn]); });
      mma_split<true, kF32>(yacc[nt], a, bb);
    }
  };
#pragma unroll
  for (int j = 0; j < kNSub - 1; ++j) {
    if (j < i) {
      FragA a;
      frag_a_from_c<true>(a, sacc[j][0], sacc[j][1]);
      add_av(a, j);
    }
  }
  {
    FragA a;
    frag_a_rows<true>(a, Ai, kLdD, lane);
    add_av(a, i);
  }

  const int t = t0 + i * kSub + gr;
#pragma unroll
  for (int nt = 0; nt < K / 8; ++nt) {
    const long long off = base + (long long)t * tok + 8 * nt + 2 * qd;
    if (t < S) store2(y + off, yacc[nt][0], yacc[nt][1]);
    if (t + 8 < S) store2(y + off + 8 * tok, yacc[nt][2], yacc[nt][3]);
  }
}

template <int K>
constexpr size_t state_smem() {
  return sizeof(float) * (size_t)(2 * kC * (K + 4) + 2 * kNSub * K + 128);
}
template <typename T, int K>
constexpr size_t out_smem() {
  return sizeof(float) * (size_t)(3 * K / 2 * kPL + 2 * kNSub * K + K + kPairs * K + 128 +
                                  kNSub * kSub * kLdD) +
         sizeof(T) * (size_t)(kC * out_ldv<T, K>());
}

template <typename T, int K>
int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* sf, void* ds, void* decay, int B, int S, int H,
             cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC;
  cudaError_t err = cudaFuncSetAttribute(wkv_chunk_state<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_smem<K>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_chunk_out<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem<T, K>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nc, B * H);
  wkv_chunk_state<T, K><<<grid, kThreads, state_smem<K>(), stream>>>(
      (const T*)k, (const T*)v, (const T*)w, (float*)ds, (float*)decay, S, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the scratch holds S^T: the decay is per column, s0 and s_final transposed
  err = launch_state_pass<true, true>((float*)ds, (const float*)decay, (const float*)s0,
                                      (float*)sf, B * H, nc, K, K, stream);
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_out<T, K><<<grid, kThreads, out_smem<T, K>(), stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u, (const float*)ds,
      (T*)y, S, H, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* sf, void* ds, void* decay, int B, int S, int H, int K,
           cudaStream_t st) {
  switch (K) {
    case 16: return launch_k<T, 16>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 32: return launch_k<T, 32>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 48: return launch_k<T, 48>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 64: return launch_k<T, 64>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 80: return launch_k<T, 80>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 96: return launch_k<T, 96>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 112: return launch_k<T, 112>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
    case 128: return launch_k<T, 128>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w and y).  s0 may be null.  ds is a
// float32 scratch of B * H * ceil(S / 64) * K * K values, decay one of
// B * H * ceil(S / 64) * K.  Pointers 16-byte aligned, tensors contiguous.
int wkv_scan_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                 const void* s0, void* y, void* sf, void* ds, void* decay, int B, int S, int H,
                 int K, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 16 || K > kMaxK || K % 16 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, K, st);
  if (dtype == 1) return launch<bf16>(r, k, v, w, u, s0, y, sf, ds, decay, B, S, H, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
