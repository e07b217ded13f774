// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel ssd_scan_fwd of
// src/repro/kernels/mamba2_scan/kernel.py:71, with the prologue and epilogue
// of its wrapper ssd_chunked_pallas (src/repro/kernels/mamba2_scan/ops.py)
// fused in, so the float32 (B, S, H, P) x * dt and y are never written out.
//
// Per (batch, head), with the state h in R^{P x N} and a_h < 0:
//   h_t = exp(a_h dt_t) h_{t-1} + (dt_t x_t) B_t^T
//   y_t = h_t C_t + D_h x_t
// B and C are shared across heads (ngroups = 1).  In chunks of kC tokens,
// with cs the inclusive cumulative sum of a_h dt over the chunk:
//   y_t = sum_{s <= t} ((C_t . B_s) exp(cs_t - cs_s) dt_s) x_s
//         + exp(cs_t) (C_t . h_prev) + D_h x_t
//   h   = exp(cs_end) h_prev + sum_s (x_s exp(cs_end - cs_s) dt_s) B_s^T
// Every exponent is <= 0 on the diagonal and below; above it the band is
// selected to 0 before any product, so strong decay gives no inf * 0.
//
// x, b, c (model dtype: bfloat16 or float32) in the model's layout, x
// (B, S, H, P) and b, c (B, S, N); dt (B, S, H), a (H,), d_skip (H,), h0
// (B, H, P, N) float32 (h0 may be null: zeros); y (B, S, H, P) in x's type
// and h_final (B, H, P, N) float32.  Everything is computed to float32
// accuracy.  Any S (the ragged last chunk is padded with zero x, B, C and
// dt, which adds nothing to y or h), P a multiple of 16, N a multiple of 16
// up to 128.
//
// Bound on an H100: bytes.  At zamba2-1.2b's served prefill (B 1, S 32,768,
// H 64, P 64, N 64, bf16) the kernel moves about 555 MB of x, y, dt, B, C
// and the states (0.166 ms at 3.35 TB/s); the recurrence's 4 N P flops per
// token and head (34.4 GFLOP) take 0.035 ms at the bf16 tensor-core rate,
// where the products run (the hi/lo split's three passes and the chunk
// form raise the kernel's own floor above that).
//
// Design: a chunk-parallel scan in three launches, chunks of kC = 64 tokens;
// a block of 128 threads takes one chunk of a group of kHG = 8 heads.
//   1. ssd_chunk_state, grid (chunk, batch * head group): per head, warp 0
//      scans a dt over the chunk with shuffles (the next head's dt loading);
//      the chunk's change of the state,
//      dh = sum_s (x_s exp(cs_end - cs_s) dt_s) B_s^T, goes to a
//      float32 scratch (B, H, n_chunks, P, N) and its decay exp(cs_end) to a
//      second one.  The blocks of head group 0 also compute the chunk's
//      C . B^T, once for all heads, into a third (B, n_chunks, kC, kC).
//   2. chunk_scan::state_pass, grid (state elements, batch * head): the
//      state each chunk starts from, h <- exp(cs_end) h + dh over the chunks,
//      in place of dh; h0 seeds it, the last value is h_final.
//   3. ssd_chunk_out, grid (chunk, batch * head group): warp w owns the
//      chunk's tokens 16 w .. 16 w + 15 and keeps its rows of C . B^T in
//      registers for all the group's heads; per head it forms the band
//      M'[t][s] = (C.B^T)[t][s] exp(cs_t - cs_s) dt_s (s <= t) in the layout
//      of an A fragment, and y = exp(cs_t) (C . h_in) + M' . x + D x, with
//      the head's h_in staged in shared memory by cp.async.
// The chunk products (C . B^T, dh, C . h_in, M' . x) run on the tensor cores
// as mma.sync m16n8k16 in bf16 with float32 accumulators.  A float32 operand
// (M', the weighted x of dh, the state) is split into a bf16 hi and lo term
// and the product takes hi.hi + hi.lo + lo.hi, so it keeps float32 accuracy
// (the products of the TPU kernel are float32); x, B and C of the bf16
// model are exact in one term, and so C . B^T is one exact pass.  Loads are
// 16 bytes a thread, and the next head's x is in flight while the block
// computes on the current one.  The chunks run in parallel: 4,096 blocks at
// the served shape, where the simple design's 256 blocks each walked the
// whole sequence and recomputed C . B^T for every head.  The scratch is
// 4 P N bytes a chunk and head (537 MB at the served shape), written once,
// read and written by the state pass and read once.  P is taken in slices
// of up to 64 columns.
// No atomics and a fixed order everywhere: two launches give the same bits.
//
// The entry point returns cudaGetLastError().

#include <type_traits>

#include "chunk_scan.cuh"

namespace {

using namespace chunk_scan;

constexpr int kC = 64;          // tokens per chunk
constexpr int kThreads = 128;   // warp w: tokens 16 w .. 16 w + 15
constexpr int kHG = 8;          // heads a block
constexpr int kPS = 64;         // columns of P a slice
constexpr int kLX = kPS + 4;    // row stride of the x slice: read down a column
constexpr int kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;

// Warp 0: dt of head h over the chunk's tokens (lanes l and l + 32); load()
// issues the loads (so they fly while the previous head computes), scan()
// takes the inclusive cumulative sum of a_h dt into (c0, c1).
struct ChunkDt {
  float d0, d1;

  __device__ __forceinline__ void load(const float* __restrict__ dt, int b, int S, int H, int t0,
                                       int h, int lane) {
    const long long at = ((long long)b * S + t0 + lane) * H + h;
    d0 = t0 + lane < S ? dt[at] : 0.f;
    d1 = t0 + lane + 32 < S ? dt[at + 32LL * H] : 0.f;
  }
  __device__ __forceinline__ void scan(float ah, int lane, float& c0, float& c1) const {
    c0 = ah * d0;
    c1 = ah * d1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u0 = __shfl_up_sync(kFull, c0, o), u1 = __shfl_up_sync(kFull, c1, o);
      if (lane >= o) {
        c0 += u0;
        c1 += u1;
      }
    }
    c1 += __shfl_sync(kFull, c0, 31);
  }
};

// the x of head h, columns p0 .. p0 + width of the chunk's tokens
template <typename T>
__device__ __forceinline__ const T* x_rows(const T* x, int b, int S, int H, int P, int t0, int h,
                                           int p0) {
  return x + (((long long)b * S + t0) * H + h) * P + p0;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm, const T* __restrict__ cm,
                float* __restrict__ dh, float* __restrict__ decay, float* __restrict__ cb,
                int S, int H, int P, int nc) {
  constexpr int LB = N + 4;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float smem[];
  float* Bs = smem;              // [kC][LB] B
  float* Cs = Bs + kC * LB;      // [kC][LB] C (head group 0)
  float* Xs = Cs + kC * LB;      // [kC][kLX] a slice of x
  float* Ws = Xs + kC * kLX;     // [kC] exp(cs_end - cs) dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, qd = lane & 3;
  const int nhg = (H + kHG - 1) / kHG;
  const int chunk = blockIdx.x, b = blockIdx.y / nhg, hg = blockIdx.y - b * nhg;
  const int t0 = chunk * kC;
  const int h_end = min(H, (hg + 1) * kHG);
  const long long nbase = ((long long)b * S + t0) * N;

  Tile<T, kC, kPS, kThreads, false> tx;  // x of the next head, in flight
  tx.load(x_rows(x, b, S, H, P, t0, hg * kHG, 0), (long long)H * P, S - t0, min(kPS, P));
  ChunkDt cd;                            // its dt (warp 0)
  if (warp == 0) cd.load(dt, b, S, H, t0, hg * kHG, lane);
  {
    Tile<T, kC, N, kThreads, false> tb;
    tb.load(bm + nbase, N, S - t0, N);
    tb.store_rows(Bs, LB, N);
  }
  if (hg == 0) {
    // C . B^T of the chunk, once for all heads: warp w's rows, the blocks
    // on and below the diagonal
    {
      Tile<T, kC, N, kThreads, false> tc;
      tc.load(cm + nbase, N, S - t0, N);
      tc.store_rows(Cs, LB, N);
    }
    __syncthreads();
    float* out = cb + ((long long)b * nc + chunk) * kC * kC;
#pragma unroll
    for (int kb = 0; kb < kC / 16; ++kb) {
      if (kb <= warp) {
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          FragA fa;
          frag_a_rows<kF32>(fa, Cs + 16 * warp * LB + 16 * ks, LB, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            FragB fb;
            frag_b_rows<kF32>(fb, Bs + (16 * kb + 8 * nt) * LB + 16 * ks, LB, lane);
            mma_split<kF32, kF32>(acc[nt], fa, fb);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float* o = out + (16 * warp + gr) * kC + 16 * kb + 8 * nt + 2 * qd;
          store2(o, acc[nt][0], acc[nt][1]);
          store2(o + 8 * kC, acc[nt][2], acc[nt][3]);
        }
      }
    }
  }

  for (int h = hg * kHG; h < h_end; ++h) {
    const long long bhh = (long long)b * H + h;
    __syncthreads();  // B is staged; the previous head's Xs and Ws are read
    if (warp == 0) {
      float c0, c1;
      cd.scan(a[h], lane, c0, c1);
      const float end = __shfl_sync(kFull, c1, 31);
      Ws[lane] = expf(end - c0) * cd.d0;
      Ws[lane + 32] = expf(end - c1) * cd.d1;
      if (lane == 0) decay[bhh * nc + chunk] = expf(end);
      if (h + 1 < h_end) cd.load(dt, b, S, H, t0, h + 1, lane);
    }
    for (int p0 = 0; p0 < P; p0 += kPS) {
      const int pw = min(kPS, P - p0);
      if (p0 > 0) {
        __syncthreads();
        tx.load(x_rows(x, b, S, H, P, t0, h, p0), (long long)H * P, S - t0, pw);
      }
      tx.store_rows(Xs, kLX, pw);
      // the next head's first slice flies while this one computes
      if (p0 + kPS >= P && h + 1 < h_end)
        tx.load(x_rows(x, b, S, H, P, t0, h + 1, 0), (long long)H * P, S - t0, min(kPS, P));
      __syncthreads();
      // dh[p][n] = sum_s (x[s][p] W[s]) B[s][n]; warp w takes the row tile w
      if (16 * warp < pw) {
        float acc[N / 8][4] = {};
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          FragA fa;
          frag_a<true>(fa, lane, [&](int rr, int cc) {
            const int s = 16 * ks + cc;
            return Xs[s * kLX + 16 * warp + rr] * Ws[s];
          });
#pragma unroll
          for (int nt = 0; nt < N / 8; ++nt) {
            FragB fb;
            frag_b<kF32>(fb, lane, [&](int kk, int nn) { return Bs[(16 * ks + kk) * LB + 8 * nt + nn]; });
            mma_split<true, kF32>(acc[nt], fa, fb);
          }
        }
        float* o = dh + (bhh * nc + chunk) * P * N + (long long)(p0 + 16 * warp + gr) * N + 2 * qd;
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt) {
          store2(o + 8 * nt, acc[nt][0], acc[nt][1]);
          store2(o + 8 * nt + 8 * N, acc[nt][2], acc[nt][3]);
        }
      }
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 4)
ssd_chunk_out(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
              const T* __restrict__ cm, const float* __restrict__ dskip,
              const float* __restrict__ h_in, const float* __restrict__ cb, T* __restrict__ y,
              int S, int H, int P, int nc) {
  constexpr int LC = N + 8;  // rows read along N as float2: conflict-free
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float smem[];
  float* Cs = smem;              // [kC][LC] C
  float* Xs = Cs + kC * LC;      // [kC][kLX] a slice of x
  float* Ds = Xs + kC * kLX;     // [kC] dt
  float* Gs = Ds + kC;           // [kC] cs
  float* Es = Gs + kC;           // [kC] exp(cs)
  float* Hs = Es + kC;           // [kPS][LC] h_in of the head, a slice of P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, qd = lane & 3;
  const int nhg = (H + kHG - 1) / kHG;
  const int chunk = blockIdx.x, b = blockIdx.y / nhg, hg = blockIdx.y - b * nhg;
  const int t0 = chunk * kC;
  const int h_end = min(H, (hg + 1) * kHG);
  const int r0 = 16 * warp + gr;  // this lane's rows: r0 and r0 + 8
  // rows p of a head's h_in into Hs[p][n] by cp.async (waited for with the
  // staging of x)
  auto stage_state = [&](float* dst, const float* src, int rows) {
    for (int e = tid; e < rows * (N / 4); e += kThreads) {
      const int p = e / (N / 4), q = e - p * (N / 4);
      cp_async16(dst + p * LC + 4 * q, src + (long long)p * N + 4 * q);
    }
  };

  Tile<T, kC, kPS, kThreads, false> tx;  // x of the next head, in flight
  tx.load(x_rows(x, b, S, H, P, t0, hg * kHG, 0), (long long)H * P, S - t0, min(kPS, P));
  ChunkDt cd;                            // its dt (warp 0)
  if (warp == 0) cd.load(dt, b, S, H, t0, hg * kHG, lane);
  {
    Tile<T, kC, N, kThreads, false> tc;
    tc.load(cm + ((long long)b * S + t0) * N, N, S - t0, N);
    tc.store_rows(Cs, LC, N);
  }
  // this warp's rows of C . B^T, blocks kb <= warp, in the C layout
  float cbr[kC / 16][2][4] = {};
  {
    const float* src = cb + ((long long)b * nc + chunk) * kC * kC + r0 * kC + 2 * qd;
#pragma unroll
    for (int kb = 0; kb < kC / 16; ++kb) {
      if (kb <= warp) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 u0 = *reinterpret_cast<const float2*>(src + 16 * kb + 8 * nt);
          const float2 u1 = *reinterpret_cast<const float2*>(src + 16 * kb + 8 * nt + 8 * kC);
          cbr[kb][nt][0] = u0.x;
          cbr[kb][nt][1] = u0.y;
          cbr[kb][nt][2] = u1.x;
          cbr[kb][nt][3] = u1.y;
        }
      }
    }
  }

  for (int h = hg * kHG; h < h_end; ++h) {
    const long long bhh = (long long)b * H + h;
    const float* hp = h_in + (bhh * nc + chunk) * P * N;
    __syncthreads();  // C is staged; the previous head's Xs, Ds, Gs, Es, Hs are read
    stage_state(Hs, hp, min(kPS, P));
    if (warp == 0) {
      float c0, c1;
      cd.scan(a[h], lane, c0, c1);
      Ds[lane] = cd.d0;
      Ds[lane + 32] = cd.d1;
      Gs[lane] = c0;
      Gs[lane + 32] = c1;
      Es[lane] = expf(c0);
      Es[lane + 32] = expf(c1);
      if (h + 1 < h_end) cd.load(dt, b, S, H, t0, h + 1, lane);
    }
    const float dsk = dskip[h];
    tx.store_rows(Xs, kLX, min(kPS, P));
    if (P <= kPS && h + 1 < h_end)  // the next head's x flies while this one computes
      tx.load(x_rows(x, b, S, H, P, t0, h + 1, 0), (long long)H * P, S - t0, P);
    cp_async_wait_all();
    __syncthreads();

    for (int p0 = 0; p0 < P; p0 += kPS) {
      const int pw = min(kPS, P - p0);
      if (p0 > 0) {
        __syncthreads();
        stage_state(Hs, hp + (long long)p0 * N, pw);
        tx.load(x_rows(x, b, S, H, P, t0, h, p0), (long long)H * P, S - t0, pw);
        tx.store_rows(Xs, kLX, pw);
        if (p0 + kPS >= P && h + 1 < h_end)
          tx.load(x_rows(x, b, S, H, P, t0, h + 1, 0), (long long)H * P, S - t0, kPS);
        cp_async_wait_all();
        __syncthreads();
      }
      // the incoming state's share C . h_in^T, scaled by exp(cs_t)
      float acc[kPS / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        FragA fa;
        frag_a_rows<kF32>(fa, Cs + 16 * warp * LC + 16 * ks, LC, lane);
#pragma unroll
        for (int nt = 0; nt < kPS / 8; ++nt) {
          if (8 * nt < pw) {
            FragB fb;
            frag_b_rows<true>(fb, Hs + (8 * nt) * LC + 16 * ks, LC, lane);
            mma_split<kF32, true>(acc[nt], fa, fb);
          }
        }
      }
      const float e0 = Es[r0], e1 = Es[r0 + 8];
#pragma unroll
      for (int nt = 0; nt < kPS / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      // the band M' . x, M'[t][s] = (C.B^T)[t][s] exp(cs_t - cs_s) dt_s (s <= t)
      // as A fragments from the C . B^T registers
#pragma unroll
      for (int kb = 0; kb < kC / 16; ++kb) {
        if (kb <= warp) {
          float m[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int t = r0 + 8 * (q >> 1), s = 16 * kb + 8 * nt + 2 * qd + (q & 1);
              m[nt][q] = s <= t ? (cbr[kb][nt][q] * __expf(Gs[t] - Gs[s])) * Ds[s] : 0.f;
            }
          }
          FragA mf;
          frag_a_from_c<true>(mf, m[0], m[1]);
#pragma unroll
          for (int nt = 0; nt < kPS / 8; ++nt) {
            if (8 * nt < pw) {
              FragB fb;
              frag_b<kF32>(fb, lane, [&](int kk, int nn) {
                return Xs[(16 * kb + kk) * kLX + 8 * nt + nn];
              });
              mma_split<true, kF32>(acc[nt], mf, fb);
            }
          }
        }
      }
      // + D x, in x's type
#pragma unroll
      for (int nt = 0; nt < kPS / 8; ++nt) {
        if (8 * nt < pw) {
          const int col = 8 * nt + 2 * qd;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = r0 + 8 * half;
            if (t0 + t < S) {
              const float* xr = Xs + t * kLX + col;
              store2(y + (((long long)b * S + t0 + t) * H + h) * P + p0 + col,
                     acc[nt][2 * half] + xr[0] * dsk, acc[nt][2 * half + 1] + xr[1] * dsk);
            }
          }
        }
      }
    }
  }
}

template <int N>
constexpr size_t state_smem() {
  return sizeof(float) * (size_t)(2 * kC * (N + 4) + kC * kLX + kC);
}
template <int N>
constexpr size_t out_smem() {
  return sizeof(float) * (size_t)((kC + kPS) * (N + 8) + kC * kLX + 3 * kC);
}

template <typename T, int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* dskip, const void* h0, void* y, void* hf, void* dh, void* decay,
             void* cb, int B, int S, int H, int P, cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_smem<N>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_out<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem<N>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nc, B * ((H + kHG - 1) / kHG));
  ssd_chunk_state<T, N><<<grid, kThreads, state_smem<N>(), stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b, (const T*)c, (float*)dh,
      (float*)decay, (float*)cb, S, H, P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = launch_state_pass<false, false>((float*)dh, (const float*)decay, (const float*)h0,
                                        (float*)hf, B * H, nc, P, N, stream);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<T, N><<<grid, kThreads, out_smem<N>(), stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)c, (const float*)dskip,
      (const float*)dh, (const float*)cb, (T*)y, S, H, P, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dskip, const void* h0, void* y, void* hf, void* dh, void* decay,
           void* cb, int B, int S, int H, int P, int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch_n<T, 16>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 32: return launch_n<T, 32>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 48: return launch_n<T, 48>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 64: return launch_n<T, 64>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 80: return launch_n<T, 80>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 96: return launch_n<T, 96>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 112: return launch_n<T, 112>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
    case 128: return launch_n<T, 128>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, b, c and y); dt, a, d_skip, h0 and
// h_final float32.  h0 may be null.  dh is a float32 scratch of
// B * H * ceil(S / 64) * P * N values, decay one of B * H * ceil(S / 64),
// cb one of B * ceil(S / 64) * 64 * 64.  Tensors contiguous, pointers
// 16-byte aligned.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* b, const void* c,
                 const void* dskip, const void* h0, void* y, void* hf, void* dh, void* decay,
                 void* cb, int B, int S, int H, int P, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 16 || P % 16 || N < 16 || N > kMaxN || N % 16 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, N, st);
  if (dtype == 1)
    return launch<bf16>(x, dt, a, b, c, dskip, h0, y, hf, dh, decay, cb, B, S, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
