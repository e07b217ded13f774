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
//   y_t = sum_{s <= t} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
//         + exp(cs_t) h_prev C_t + D_h x_t
//   h   = exp(cs_end) h_prev + sum_s exp(cs_end - cs_s) dt_s x_s B_s^T
// Every exponent is <= 0 on the diagonal and below; above it the band is
// selected to 0 before any product, so strong decay gives no inf * 0.
//
// x, b, c (model dtype: bfloat16 or float32) in the model's layout, x
// (B, S, H, P) and b, c (B, S, N); dt (B, S, H), a (H,), d_skip (H,), h0
// (B, H, P, N) float32 (h0 may be null: zeros); y (B, S, H, P) in x's type
// and h_final (B, H, P, N) float32.  Everything is computed in float32.
// Any S (the ragged last chunk is padded with zero x, B, C and dt, which
// adds nothing to y or h), P a multiple of 16, N a multiple of 16 up to 128.
//
// Bound on an H100: operations.  At zamba2-1.2b's served prefill (B 1,
// S 32,768, H 64, P 64, N 64, bf16) the recurrence does 4 N P flops per
// token and head (34.4 GFLOP: 0.513 ms at the 67 TFLOP/s fp32 rate) against
// about 555 MB of x, y, dt, B, C and the states (0.166 ms at 3.35 TB/s).
//
// Design (simple first): one block of 256 threads per (batch * head, 16 of
// the P columns), so the served shape runs 64 x 4 = 256 blocks, two per SM.
// h's P rows are independent, so each block carries its 16 x N slice of h
// in shared memory (double-buffered) and walks the sequence in chunks of
// 32 tokens, one warp's lanes:
//   1. the chunk's B and C (all N columns), dt and its 16 columns of x are
//      staged in shared memory as float32 from registers that were loaded
//      while the previous chunk computed;
//   2. every warp scans the chunk's a dt with shuffles (lane = token), so
//      cs is in registers everywhere without another barrier;
//   3. thread (ti, si) forms the band M[t][s] = (C_t . B_s) exp(cs_t - cs_s)
//      for t in {ti, ti + 16}, s in {si, si + 16} (float4 rows of C and B),
//      0 above the diagonal;
//   4. thread (t, j) forms y for tokens t and t + 16 of column j (the band
//      against dt x, exp(cs_t) C_t against the old h, D x); meanwhile each
//      thread updates its float4s of h into the other buffer.
// Three block barriers a chunk.  No atomics and a fixed order everywhere:
// two launches give the same bits.  Sharing C B^T across heads (this design
// recomputes it for every head and slice), wgmma, TMA and a chunk-parallel
// scan are later work.
//
// The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;          // tokens per chunk: one warp's lanes
constexpr int kPB = 16;         // P columns per block
constexpr int kThreads = 256;
constexpr int kMaxN = 128;
constexpr int kLM = 48;         // row stride of M: float4 rows, rows t and t + 1 16 banks apart
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int N>
constexpr size_t smem_floats() {
  // B, C, two buffers of h, M, x dt, x, x dt exp(cs_end - cs), dt, exp(cs)
  return (size_t)(2 * kC + 2 * kPB) * (N + 4) + kC * kLM + 3 * kC * kPB + 2 * kC;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
        const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ dskip,
        const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hf,
        int S, int H, int P) {
  constexpr int LN = N + 4;                    // row stride of the n-major tiles: float4
                                               // rows, 8 consecutive rows on 32 banks
  constexpr int LN4 = LN / 4, LM4 = kLM / 4;
  constexpr int kPerBC = kC * N / kThreads;    // B and C elements a thread stages
  constexpr int kPerX = kC * kPB / kThreads;   // x elements a thread stages (2)
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [kC][LN] B
  float* Cs = Bs + kC * LN;                     // [kC][LN] C
  float* Hs = Cs + kC * LN;                     // [2][kPB][LN] h[p0 + j][n]
  float* Ms = Hs + 2 * kPB * LN;                // [kC][kLM] the band
  float* Xs = Ms + kC * kLM;                    // [kC][kPB] dt x
  float* Xr = Xs + kC * kPB;                    // [kC][kPB] x
  float* Xw = Xr + kC * kPB;                    // [kC][kPB] exp(cs_end - cs) dt x
  float* Dt = Xw + kC * kPB;                    // [kC] dt
  float* Ec = Dt + kC;                          // [kC] exp(cs)
  const float4* B4 = reinterpret_cast<const float4*>(Bs);
  const float4* C4 = reinterpret_cast<const float4*>(Cs);
  const float4* M4 = reinterpret_cast<const float4*>(Ms);

  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * kPB;
  const float ah = a[h], dh = dskip[h];
  const long long xrow = (long long)H * P;      // x and y: stride between tokens
  const long long xbase = (long long)b * S * xrow + (long long)h * P + p0;
  const long long dbase = (long long)b * S * H + h;
  const long long nbase = (long long)b * S * N;
  const long long hbase = ((long long)bh * P + p0) * N;

  for (int e = tid; e < kPB * N; e += kThreads) {
    const int j = e / N, n = e - j * N;
    Hs[j * LN + n] = h0 != nullptr ? h0[hbase + e] : 0.f;
  }

  // the next chunk's inputs, raw: their loads fly while the current chunk
  // computes, and are converted when staged
  T bv[kPerBC], cv[kPerBC], xv[kPerX];
  float dv[kPerX];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPerBC; ++i) {
      const int idx = tid + i * kThreads, t = idx / N, n = idx - t * N;
      const bool ok = t0 + t < S;
      const long long off = nbase + (long long)(t0 + t) * N + n;
      bv[i] = ok ? bm[off] : zero_of<T>();
      cv[i] = ok ? cm[off] : zero_of<T>();
    }
#pragma unroll
    for (int i = 0; i < kPerX; ++i) {
      const int idx = tid + i * kThreads, t = idx >> 4, j = idx & 15;
      const bool ok = t0 + t < S;
      xv[i] = ok ? x[xbase + (long long)(t0 + t) * xrow + j] : zero_of<T>();
      dv[i] = ok ? dt[dbase + (long long)(t0 + t) * H] : 0.f;
    }
  };

  fetch(0);
  int cur = 0;
  for (int t0 = 0; t0 < S; t0 += kC) {
    // 1. stage the chunk (tokens past S are zeros: they add nothing)
#pragma unroll
    for (int i = 0; i < kPerBC; ++i) {
      const int idx = tid + i * kThreads, t = idx / N, n = idx - t * N;
      Bs[t * LN + n] = to_f(bv[i]);
      Cs[t * LN + n] = to_f(cv[i]);
    }
#pragma unroll
    for (int i = 0; i < kPerX; ++i) {
      const int idx = tid + i * kThreads;
      const float xf = to_f(xv[i]);
      Xr[idx] = xf;
      Xs[idx] = xf * dv[i];
      if ((idx & 15) == 0) Dt[idx >> 4] = dv[i];
    }
    __syncthreads();
    if (t0 + kC < S) fetch(t0 + kC);

    // 2. cs, inclusive, by every warp (lane = token); exp(cs) and the
    //    weights exp(cs_end - cs_s) of the state update
    float cs = ah * Dt[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, cs, o);
      if (lane >= o) cs += u;
    }
    const float cend = __shfl_sync(kFull, cs, 31);
    const float eend = expf(cend);
    const float wd = expf(cend - cs);
    if (tid < kC) Ec[tid] = expf(cs);
#pragma unroll
    for (int i = 0; i < kPerX; ++i) {
      const int idx = tid + i * kThreads;
      Xw[idx] = Xs[idx] * __shfl_sync(kFull, wd, idx >> 4);
    }

    // 3. the band, rows {ti, ti + 16} x columns {si, si + 16}: (ti + 16, si)
    //    is always on or below the diagonal, (ti, si + 16) never, the other
    //    two when ti >= si.  Selected before any product with exp.
    {
      const int ti = tid >> 4, si = tid & 15;
      float m00 = 0.f, m10 = 0.f, m11 = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 c0 = C4[ti * LN4 + q], c1 = C4[(ti + 16) * LN4 + q];
        const float4 b0 = B4[si * LN4 + q], b1 = B4[(si + 16) * LN4 + q];
        m00 = dot4(c0, b0, m00);
        m10 = dot4(c1, b0, m10);
        m11 = dot4(c1, b1, m11);
      }
      const float ct0 = __shfl_sync(kFull, cs, ti), ct1 = __shfl_sync(kFull, cs, ti + 16);
      const float cs0 = __shfl_sync(kFull, cs, si), cs1 = __shfl_sync(kFull, cs, si + 16);
      const bool lower = ti >= si;
      Ms[ti * kLM + si] = lower ? m00 * expf(ct0 - cs0) : 0.f;
      Ms[ti * kLM + si + 16] = 0.f;
      Ms[(ti + 16) * kLM + si] = m10 * expf(ct1 - cs0);
      Ms[(ti + 16) * kLM + si + 16] = lower ? m11 * expf(ct1 - cs1) : 0.f;
    }
    __syncthreads();

    // 4. y for tokens t, t + 16 of column j; h into the other buffer
    {
      const int t = tid >> 4, j = tid & 15;
      const float* Hc = Hs + cur * kPB * LN;
      const float4* H4 = reinterpret_cast<const float4*>(Hc);
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int q = 0; q < kC / 4; ++q) {
        const float4 m0 = M4[t * LM4 + q], m1 = M4[(t + 16) * LM4 + q];
        const float x0 = Xs[(4 * q) * kPB + j], x1 = Xs[(4 * q + 1) * kPB + j];
        const float x2 = Xs[(4 * q + 2) * kPB + j], x3 = Xs[(4 * q + 3) * kPB + j];
        y0 = fmaf(m0.x, x0, y0); y0 = fmaf(m0.y, x1, y0);
        y0 = fmaf(m0.z, x2, y0); y0 = fmaf(m0.w, x3, y0);
        y1 = fmaf(m1.x, x0, y1); y1 = fmaf(m1.y, x1, y1);
        y1 = fmaf(m1.z, x2, y1); y1 = fmaf(m1.w, x3, y1);
      }
      float i0 = 0.f, i1 = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 hv = H4[j * LN4 + q];
        i0 = dot4(C4[t * LN4 + q], hv, i0);
        i1 = dot4(C4[(t + 16) * LN4 + q], hv, i1);
      }
      y0 += Ec[t] * i0;
      y1 += Ec[t + 16] * i1;
      y0 += Xr[t * kPB + j] * dh;
      y1 += Xr[(t + 16) * kPB + j] * dh;
      if (t0 + t < S) store(&y[xbase + (long long)(t0 + t) * xrow + j], y0);
      if (t0 + t + 16 < S) store(&y[xbase + (long long)(t0 + t + 16) * xrow + j], y1);

      float4* Hn = reinterpret_cast<float4*>(Hs + (cur ^ 1) * kPB * LN);
      for (int e = tid; e < kPB * N / 4; e += kThreads) {
        const int jj = e / (N / 4), q = e - jj * (N / 4);
        float4 hv = H4[jj * LN4 + q];
        hv.x *= eend; hv.y *= eend; hv.z *= eend; hv.w *= eend;
#pragma unroll 8
        for (int s = 0; s < kC; ++s) {
          const float xw = Xw[s * kPB + jj];
          const float4 bb = B4[s * LN4 + q];
          hv.x = fmaf(xw, bb.x, hv.x);
          hv.y = fmaf(xw, bb.y, hv.y);
          hv.z = fmaf(xw, bb.z, hv.z);
          hv.w = fmaf(xw, bb.w, hv.w);
        }
        Hn[jj * LN4 + q] = hv;
      }
    }
    cur ^= 1;
    __syncthreads();  // the next chunk overwrites the tiles and reads the new h
  }

  const float* Hc = Hs + cur * kPB * LN;
  for (int e = tid; e < kPB * N; e += kThreads) {
    const int j = e / N, n = e - j * N;
    hf[hbase + e] = Hc[j * LN + n];
  }
}

template <typename T, int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* dskip, const void* h0, void* y, void* hf, int B, int S, int H, int P,
             cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<N>();
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, P / kPB);
  ssd_fwd<T, N><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b, (const T*)c,
      (const float*)dskip, (const float*)h0, (T*)y, (float*)hf, S, H, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dskip, const void* h0, void* y, void* hf, int B, int S, int H, int P,
           int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch_n<T, 16>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 32: return launch_n<T, 32>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 48: return launch_n<T, 48>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 64: return launch_n<T, 64>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 80: return launch_n<T, 80>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 96: return launch_n<T, 96>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 112: return launch_n<T, 112>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
    case 128: return launch_n<T, 128>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, b, c and y); dt, a, d_skip, h0 and
// h_final float32.  h0 may be null.  Tensors contiguous, pointers 16-byte
// aligned.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* b, const void* c,
                 const void* dskip, const void* h0, void* y, void* hf, int B, int S, int H,
                 int P, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < kPB || P % kPB || P / kPB > 65535 || N < 16 ||
      N > kMaxN || N % 16 || (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, N, st);
  if (dtype == 1) return launch<bf16>(x, dt, a, b, c, dskip, h0, y, hf, B, S, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
