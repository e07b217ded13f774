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
// computed in float32; log w is taken here, clamped at -80.  Any S, K a
// multiple of 16 up to 128.
//
// Bound on an H100: operations, barely.  At rwkv6-1.6b's served prefill
// (B 1, S 32,768, H 32, K 64, bf16) the recurrence does 4 K^2 flops per
// token and head (17.2 GFLOP: 0.26 ms at the 67 TFLOP/s fp32 rate) against
// 672 MB of r, k, v, w and y (0.20 ms at 3.35 TB/s).
//
// Design (simple first): one block of 256 threads per (batch * head, 16
// value columns), so the served shape runs 32 x 4 = 128 blocks; K is a
// template parameter, so every loop over it unrolls.  The V
// columns of the state are independent, so each block owns a K x 16 slice
// of it in registers (thread (vv, kq) holds rows kq, kq + 16, ... of column
// vv) and walks the sequence in chunks of 16 tokens:
//   1. the chunk's r, k and log w (all K rows) and v (its 16 columns) are
//      staged in shared memory as float32, k-major with a padded stride;
//      tokens past S are zero (log w = 0), which adds nothing;
//   2. one thread per row takes the cumulative log decay cs (inclusive) and
//      excl = cs - log w;
//   3. A[t][s] = sum_k r_t k_s exp(excl_t - cs_s) for s < t, by thread
//      (t, s) (every factor <= 1: strong decays cannot overflow, where the
//      TPU kernel scales k by exp(-cs)), A[t][t] = sum_k r_t u k_t by the
//      first 16 threads; and the decayed rows
//      r_t exp(excl_t) and k_s exp(cs_end - cs_s);
//   4. each thread forms its rows' share of (r_t exp(excl_t))^T S for the
//      16 tokens, decays and updates its state rows
//      (S = exp(cs_end) S + sum_s (k_s exp(cs_end - cs_s)) v_s^T), and a
//      butterfly reduce-scatter over the 16 row groups leaves the lane of
//      row group t with token t's sum, to which it adds sum_s A[t][s] v_s.
// No atomics and a fixed order everywhere: two launches give the same bits.
// A chunk-parallel scan, tensor cores and pipelined loads are later work.
//
// The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;          // tokens per chunk
constexpr int kVB = 16;         // value columns per block
constexpr int kThreads = kVB * 16;
constexpr int kMaxK = 128;
constexpr int kLd = kC + 1;     // stride of the k-major chunk tiles (no bank conflicts)
constexpr float kLogWMin = -80.f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
        const T* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
        T* __restrict__ y, float* __restrict__ sf, int S, int H) {
  extern __shared__ float smem[];
  float* Rs = smem;               // [K][kLd] r
  float* Ks = Rs + K * kLd;       // [K][kLd] k
  float* Es = Ks + K * kLd;       // [K][kLd] log w, then excl
  float* Cs = Es + K * kLd;       // [K][kLd] cs
  float* RD = Cs + K * kLd;       // [K][kLd] r exp(excl)
  float* KD = RD + K * kLd;       // [K][kLd] k exp(cs_end - cs)
  float* Vs = KD + K * kLd;       // [kC][kVB] v, this block's columns
  float* As = Vs + kC * kVB;      // [kC][kLd] A, the diagonal with u
  float* Us = As + kC * kLd;      // [K] u
  float* Dk = Us + K;             // [K] exp(cs_end)

  const int tid = threadIdx.x;
  const int vv = tid >> 4, kq = tid & 15;  // lane bits 0-3: the row group
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int v0 = blockIdx.y * kVB;
  constexpr int nj = K >> 4;
  const long long tok = (long long)H * K;  // stride between tokens
  const long long base = (long long)b * S * tok + (long long)h * K;

  float st[nj];  // S[kq + 16 j][v0 + vv]
#pragma unroll
  for (int j = 0; j < nj; ++j)
    st[j] = s0 != nullptr ? s0[((long long)bh * K + kq + 16 * j) * K + v0 + vv] : 0.f;
  for (int i = tid; i < K; i += kThreads) Us[i] = u[(long long)h * K + i];

  for (int t0 = 0; t0 < S; t0 += kC) {
    // 1. stage the chunk: every global load of the thread issued before any
    //    store, so their latencies overlap
    constexpr int kPer = kC * K / kThreads;
    float rv[kPer], kv[kPer], wv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, t = idx / K, c = idx - t * K;
      rv[i] = kv[i] = 0.f;
      wv[i] = 1.f;
      if (t0 + t < S) {
        const long long off = base + (long long)(t0 + t) * tok + c;
        rv[i] = to_f(r[off]);
        kv[i] = to_f(k[off]);
        wv[i] = to_f(w[off]);
      }
    }
    {
      const int t = tid >> 4, j = tid & 15;  // kC * kVB == kThreads
      Vs[t * kVB + j] = (t0 + t < S) ? to_f(v[base + (long long)(t0 + t) * tok + v0 + j]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, t = idx / K, c = idx - t * K;
      Rs[c * kLd + t] = rv[i];
      Ks[c * kLd + t] = kv[i];
      Es[c * kLd + t] = fmaxf(logf(wv[i]), kLogWMin);
    }
    __syncthreads();

    // 2. cumulative log decay, one thread per row
    if (tid < K) {
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float lw = Es[tid * kLd + t];
        Es[tid * kLd + t] = run;
        run += lw;
        Cs[tid * kLd + t] = run;
      }
      Dk[tid] = __expf(run);
    }
    __syncthreads();

    // 3. the intra-chunk weights: A[t][s], s < t, by thread (t, s); the
    //    diagonal by the first 16 threads (warp 0 has one strict entry)
    {
      const int t = tid >> 4, s = tid & 15;
      if (s != t) {
        float acc = 0.f;
        if (s < t) {
#pragma unroll
          for (int c = 0; c < K; ++c)
            acc += Rs[c * kLd + t] * Ks[c * kLd + s] * __expf(Es[c * kLd + t] - Cs[c * kLd + s]);
        }
        As[t * kLd + s] = acc;
      }
      if (tid < kC) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) acc += Rs[c * kLd + tid] * Us[c] * Ks[c * kLd + tid];
        As[tid * kLd + tid] = acc;
      }
    }
#pragma unroll
    for (int idx = tid; idx < K * kC; idx += kThreads) {
      const int c = idx / kC, o = c * kLd + (idx - c * kC);
      RD[o] = Rs[o] * __expf(Es[o]);
      KD[o] = Ks[o] * __expf(Cs[c * kLd + kC - 1] - Cs[o]);
    }
    __syncthreads();

    // 4. the state's share of y, the state update, then y
    float vr[kC], p[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      vr[t] = Vs[t * kVB + vv];
      p[t] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int c = kq + 16 * j;
      const float sc = st[j];
      float acc = Dk[c] * sc;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        p[t] += RD[c * kLd + t] * sc;
        acc += KD[c * kLd + t] * vr[t];
      }
      st[j] = acc;
    }
    // reduce-scatter over the 16 row groups (lane bits 0-3): the lane of
    // row group kq ends with token kq's sum
    const unsigned full = 0xffffffffu;
    float q8[8], q4[4], q2[2];
    const bool h8 = kq & 8, h4 = kq & 4, h2 = kq & 2, h1 = kq & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      q8[i] = (h8 ? p[i + 8] : p[i]) + __shfl_xor_sync(full, h8 ? p[i] : p[i + 8], 8);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q4[i] = (h4 ? q8[i + 4] : q8[i]) + __shfl_xor_sync(full, h4 ? q8[i] : q8[i + 4], 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      q2[i] = (h2 ? q4[i + 2] : q4[i]) + __shfl_xor_sync(full, h2 ? q4[i] : q4[i + 2], 2);
    float yv = (h1 ? q2[1] : q2[0]) + __shfl_xor_sync(full, h1 ? q2[0] : q2[1], 1);
#pragma unroll
    for (int s = 0; s < kC; ++s) yv += As[kq * kLd + s] * vr[s];
    if (t0 + kq < S) store(&y[base + (long long)(t0 + kq) * tok + v0 + vv], yv);
    __syncthreads();  // the next chunk overwrites the tiles
  }

#pragma unroll
  for (int j = 0; j < nj; ++j) sf[((long long)bh * K + kq + 16 * j) * K + v0 + vv] = st[j];
}

template <typename T, int K>
int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* sf, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(6 * K * kLd + kC * kVB + kC * kLd + 2 * K);
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_fwd<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, K / kVB);
  wkv_fwd<T, K><<<grid, kThreads, smem, stream>>>((const T*)r, (const T*)k, (const T*)v,
                                                  (const T*)w, (const float*)u, (const float*)s0,
                                                  (T*)y, (float*)sf, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* sf, int B, int S, int H, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch_k<T, 16>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 32: return launch_k<T, 32>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 48: return launch_k<T, 48>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 64: return launch_k<T, 64>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 80: return launch_k<T, 80>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 96: return launch_k<T, 96>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 112: return launch_k<T, 112>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
    case 128: return launch_k<T, 128>(r, k, v, w, u, s0, y, sf, B, S, H, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w and y).  s0 may be null.
// Pointers 16-byte aligned, tensors contiguous.
int wkv_scan_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                 const void* s0, void* y, void* sf, int B, int S, int H, int K, int dtype,
                 void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 16 || K > kMaxK || K % 16 || (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(r, k, v, w, u, s0, y, sf, B, S, H, K, st);
  if (dtype == 1) return launch<bf16>(r, k, v, w, u, s0, y, sf, B, S, H, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
