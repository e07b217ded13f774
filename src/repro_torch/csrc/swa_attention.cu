// Causal sliding-window GQA attention, forward, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel swa_attention_fwd of
// src/repro/kernels/swa_attention/kernel.py:65.
//
// q (B, S, H, hd), k and v (B, S, Hkv, hd), o (B, S, H, hd): the model's
// layout, contiguous, bfloat16 or float32 (o in q's type).  Query i sees key
// j iff j <= i and i - j < window; query head h reads kv head h / (H / Hkv).
// Scores are q.k * hd^-0.5 in fp32, the softmax is an online softmax in fp32
// (running max, sum and accumulator; masked scores at -1e30 as in the TPU
// kernel), p.v is summed in fp32, and the output is acc / max(l, 1e-30)
// rounded to q's type.  Any S, any window >= 1, hd a multiple of 8 up to 128.
//
// Bound on an H100: operations.  On the prefill of h2o-danube-1.8b
// (B 1, S 32,768, H 32 / Hkv 8, hd 80, window 4,096) the band holds
// 125.8 M (query, key) pairs per head: 4 * hd flops each, 1.29 TFLOP a call,
// against 419 MB of q, k, v and o.
//
// Both kernels: one block of 128 threads (4 warps) per (64-query tile, head,
// batch); the kv tiles of 64 keys that meet the tile's band are streamed
// through shared memory in order (tiles wholly outside the band are never
// visited; the TPU grid visits and masks them); row max and row sum are
// butterfly shuffles over the lanes that share a query, which give every
// lane the same bits.  No atomics and a fixed order everywhere: two launches
// give the same bits.
//
// bfloat16 (the model's path): tensor cores through mma.sync m16n8k16.  Each
// warp owns 16 queries.  q.k^T is bf16 x bf16 with fp32 accumulation: the
// products are exact.  p stays fp32 in registers; for p.v it is split into
// two bf16 terms, p = hi + lo with hi = bf16(p) and lo = bf16(p - hi), and
// both are multiplied by v: the error on p is below 2^-16 of p, far under
// the output's bf16 rounding (2^-9).  The accumulator fragments of q.k^T are
// the A fragments of p.v, so p never leaves registers.
//
// float32: fp32 CUDA-core FMAs (tensor cores would round the inputs to
// TF32).  Each thread owns 4 queries x 8 keys of the score tile and
// 4 queries x hd/8 columns of the accumulator; the probabilities go through
// shared memory to the p.v product.
//
// The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per kv tile
constexpr int kThreads = 128;
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// ============================ bfloat16: tensor cores ===========================
constexpr int kLdVt = kBK + 8;  // row stride (elements) of the transposed value tile

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> hi = bf16 pair, lo = bf16 pair of the remainders
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

// rows row0 .. row0 + 63 of one head (hd elements at src + r * stride) into
// dst[r * ld + d], as is; rows at or beyond S are zero
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src, int row0, int S,
                                               long long stride, int hd, int ld) {
  const int per_row = hd / 8;
  for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
    const int r = idx / per_row, d0 = (idx - r * per_row) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + d0);
    *reinterpret_cast<uint4*>(dst + r * ld + d0) = raw;
  }
}

// the same rows, transposed: dst[d * kLdVt + r]
__device__ __forceinline__ void load_cols_bf16(bf16* dst, const bf16* src, int row0, int S,
                                               long long stride, int hd) {
  const int per_row = hd / 8;
  for (int idx = threadIdx.x; idx < kBK * per_row; idx += kThreads) {
    const int r = idx / per_row, d0 = (idx - r * per_row) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + d0);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(d0 + k) * kLdVt + r] = e[k];
  }
}

__global__ void __launch_bounds__(kThreads)
swa_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, int S, int H, int Hkv, int hd, int window, float scale) {
  extern __shared__ uint4 smem_bf16[];
  const int hdp = (hd + 15) & ~15;  // the q.k depth, padded to whole k16 steps with zeros
  const int ld = hdp + 8;           // row stride of the query and key tiles
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);  // [kBQ][ld]
  bf16* Ks = Qs + kBQ * ld;                        // [kBK][ld]
  bf16* Vt = Ks + kBK * ld;                        // [hd][kLdVt]  values, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * hd, kv_stride = (long long)Hkv * hd;
  const bf16* qb = q + ((long long)b * S * H + h) * hd;
  const bf16* kb = k + ((long long)b * S * Hkv + hk) * hd;
  const bf16* vb = v + ((long long)b * S * Hkv + hk) * hd;
  bf16* ob = o + ((long long)b * S * H + h) * hd;
  const int nt = hd >> 3, nk = hdp >> 4;
  const int r0 = warp * 16 + g;  // this lane's queries in the tile: r0 and r0 + 8

  for (int idx = threadIdx.x; idx < kBQ * (hdp - hd); idx += kThreads) {
    const int r = idx / (hdp - hd), c = hd + idx % (hdp - hd);
    Qs[r * ld + c] = __float2bfloat16(0.f);
    Ks[r * ld + c] = __float2bfloat16(0.f);
  }
  load_rows_bf16(Qs, qb, i0, S, q_stride, hd, ld);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kMaxHd / 8][4];
#pragma unroll
  for (int nd = 0; nd < kMaxHd / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int first = max(0, i0 - window + 1) / kBK;
  const int last = (min(S, i0 + kBQ) - 1) / kBK;
  for (int tile = first; tile <= last; ++tile) {
    const int j0 = tile * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_rows_bf16(Ks, kb, j0, S, kv_stride, hd, ld);
    load_cols_bf16(Vt, vb, j0, S, kv_stride, hd);
    __syncthreads();

    // s = q k^T: 16 queries x 64 keys per warp, eight n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      const bf16* qa = Qs + r0 * ld + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 8), ld32(qa + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = Ks + (8 * j + g) * ld + kk * 16 + 2 * t;
        mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // scale, mask, online softmax; s[j][2 * half + e] is query r0 + 8 * half,
    // key 8 * j + 2 * t + e
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = i0 + r0 + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = j0 + 8 * j + 2 * t + e;
          float& x = s[j][2 * half + e];
          x = (kj <= qi && qi - kj < window) ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float corr = expf(m[half] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * half + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[half] = l[half] * corr + sum;
      m[half] = m_new;
#pragma unroll
      for (int nd = 0; nd < kMaxHd / 8; ++nd) {
        acc[nd][2 * half] *= corr;
        acc[nd][2 * half + 1] *= corr;
      }
    }

    // acc += p v, 16 keys at a time; p = hi + lo in bf16
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], hi[0], lo[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], hi[1], lo[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nd = 0; nd < kMaxHd / 8; ++nd) {
        if (nd < nt) {
          const bf16* vp = Vt + (8 * nd + g) * kLdVt + ks * 16 + 2 * t;
          const uint32_t b0 = ld32(vp), b1 = ld32(vp + 8);
          mma_bf16(acc[nd], hi, b0, b1);
          mma_bf16(acc[nd], lo, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = i0 + r0 + 8 * half;
    if (qi >= S) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    bf16* orow = ob + (long long)qi * q_stride + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kMaxHd / 8; ++nd)
      if (nd < nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd) = __floats2bfloat162_rn(
            acc[nd][2 * half] / denom, acc[nd][2 * half + 1] / denom);
  }
}

// ============================ float32: CUDA cores ==============================
constexpr int kLd = kBQ + 4;  // leading dim of the transposed fp32 tiles (float4-aligned)

// rows row0 .. row0 + 63 of one head into dst, transposed (dst[d * kLd + r])
// or not (dst[r * hd + d]); rows at or beyond S are zero
template <bool kTransposed>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int S,
                                              long long stride, int hd) {
  const int per_row = hd / 4;
  for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
    const int r = idx / per_row, d0 = (idx - r * per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * stride + d0);
    const float vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kTransposed)
        dst[(d0 + e) * kLd + r] = vals[e];
      else
        dst[r * hd + d0 + e] = vals[e];
    }
  }
}

// key column of score slot j of thread tx: two float4-wide groups of 4
__device__ __forceinline__ int key_col(int tx, int j) { return (j < 4 ? 0 : 28) + tx * 4 + j; }

__global__ void __launch_bounds__(kThreads)
swa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ o, int S, int H, int Hkv, int hd, int window, float scale) {
  extern __shared__ float4 smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);  // [hd][kLd]  queries, transposed
  float* Ks = Qs + hd * kLd;                       // [hd][kLd]  keys, transposed
  float* Vs = Ks + hd * kLd;                       // [kBK][hd]  values
  float* Ps = Vs + kBK * hd;                       // [kBK][kLd] probabilities, transposed

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * hd, kv_stride = (long long)Hkv * hd;
  const float* qb = q + ((long long)b * S * H + h) * hd;
  const float* kb = k + ((long long)b * S * Hkv + hk) * hd;
  const float* vb = v + ((long long)b * S * Hkv + hk) * hd;
  float* ob = o + ((long long)b * S * H + h) * hd;
  const int nj = hd >> 3;  // accumulator columns per thread: tx + 8 * jj

  load_tile_f32<true>(Qs, qb, i0, S, q_stride, hd);

  float m[4], l[4], acc[4][kMaxHd / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxHd / 8; ++jj) acc[i][jj] = 0.f;
  }

  const int first = max(0, i0 - window + 1) / kBK;
  const int last = (min(S, i0 + kBQ) - 1) / kBK;
  for (int tile = first; tile <= last; ++tile) {
    const int j0 = tile * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32<true>(Ks, kb, j0, S, kv_stride, hd);
    load_tile_f32<false>(Vs, vb, j0, S, kv_stride, hd);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + d * kLd + ty * 4);
      const float4 k0 = *reinterpret_cast<const float4*>(Ks + d * kLd + tx * 4);
      const float4 k1 = *reinterpret_cast<const float4*>(Ks + d * kLd + 32 + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = i0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = j0 + key_col(tx, j);
        s[i][j] = (kj <= qi && qi - kj < window) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kMaxHd / 8; ++jj) acc[i][jj] *= corr;
    }

    // p, transposed: only the 8 lanes that own a query read its column
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Ps + key_col(tx, j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + c * kLd + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vr = Vs + c * hd + tx;
#pragma unroll
      for (int jj = 0; jj < kMaxHd / 8; ++jj) {
        if (jj < nj) {
          const float vv = vr[8 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pa[i], vv, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = i0 + ty * 4 + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + (long long)qi * q_stride + tx;
#pragma unroll
    for (int jj = 0; jj < kMaxHd / 8; ++jj)
      if (jj < nj) orow[8 * jj] = acc[i][jj] / denom;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* q, const void* k, const void* v, void* o,
           int B, int S, int H, int Hkv, int hd, int window, float scale, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv,
                                           hd, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Pointers 16-byte aligned, tensors contiguous.
int swa_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      int Hkv, int hd, int window, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H < Hkv || H % Hkv || hd < 8 || hd > kMaxHd || hd % 8 ||
      window < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (size_t)(2 * hd * kLd + kBK * hd + kBK * kLd);
    return launch<float>(swa_fwd_f32, smem, q, k, v, o, B, S, H, Hkv, hd, window, scale, st);
  }
  if (dtype == 1) {
    const int ld = ((hd + 15) & ~15) + 8;
    const size_t smem = sizeof(bf16) * (size_t)((kBQ + kBK) * ld + hd * kLdVt);
    return launch<bf16>(swa_fwd_bf16, smem, q, k, v, o, B, S, H, Hkv, hd, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
