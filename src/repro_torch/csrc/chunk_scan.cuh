// Shared parts of the chunk-parallel scans (rwkv6_wkv.cu, mamba2_ssd.cu):
// mma.sync m16n8k16 bf16 products that keep float32 accuracy by splitting a
// float32 operand into a bf16 hi and lo term, their fragment loaders, a tile
// loader that stages inputs through registers, and the state pass that
// carries the states across the chunks.
//
// Fragments of mma.sync.m16n8k16 (lane = 4 gr + qd): A (16 x 16, row) holds
// (gr, 2qd..2qd+1), (gr+8, 2qd..), (gr, 2qd+8..), (gr+8, 2qd+8..); B (16 x 8,
// col) holds (k 2qd..2qd+1, n gr), (k 2qd+8..2qd+9, n gr); C (16 x 8) holds
// (gr, 2qd..2qd+1), (gr+8, 2qd..2qd+1).  Two neighbouring C tiles are one A
// fragment, so a product's result feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chunk_scan {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4], float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// A tile of kRows rows (tokens) by `width` columns of a row-major source in
// T, moved to float32 shared memory through registers: every 16-byte load of
// the thread is issued before any is used, so their latencies overlap (and
// a tile may be loaded while the block computes on the previous one).  Rows
// at or past `rows` are zero.  width is a multiple of 16 / sizeof(T) up to
// kMaxW; the source rows are 16-byte aligned.  TokenFast: neighbouring
// threads take neighbouring rows (for a store of channel pairs without bank
// conflicts), else neighbouring 16-byte pieces of a row (coalesced).
template <typename T, int kRows, int kMaxW, int kThreads, bool TokenFast>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int kIter = (kRows * kMaxW / V + kThreads - 1) / kThreads;
  uint4 buf[kIter];

  __device__ __forceinline__ void where(int e, int pieces, int& t, int& j) const {
    if (TokenFast) {
      t = e % kRows;
      j = (e / kRows) * V;
    } else {
      t = e / pieces;
      j = (e - t * pieces) * V;
    }
  }
  __device__ __forceinline__ void load(const T* __restrict__ src, long long stride, int rows,
                                       int width) {
    const int pieces = width / V;
#pragma unroll
    for (int m = 0; m < kIter; ++m) {
      const int e = threadIdx.x + m * kThreads;
      int t, j;
      where(e, pieces, t, j);
      buf[m] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kRows * pieces && t < rows)
        buf[m] = *reinterpret_cast<const uint4*>(src + (long long)t * stride + j);
    }
  }
  // dst[t * ld + j], ld a multiple of 4
  __device__ __forceinline__ void store_rows(float* dst, int ld, int width) const {
    const int pieces = width / V;
#pragma unroll
    for (int m = 0; m < kIter; ++m) {
      const int e = threadIdx.x + m * kThreads;
      if (e < kRows * pieces) {
        int t, j;
        where(e, pieces, t, j);
        float f[V];
        unpack(buf[m], f, T());
#pragma unroll
        for (int q = 0; q < V; q += 4)
          *reinterpret_cast<float4*>(dst + t * ld + j + q) = make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
      }
    }
  }
  // dst[t * ld + j] in T, as loaded (ld a multiple of 16 / sizeof(T))
  __device__ __forceinline__ void store_raw(T* dst, int ld, int width) const {
    const int pieces = width / V;
#pragma unroll
    for (int m = 0; m < kIter; ++m) {
      const int e = threadIdx.x + m * kThreads;
      if (e < kRows * pieces) {
        int t, j;
        where(e, pieces, t, j);
        *reinterpret_cast<uint4*>(dst + t * ld + j) = buf[m];
      }
    }
  }
  // channel pairs interleaved: (j, t) at dst[(j / 2) * pl + 2 t + j % 2]
  __device__ __forceinline__ void store_pairs(float* dst, int pl, int width) const {
    const int pieces = width / V;
#pragma unroll
    for (int m = 0; m < kIter; ++m) {
      const int e = threadIdx.x + m * kThreads;
      if (e < kRows * pieces) {
        int t, j;
        where(e, pieces, t, j);
        float f[V];
        unpack(buf[m], f, T());
#pragma unroll
        for (int q = 0; q < V; q += 2)
          *reinterpret_cast<float2*>(dst + ((j + q) >> 1) * pl + 2 * t) = make_float2(f[q], f[q + 1]);
      }
    }
  }
};

// 16 bytes from global to shared memory without passing through registers;
// complete (for this thread) after cp_async_wait_all
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment of NR registers: hi = bf16(x) rounded, lo = bf16(x - hi)
// rounded, so |x - hi - lo| <= 2^-17 |x|.  Lo = false: x is a bf16 value
// (an input of the model's type, or a product of nothing), hi is x exactly.
template <int NR>
struct Frag {
  uint32_t hi[NR], lo[NR];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

template <bool Lo>
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  if (Lo) {
    const float2 f = __bfloat1622float2(h);
    lo = as_u32(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
  }
}

// the A fragment of the 16 x 16 tile whose element (row, col) is f(row, col)
template <bool Lo, typename F>
__device__ __forceinline__ void frag_a(FragA& a, int lane, F f) {
  const int gr = lane >> 2, c = 2 * (lane & 3);
  split<Lo>(f(gr, c), f(gr, c + 1), a.hi[0], a.lo[0]);
  split<Lo>(f(gr + 8, c), f(gr + 8, c + 1), a.hi[1], a.lo[1]);
  split<Lo>(f(gr, c + 8), f(gr, c + 9), a.hi[2], a.lo[2]);
  split<Lo>(f(gr + 8, c + 8), f(gr + 8, c + 9), a.hi[3], a.lo[3]);
}

// the B fragment of the 16 x 8 tile whose element (k, n) is f(k, n)
template <bool Lo, typename F>
__device__ __forceinline__ void frag_b(FragB& b, int lane, F f) {
  const int gr = lane >> 2, k = 2 * (lane & 3);
  split<Lo>(f(k, gr), f(k + 1, gr), b.hi[0], b.lo[0]);
  split<Lo>(f(k + 8, gr), f(k + 9, gr), b.hi[1], b.lo[1]);
}

// the A fragment of the 16 x 16 tile at p, stored row-major with row stride
// ld (even, so each pair is one 8-byte load)
template <bool Lo>
__device__ __forceinline__ void frag_a_rows(FragA& a, const float* p, int ld, int lane) {
  const int gr = lane >> 2, c = 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p + gr * ld + c);
  const float2 x1 = *reinterpret_cast<const float2*>(p + (gr + 8) * ld + c);
  const float2 x2 = *reinterpret_cast<const float2*>(p + gr * ld + c + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + (gr + 8) * ld + c + 8);
  split<Lo>(x0.x, x0.y, a.hi[0], a.lo[0]);
  split<Lo>(x1.x, x1.y, a.hi[1], a.lo[1]);
  split<Lo>(x2.x, x2.y, a.hi[2], a.lo[2]);
  split<Lo>(x3.x, x3.y, a.hi[3], a.lo[3]);
}

// the B fragment of the 16 x 8 tile at p, stored n-major ((k, n) at
// p[n * ld + k]) with an even ld
template <bool Lo>
__device__ __forceinline__ void frag_b_rows(FragB& b, const float* p, int ld, int lane) {
  const int gr = lane >> 2, k = 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p + gr * ld + k);
  const float2 x1 = *reinterpret_cast<const float2*>(p + gr * ld + k + 8);
  split<Lo>(x0.x, x0.y, b.hi[0], b.lo[0]);
  split<Lo>(x1.x, x1.y, b.hi[1], b.lo[1]);
}

// the A fragment from two C tiles (columns 0-7 and 8-15 of a 16 x 16 result)
template <bool Lo>
__device__ __forceinline__ void frag_a_from_c(FragA& a, const float* c0, const float* c1) {
  split<Lo>(c0[0], c0[1], a.hi[0], a.lo[0]);
  split<Lo>(c0[2], c0[3], a.hi[1], a.lo[1]);
  split<Lo>(c1[0], c1[1], a.hi[2], a.lo[2]);
  split<Lo>(c1[2], c1[3], a.hi[3], a.lo[3]);
}

// c += a b to float32 accuracy: hi.hi, then hi.lo where b has a lo term and
// lo.hi where a has one; lo.lo (below 2^-17 of the product) is left out.
// Always in this order, so two launches give the same bits.
template <bool LoA, bool LoB>
__device__ __forceinline__ void mma_split(float* c, const FragA& a, const FragB& b) {
  mma(c, a.hi, b.hi);
  if (LoB) mma(c, a.hi, b.lo);
  if (LoA) mma(c, a.lo, b.hi);
}

// The state pass.  X holds, for each (batch * head) and chunk, the change of
// the R x Cc float32 state over the chunk; it is overwritten with the state
// the chunk starts from:  X[c] <- S;  S <- E_c * S + X[c], from S = s0 (or
// zeros) to sf = the state after the last chunk.  E is the chunk's decay,
// one factor per column ((BH, nc, Cc)) when PerCol, else one per chunk
// ((BH, nc)).  s0 and sf are (BH, R, Cc) as X, or (BH, Cc, R) when TransIO.
// One thread carries four neighbouring elements through the chunks, loading
// kUnroll chunks ahead: memory-bound, one read and one write of X.
constexpr int kStateThreads = 128;
constexpr int kUnroll = 8;

template <bool PerCol, bool TransIO>
__global__ void __launch_bounds__(kStateThreads)
state_pass(float* __restrict__ X, const float* __restrict__ E, const float* __restrict__ s0,
           float* __restrict__ sf, int nc, int R, int Cc) {
  const long long n = (long long)R * Cc;
  const int e = 4 * (blockIdx.x * kStateThreads + threadIdx.x);
  if (e >= n) return;
  const long long bh = blockIdx.y;
  const int r = e / Cc, col = e - r * Cc;
  auto io = [&](int j) {  // offset of element (r, col + j) in s0 / sf
    return bh * n + (TransIO ? (long long)(col + j) * R + r : (long long)r * Cc + col + j);
  };
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = s0 != nullptr ? s0[io(j)] : 0.f;
  float* x = X + bh * nc * n + e;
  const float* ep = PerCol ? E + bh * nc * Cc + col : E + bh * nc;
  for (int c0 = 0; c0 < nc; c0 += kUnroll) {
    float4 d[kUnroll];
    float4 f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < nc) {
        d[u] = *reinterpret_cast<const float4*>(x + (c0 + u) * n);
        if (PerCol) {
          f[u] = *reinterpret_cast<const float4*>(ep + (long long)(c0 + u) * Cc);
        } else {
          const float g = ep[c0 + u];
          f[u] = make_float4(g, g, g, g);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < nc) {
        *reinterpret_cast<float4*>(x + (c0 + u) * n) = make_float4(s[0], s[1], s[2], s[3]);
        // the decay's product, then the change: two roundings, as the plain version
        s[0] = __fadd_rn(__fmul_rn(f[u].x, s[0]), d[u].x);
        s[1] = __fadd_rn(__fmul_rn(f[u].y, s[1]), d[u].y);
        s[2] = __fadd_rn(__fmul_rn(f[u].z, s[2]), d[u].z);
        s[3] = __fadd_rn(__fmul_rn(f[u].w, s[3]), d[u].w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) sf[io(j)] = s[j];
}

template <bool PerCol, bool TransIO>
inline cudaError_t launch_state_pass(float* X, const float* E, const float* s0, float* sf,
                                     int BH, int nc, int R, int Cc, cudaStream_t stream) {
  const long long quads = (long long)R * Cc / 4;
  const dim3 grid((unsigned)((quads + kStateThreads - 1) / kStateThreads), (unsigned)BH);
  state_pass<PerCol, TransIO><<<grid, kStateThreads, 0, stream>>>(X, E, s0, sf, nc, R, Cc);
  return cudaGetLastError();
}

}  // namespace chunk_scan
