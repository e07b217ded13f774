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
// A window >= S is full causal attention: models.attention routes the
// no-window causal prefill (zamba2's shared block) here with window = S.
//
// Bound on an H100: operations.  h2o-danube-1.8b's prefill (B 1, S 32,768,
// H 32 / Hkv 8, hd 80, window 4,096) holds 125.8 M band pairs a head, 4 hd
// flops each: 1.29 TFLOP a call, 1.30 ms at 989 TFLOP/s, against 419 MB of
// q, k, v and o (0.13 ms at 3.35 TB/s).  zamba2-1.2b's (H 32 / 32, hd 64,
// window = S) holds the causal triangle, 537 M pairs a head: 4.40 TFLOP,
// 4.45 ms.  mixtral-8x7b's band (H 32 / 8, hd 128, window 4,096): 2.06
// TFLOP, 2.08 ms; qwen3-moe-30b-a3b's triangle (H 32 / 4, hd 128): 8.80
// TFLOP, 8.89 ms.  p.v takes p in two bf16 terms (below), so the kernel's
// own arithmetic is 1.5x the bound's.
//
// Three kernels, chosen by swa_attention_path (which swa_attention_fwd
// calls, and which the wrapper asks to report the route it takes):
//
// swa_fwd_bf16_wgmma, the served path: bfloat16, hd 64, 80 or 128, S >= 128.
// A block of 384 threads owns 128 queries of one (head, batch): warpgroups
// 0 and 1 (consumers, 240 registers each thread by setmaxnreg) each own 64
// queries, warpgroup 2 (producer, 24 registers) issues TMA loads from one
// thread.  Q comes in once; the kv tiles of 128 keys that meet the block's
// band stream through a ring of 3 stages in shared memory, K and V each
// behind a "full" mbarrier (TMA transaction bytes) and both released by one
// "empty" mbarrier that the 256 consumer threads arrive at.  Tiles wholly
// outside the band are never loaded.  Per tile and consumer warpgroup:
//   S = Q.K^T by wgmma m64n128k16, A (Q) and B (K) both K-major in shared
//     memory, fp32 accumulators in registers: the products are exact;
//   the band mask only on a tile that a band edge cuts (the diagonal tile,
//     the tile where the window starts); interior tiles skip the compares;
//   the online softmax in exp2 (ex2.approx): p = 2^(s c - m c), with
//     c = hd^-0.5 * log2(e), one FFMA a score; row max and sum over the 4
//     lanes that share a row (the sum only once, at the end: each lane
//     keeps its partial l).  A row that has met no key of its band yet
//     keeps p = 0 (the TPU kernel's p = exp(-1e30 + 1e30) = 1 there is
//     wiped by the next correction exp(-1e30 - m) = 0: the same result);
//   O += P.V by wgmma with P from registers: the S accumulator layout is
//     the A fragment layout, so p never leaves registers.  p is fp32; it is
//     split into hi = bf16(p), rounded, and lo = bf16(p - hi), truncated,
//     and both are multiplied by v (error on p below 2^-15 of p, far under
//     the output's bf16 2^-9): the TPU kernel's fp32 p.v, not a bf16 p.  V
//     is the B operand in its natural (keys, hd) layout, MN-major: the
//     descriptor transposes it, and no thread moves a value of V.
//   Each step issues P.V of the previous tile and Q.K^T of this one as one
//     group of wgmma, so the tensor cores see one longer run a tile.
// hd 80 is 160 bytes a row, more than TMA's 128-byte swizzle atom.  Each
// tile (Q, K and V alike) is loaded as two boxes: columns 0-63 with the
// 128-byte swizzle and columns 64-79 with the 32-byte swizzle, each a
// dense region of its own.  Q.K^T takes k-steps 0-3 from the first region
// and k-step 4 from the second; P.V is an n64 wgmma on the first and an
// n16 wgmma on the second.  Both swizzles keep the wgmma reads and the TMA
// writes free of bank conflicts, so the split costs one more TMA box a
// tile and one more (narrow) wgmma a k-step, not conflicts.  hd 64 is one
// 128-byte box.  hd 128 is 256 bytes a row, two swizzle atoms: two boxes
// of 64 columns, both 128-byte swizzled.  Q.K^T takes k-steps 0-3 from the
// first and 4-7 from the second; P.V is two n64 wgmma a k-step, one on
// each V box (for hi, then for lo), the MN-major n64 descriptor of region
// a used twice, where one n128 would have to stride across the boxes.
// Budgets at hd 128 (128-key tiles): a tile is 32,768 bytes, so Q and 3
// stages of K and V take 7 x 32,768 + 2,048 of slack and barriers =
// 231,424 of the 232,448 bytes a block may have; a consumer thread holds
// O (64 floats), the next tile's S (64) and the previous tile's p as hi/lo
// fragments (64) across each group, 192 registers of the 240, and ptxas
// reports no spill (chip_smoke phase 1 fails on one).  Issuing each tile's
// two products as two groups (128 live) and ping-pong of the two consumer
// warpgroups on named barriers were both tried at hd 128 and neither was
// faster: the kernel's own products already run at about the rate SDPA's
// run at on the card, so the hi/lo split's 1.5x is what is left.
// The bound the design leaves: per score the softmax takes an FFMA, an
// ex2, a max, an add and the split on the CUDA cores while the hi/lo
// split makes the tensor cores do 1.5x the bound's products; at hd 64 the
// two are of a size, and the two consumer warpgroups overlap them only as
// far as the warp schedulers interleave them.
// Blocks are ordered so that the H / Hkv query heads of one kv head run
// side by side (they share K and V through L2), and the q tiles that reach
// furthest (the longest when window >= S) start first.  The last block
// tile's rows beyond S are zero (TMA fills them) and never stored.
//
// swa_fwd_bf16_mma, the simple path: bfloat16 at every other hd (a
// multiple of 8 up to 128) and at S < 128.  One block of 128 threads per
// 64 queries, mma.sync m16n8k16, the same hi/lo split of p, synchronous
// loads of each kv tile.
//
// swa_fwd_f32: float32 on CUDA-core FMAs (tensor cores would round the
// inputs to TF32), for the float32 copies that decode is checked against.
// Each thread owns 4 queries x 8 keys of the score tile and 4 queries x
// hd/8 columns of the accumulator; the probabilities go through shared
// memory to the p.v product.
//
// All three: no atomics and a fixed order of every sum, so two launches
// give the same bits; nothing allocated; the entry point returns
// cudaGetLastError() (or the error of the tensor-map encoding).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // queries per block (simple paths)
constexpr int kBK = 64;         // keys per kv tile (simple paths)
constexpr int kThreads = 128;
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// ===================== bfloat16, the simple path: mma.sync =====================
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
swa_fwd_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
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

// ================= bfloat16, the served path: TMA ring + wgmma =================
constexpr int kWgM = 128;            // queries per block: two consumer warpgroups of 64
constexpr int kWgN = 128;            // keys per kv tile
constexpr int kStages = 3;           // kv tiles in flight
constexpr int kWgThreads = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2

// shared-memory bytes of one tile of 128 rows: region a (columns 0-63,
// 128-byte swizzle) and region b (columns 64 .. hd - 1: 16 columns at the
// 32-byte swizzle for hd 80, 64 columns at the 128-byte swizzle for hd 128)
template <int HD>
struct WgTile {
  static_assert(HD == 64 || HD == 80 || HD == 128, "the wgmma path takes hd 64, 80 or 128");
  static constexpr int kColsB = HD - 64;
  static constexpr int kRowB = kColsB * 2;                 // bytes of a row of region b
  static constexpr uint64_t kLayoutB = kRowB == 128 ? 1 : 3;  // descriptor swizzle code
  static constexpr int kSboB = 8 * kRowB;                  // bytes of 8 rows of region b
  static constexpr int kBytesA = kWgN * 128;
  static constexpr int kBytesB = kWgN * kRowB;
  static constexpr int kBytes = kBytesA + kBytesB;        // a multiple of 1,024
  // Q, K and V stages, then the barriers; 1,024 bytes of slack to align
  // (hd 128: 7 x 32,768 + 2,048 = 231,424 of the 232,448 a block may have)
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024 + 1024;
};

struct WgMaps {                       // TMA descriptors, passed as a grid constant
  CUtensorMap qa, qb, ka, kb, va, vb; // a: columns 0-63, b: columns 64 .. hd - 1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// one TMA box of a (hd, heads, S, B) tensor into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, layout (1: 128-byte swizzle, 3: 32-byte swizzle)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// (x0, x1) -> hi = bf16 pair rounded, lo = bf16 pair of the remainders,
// truncated (one byte permute): |x - hi - lo| < 2^-15 |x|
__device__ __forceinline__ void split_p(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = __byte_perm(__float_as_uint(x0 - f.x), __float_as_uint(x1 - f.y), 0x7632);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, fp32) (+)= A (64 x 16, shared) * B (16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, fp32) += A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n16k16_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
swa_fwd_bf16_wgmma(const __grid_constant__ WgMaps maps, bf16* __restrict__ o, int S, int H,
                   int Hkv, int B, int window, float scale_log2) {
  using T = WgTile<HD>;
  constexpr bool kHasB = T::kColsB > 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzled tiles: 1,024-aligned
  const uint32_t sK = sQ + T::kBytes;                    // + stage * kBytes
  const uint32_t sV = sK + kStages * T::kBytes;
  const uint32_t bars = sV + kStages * T::kBytes;        // 8 bytes each
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  // block -> (q tile, head, batch): heads fastest, the furthest q tiles first
  const int nqt = (S + kWgM - 1) / kWgM;
  const int h = blockIdx.x % H;
  const int rest = blockIdx.x / H;
  const int b = rest % B;
  const int i0 = (nqt - 1 - rest / B) * kWgM;
  const int hk = h / (H / Hkv);
  const int first = max(0, i0 - window + 1) / kWgN;
  const int last = (min(S, i0 + kWgM) - 1) / kWgN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, T::kBytes);
      tma_load(sQ, &maps.qa, q_full, 0, h, i0, b);
      if constexpr (kHasB) tma_load(sQ + T::kBytesA, &maps.qb, q_full, 64, h, i0, b);
      for (int tile = first, n = 0; tile <= last; ++tile, ++n) {
        const int st = n % kStages;
        mbar_wait(empty(st), ((n / kStages) & 1) ^ 1);
        const int j0 = tile * kWgN;
        const uint32_t dk = sK + st * T::kBytes, dv = sV + st * T::kBytes;
        mbar_expect_tx(k_full(st), T::kBytes);
        tma_load(dk, &maps.ka, k_full(st), 0, hk, j0, b);
        if constexpr (kHasB) tma_load(dk + T::kBytesA, &maps.kb, k_full(st), 64, hk, j0, b);
        mbar_expect_tx(v_full(st), T::kBytes);
        tma_load(dv, &maps.va, v_full(st), 0, hk, j0, b);
        if constexpr (kHasB) tma_load(dv + T::kBytesA, &maps.vb, v_full(st), 64, hk, j0, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);   // this thread's rows: r0 and r0 + 8
    const int c0 = 2 * (lane & 3);            // and columns c0, c0 + 1 of each 8
    const int qlo = i0 + 64 * wg;
    // this warpgroup's 64 rows of Q in each region
    const uint32_t qa = sQ + wg * 64 * 128, qb = sQ + T::kBytesA + wg * 64 * T::kRowB;

    float acc[HD / 2];                        // O: 64 x HD, n64 part then region b's
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float s[64];                              // S of this tile (raw scores, then p)
    uint32_t hi[8][4], lo[8][4];              // p of the previous tile, as A fragments
    const int ntiles = last - first + 1;

    // O += P V: V (128 keys x HD) MN-major, 16 keys a k-step
    auto pv_gemm = [&](int st) {
      const uint32_t va = sV + st * T::kBytes;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint64_t da = wg_desc(va + ks * 16 * 128, 1024, 1024, 1);
        wgmma_m64n64k16_rs(acc, hi[ks], da);
        wgmma_m64n64k16_rs(acc, lo[ks], da);
        if constexpr (kHasB) {
          const uint64_t db = wg_desc(va + T::kBytesA + ks * 16 * T::kRowB, T::kSboB, T::kSboB,
                                      T::kLayoutB);
          if constexpr (T::kColsB == 64) {
            wgmma_m64n64k16_rs(acc + 32, hi[ks], db);
            wgmma_m64n64k16_rs(acc + 32, lo[ks], db);
          } else {
            wgmma_m64n16k16_rs(acc + 32, hi[ks], db);
            wgmma_m64n16k16_rs(acc + 32, lo[ks], db);
          }
        }
      }
    };
    // S = Q K^T: 64 x 128, depth HD (k-steps of 16 columns)
    auto s_gemm = [&](int st) {
      const uint32_t ka = sK + st * T::kBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n128k16_ss(s, wg_desc(qa + 32 * ks, 16, 1024, 1),
                            wg_desc(ka + 32 * ks, 16, 1024, 1), ks > 0);
#pragma unroll
      for (int ks = 0; ks < T::kColsB / 16; ++ks)
        wgmma_m64n128k16_ss(s, wg_desc(qb + 32 * ks, 16, T::kSboB, T::kLayoutB),
                            wg_desc(ka + T::kBytesA + 32 * ks, 16, T::kSboB, T::kLayoutB), 1);
    };
    // the mask where a band edge cuts tile n, the online softmax, p into hi/lo
    auto softmax = [&](int n) {
      const int j0 = (first + n) * kWgN;
      if (j0 + kWgN - 1 > qlo || qlo + 63 - j0 >= window) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int qi = qlo + r0 + ((i & 2) ? 8 : 0);
          const int kj = j0 + (i >> 2) * 8 + c0 + (i & 1);
          if (!(kj <= qi && qi - kj < window)) s[i] = kNegInf;
        }
      }
      // rows r0 (half 0) and r0 + 8 (half 1): m in raw units, p = 2^(s c -
      // m c) with c = hd^-0.5 log2(e) in one FFMA.  A row with no key in
      // the band yet keeps p = 0 (m c taken as 0).
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (((i >> 1) & 1) == half) mx = fmaxf(mx, s[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[half], mx);
        const float mc = m_new == kNegInf ? 0.f : m_new * scale_log2;
        corr[half] = ex2(fmaf(m[half], scale_log2, -mc));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (((i >> 1) & 1) == half) {
            s[i] = ex2(fmaf(s[i], scale_log2, -mc));
            sum += s[i];
          }
        l[half] = l[half] * corr[half] + sum;   // this lane's columns only
        m[half] = m_new;
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_p(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1], hi[ks][r], lo[ks][r]);
    };

    // Each step issues P.V of the previous tile and Q.K^T of this one as one
    // group of wgmma, then runs this tile's softmax.  No wgmma sits in a
    // branch (a branch makes the compiler serialize them): the first and
    // the last step are peeled, and the barrier waits come before the fence.
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    s_gemm(0);
    wg_commit();
    wg_wait0();
    softmax(0);
    for (int n = 1; n < ntiles; ++n) {
      const int prev = (n - 1) % kStages;
      mbar_wait(v_full(prev), ((n - 1) / kStages) & 1);
      mbar_wait(k_full(n % kStages), (n / kStages) & 1);
      wg_fence();
      pv_gemm(prev);
      s_gemm(n % kStages);
      wg_commit();
      wg_wait0();
      mbar_arrive(empty(prev));
      softmax(n);
    }
    const int prev = (ntiles - 1) % kStages;
    mbar_wait(v_full(prev), ((ntiles - 1) / kStages) & 1);
    wg_fence();
    pv_gemm(prev);
    wg_commit();
    wg_wait0();
    mbar_arrive(empty(prev));

    // the row sums over the 4 lanes of a row, then o = acc / l
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qlo + r0 + 8 * half;
      if (qi >= S) continue;
      const float denom = fmaxf(l[half], 1e-30f);
      bf16* orow = o + (((long long)b * S + qi) * H + h) * HD + c0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] / denom, acc[4 * j + 2 * half + 1] / denom);
    }
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (hd, heads, S, B) bfloat16 tensor, boxes of ``cols`` columns x 128 rows
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int hd, int heads, int S,
              int B, int cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)kWgN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int Hkv, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  WgMaps maps;
  const CUtensorMapSwizzle a = CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle b = HD == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  bool ok = make_map(encode, &maps.qa, q, HD, H, S, B, 64, a) &&
            make_map(encode, &maps.ka, k, HD, Hkv, S, B, 64, a) &&
            make_map(encode, &maps.va, v, HD, Hkv, S, B, 64, a);
  if (HD > 64)
    ok = ok && make_map(encode, &maps.qb, q, HD, H, S, B, HD - 64, b) &&
         make_map(encode, &maps.kb, k, HD, Hkv, S, B, HD - 64, b) &&
         make_map(encode, &maps.vb, v, HD, Hkv, S, B, HD - 64, b);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int smem = WgTile<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      swa_fwd_bf16_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + kWgM - 1) / kWgM) * H * B;
  swa_fwd_bf16_wgmma<HD><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      maps, (bf16*)o, S, H, Hkv, B, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel swa_attention_fwd launches for a sequence of S, head dim hd and
// dtype (0 float32, 1 bfloat16): 0 swa_fwd_f32, 1 swa_fwd_bf16_mma (the
// simple path), 2 swa_fwd_bf16_wgmma (TMA ring + wgmma: bf16, hd 64, 80 or
// 128, S of at least one 128-key tile); -1 for a dtype it does not take.
int swa_attention_path(int S, int hd, int dtype) {
  if (dtype == 0) return 0;
  if (dtype != 1) return -1;
  return S >= kWgN && (hd == 64 || hd == 80 || hd == 128) ? 2 : 1;
}

// Pointers 16-byte aligned, tensors contiguous.
int swa_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      int Hkv, int hd, int window, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H < Hkv || H % Hkv || hd < 8 || hd > kMaxHd || hd % 8 ||
      window < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (swa_attention_path(S, hd, dtype)) {
    case 0: {
      const size_t smem = sizeof(float) * (size_t)(2 * hd * kLd + kBK * hd + kBK * kLd);
      return launch<float>(swa_fwd_f32, smem, q, k, v, o, B, S, H, Hkv, hd, window, scale, st);
    }
    case 1: {
      const int ld = ((hd + 15) & ~15) + 8;
      const size_t smem = sizeof(bf16) * (size_t)((kBQ + kBK) * ld + hd * kLdVt);
      return launch<bf16>(swa_fwd_bf16_mma, smem, q, k, v, o, B, S, H, Hkv, hd, window, scale,
                          st);
    }
    case 2:
      if (hd == 64) return launch_wgmma<64>(q, k, v, o, B, S, H, Hkv, window, scale, st);
      if (hd == 80) return launch_wgmma<80>(q, k, v, o, B, S, H, Hkv, window, scale, st);
      return launch_wgmma<128>(q, k, v, o, B, S, H, Hkv, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
