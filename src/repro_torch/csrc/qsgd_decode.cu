// Fused QSGD dequantize-and-accumulate for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel qsgd_decode_accumulate_fwd of
// src/repro/kernels/qsgd_decode/kernel.py:41.
//
//   out[c] = sum_i w_i * (codes[i, c] * (norms[i, c / bucket] * r)),  r = float32(1 / levels)
//
// codes (N, L) int8 signed magnitudes, norms (N, L / bucket) float32 bucket
// norms, w (N,) float32 node weights -> out (L,) float32.  The decoded
// (N, L) float32 stack never exists in device memory.  The decode is the
// compiled reference's: under jit XLA rewrites q / levels * norm into
// q * (norm * r), and the caller passes the same float32 r as the plain
// version uses.
//
// Bound on an H100: device memory.  At the round's shapes (N = 10,
// L = 162,417,664) it moves N * L code bytes + N * L / 512 * 4 norm bytes
// + L * 4 output bytes = 2.29 GB -> 0.68 ms at 3.35 TB/s.
//
// Design: a thread takes 16 consecutive codes of every node (neighbouring
// threads read neighbouring 16-byte words of each row) and the one bucket
// norm of each node that those 16 codes share (bucket is a multiple of 16).
// - For N <= 16 the node count is a template parameter and every code load
//   is in flight before any arithmetic: the thread copies its N 16-byte
//   words into its own slots of a static shared tile with cp.async (N * 2 KB
//   a block of 128 threads), loads the N norms, waits once, and reads the
//   words back.  With register loads nvcc kept only 2 of the 10 rows ahead
//   of the first multiply and sank the rest among the arithmetic, 3.5%
//   slower (tools/qsgd_decode_probe.py on an H100 SXM).  Above 16 a second
//   instantiation loops over the nodes at run time with register loads.
// - No divide and no int-to-float conversion unit: a signed byte becomes a
//   float with one byte permute and one add (the bits of 2^23 + q + 128,
//   minus 2^23 + 128; exact for every int8).  One multiply a node forms
//   s_i = norm_i * r for its 16 codes; then each code is q * s_i, times w_i,
//   added into its accumulator in node order, every step rounded to
//   nearest with no contraction: the plain version's arithmetic exactly.
// - A thread finds its bucket by a multiply-high (Buckets), not a divide.
// - 16 floats out as four streaming 16-byte stores.  Columns are
//   independent, so there is no cross-block reduction.
//
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // a block's threads; its tile is N * 2 KB
constexpr int kVec = 16;           // codes a thread takes from each node
constexpr int kMaxUnrolled = 16;   // nodes up to which N is a template parameter

// The four signed bytes of a word as floats, exactly.  kI2F converts on the
// conversion unit (a quarter of the FMA pipe's rate); the kernel's own path
// puts each byte, biased to q + 128, into the low mantissa byte of 2^23.
template <bool kI2F>
__device__ __forceinline__ void bytes_to_floats(unsigned word, float* f) {
  if constexpr (kI2F) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = (float)(int8_t)(word >> (8 * k));
  } else {
    const unsigned biased = word ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | k)),
                       8388736.0f);
  }
}

// acc[e] += w_i * (q_e * (norm_i * r)) for one node's 16 codes
template <bool kI2F>
__device__ __forceinline__ void add_node(float* acc, const int4& raw, float nrm, float r,
                                         float wi) {
  const float s = __fmul_rn(nrm, r);
  const unsigned words[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                             (unsigned)raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float q[4];
    bytes_to_floats<kI2F>(words[j], q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[4 * j + k] = __fadd_rn(acc[4 * j + k], __fmul_rn(__fmul_rn(q[k], s), wi));
  }
}

// A row's buckets: their count nb, and the bucket of a group of 16 codes
// found without a divide (Granlund and Montgomery's multiply-high, as
// CUTLASS's FastDivmod): of(g) = g / d for every g < 2^31, d the groups a
// bucket holds.
struct Buckets {
  long long nb;
  unsigned d, mul, shr;
  __device__ __forceinline__ unsigned of(unsigned g) const {
    return d == 1 ? g : __umulhi(g, mul) >> shr;
  }
};

// mul = ceil(2^p / d), p = 31 + ceil(log2 d)
Buckets buckets(long long L, int bucket) {
  const unsigned d = (unsigned)(bucket / kVec);
  if (d == 1) return {L / bucket, 1u, 0u, 0u};
  const unsigned p = 31u + (32u - (unsigned)__builtin_clz(d - 1));
  return {L / bucket, d, (unsigned)(((1ull << p) + d - 1) / d), p - 32u};
}

__device__ __forceinline__ void store16(float* out, long long g, const float* acc) {
  float4* o = reinterpret_cast<float4*>(out) + 4 * g;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    __stcs(o + e, make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]));
}

// N > 0: exactly N nodes, unrolled, each node's 16 codes copied by cp.async
// into the thread's slot of a static tile (all N copies issued, the norms
// loaded, one wait, the words into registers, then the arithmetic); N == 0:
// n nodes in a run-time loop of register loads.  A grid-stride loop over
// the L / 16 groups of 16 codes.
template <int N, bool kI2F>
__global__ void __launch_bounds__(kThreads)
decode_accumulate_kernel(const int8_t* __restrict__ codes, const float* __restrict__ norms,
                         const float* __restrict__ w, float* __restrict__ out, int n,
                         long long L, Buckets bk, float r) {
  __shared__ int4 tile[N > 0 ? N : 1][kThreads];   // node i's 16 codes of each thread
  const long long groups = L / kVec;
  const long long nb = bk.nb;
  const int4* rows = reinterpret_cast<const int4*>(codes);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const long long b = bk.of((unsigned)g);
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    if constexpr (N > 0) {
      int4 raw[N];
      float nrm[N], wi[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const unsigned slot = (unsigned)__cvta_generic_to_shared(&tile[i][threadIdx.x]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(slot),
                     "l"(rows + i * groups + g));
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        nrm[i] = __ldg(norms + i * nb + b);
        wi[i] = __ldg(w + i);
      }
      // the thread's own copies are complete and visible to it: no block barrier
      asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
      for (int i = 0; i < N; ++i) raw[i] = tile[i][threadIdx.x];
#pragma unroll
      for (int i = 0; i < N; ++i) add_node<kI2F>(acc, raw[i], nrm[i], r, wi[i]);
    } else {
      for (int i = 0; i < n; ++i)
        add_node<kI2F>(acc, __ldcs(rows + i * groups + g), __ldg(norms + i * nb + b), r,
                       __ldg(w + i));
    }
    store16(out, g, acc);
  }
}

// one instantiation a node count up to kMaxUnrolled, the run-time loop above
template <bool kI2F, int N = kMaxUnrolled>
void launch(const int8_t* codes, const float* norms, const float* w, float* out, int n,
            long long L, Buckets bk, float r, unsigned nblk,
            cudaStream_t stream) {
  if constexpr (N == 0) {
    decode_accumulate_kernel<0, kI2F><<<nblk, kThreads, 0, stream>>>(
        codes, norms, w, out, n, L, bk, r);
  } else if (n == N) {
    decode_accumulate_kernel<N, kI2F><<<nblk, kThreads, 0, stream>>>(
        codes, norms, w, out, n, L, bk, r);
  } else {
    launch<kI2F, N - 1>(codes, norms, w, out, n, L, bk, r, nblk, stream);
  }
}

// the argument checks of the entry point; 0 where the kernel takes them
int check_args(int n, long long L, int bucket) {
  if (n < 1 || bucket < kVec || bucket % kVec || L % bucket) return (int)cudaErrorInvalidValue;
  if (L / kVec >= (1LL << 31)) return (int)cudaErrorInvalidValue;   // Buckets::of's range
  return 0;
}

}  // namespace

extern "C" {

// L and bucket must be multiples of 16, L of bucket; codes and out 16-byte
// aligned; r is the float32 1 / levels.  One thread a group of 16 codes.
int qsgd_decode_accumulate_f32(const void* codes, const void* norms, const void* w, void* out,
                               int n, long long L, int bucket, float r, void* stream) {
  if (const int err = check_args(n, L, bucket)) return err;
  const long long groups = L / kVec;
  const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
  launch<false>((const int8_t*)codes, (const float*)norms, (const float*)w, (float*)out, n, L,
                buckets(L, bucket), r, blocks, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
