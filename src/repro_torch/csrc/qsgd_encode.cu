// QSGD stochastic quantization to int8 codes for Hopper (sm_90a).  Replaces
// the Pallas TPU kernel qsgd_encode_fwd of src/repro/kernels/qsgd/kernel.py:41
// (its body, _kernel, lines 29-38), with one norm per bucket where the TPU
// kernel takes one global norm, so that one kernel serves both the
// global-norm surface (one bucket) and the swarm round's bucketed wire:
//
//   scaled = (|x_i| / max(norm_b, 1e-30)) * levels,     b = i / bucket
//   lower  = floor(scaled);   p = scaled - lower
//   code_i = +-(lower + (u_i < p)), negative where signbit(x_i), as int8
//
// x (L,) float32, any L, read unpadded: an index i >= L counts as 0.0 and
// gets code 0.  u (P,) float32 uniforms and the codes (P,) int8, with
// P = nb * bucket >= L; norms (nb,) float32.  levels <= 127, so a code fits
// a signed byte (the wrappers raise above).
//
// The codes must be exact: given the same norms and uniforms they equal the
// plain version's, and the reference's, bit for bit, because an auditor
// re-encodes a node's gradient with its uniforms and compares.  So each
// step is the correctly rounded IEEE operation, in the reference's order:
// __fdiv_rn, then __fmul_rn by levels (not |x| * (levels / norm)), floorf,
// __fsub_rn, a strict <, __fadd_rn.  build.py also compiles this file with
// -fmad=false, so no multiply is contracted with an add.
//
// Bound on an H100: device memory.  At the swarm round's wire (one node's
// D = 162,417,408 values, buckets of 512: 317,222 of them, the last ragged)
// it reads x (649.7 MB), u (649.7 MB) and the norms (1.3 MB) and writes the
// codes (162.4 MB): 1.463 GB -> 0.437 ms at 3.35 TB/s; a few operations an
// element.
//
// Design: the TPU kernel quantizes one (block_rows, 128) VMEM tile a grid
// step.  Here one thread takes 4 consecutive elements: where x and u are
// 16-byte aligned and the codes 4-byte aligned it reads them as one float4
// each and writes one 4-byte word of codes (element by element at the
// ragged ends), else element by element.  Neighbouring threads touch
// neighbouring words.  The bucket index is one 64-bit division a thread,
// advanced at a bucket's edge.  Elements are independent: no reduction, no
// atomics, deterministic.
//
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ int8_t encode_one(float x, float u, float norm, float levels) {
  const float den = isnan(norm) ? norm : fmaxf(norm, 1e-30f);  // NaN propagates, as in torch.clamp
  const float scaled = __fmul_rn(__fdiv_rn(fabsf(x), den), levels);
  const float lower = floorf(scaled);
  const float p = __fsub_rn(scaled, lower);
  float q = __fadd_rn(lower, u < p ? 1.f : 0.f);
  if (signbit(x)) q = -q;
  return (int8_t)__float2int_rz(q);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, const float* __restrict__ u,
              const float* __restrict__ norms, int8_t* __restrict__ out, long long L,
              long long P, long long bucket, float levels) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (i0 >= P) return;
  float xv[kVec], uv[kVec];
  if (kAligned && i0 + kVec <= L) {
    const float4 a = *reinterpret_cast<const float4*>(x + i0);
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) xv[e] = i0 + e < L ? x[i0 + e] : 0.f;
  }
  const bool whole = i0 + kVec <= P;
  if (kAligned && whole) {
    const float4 b = *reinterpret_cast<const float4*>(u + i0);
    uv[0] = b.x, uv[1] = b.y, uv[2] = b.z, uv[3] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) uv[e] = i0 + e < P ? u[i0 + e] : 0.f;
  }
  long long b = i0 / bucket, edge = (b + 1) * bucket;
  int8_t c[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long i = i0 + e;
    while (i >= edge) {
      ++b;
      edge += bucket;
    }
    c[e] = i < P ? encode_one(xv[e], uv[e], norms[b], levels) : 0;
  }
  if (kAligned && whole) {
    *reinterpret_cast<char4*>(out + i0) = make_char4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (i0 + e < P) out[i0 + e] = c[e];
  }
}

}  // namespace

extern "C" {

// x (L,), u (P,), norms (P / bucket,) float32 -> out (P,) int8.
int qsgd_encode_i8(const void* x, const void* u, const void* norms, void* out, long long L,
                   long long P, long long bucket, float levels, void* stream) {
  if (L < 0 || L > P || bucket < 1 || P % bucket) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const long long per_block = (long long)kThreads * kVec;
  const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)u % 16 == 0 && (uintptr_t)out % 4 == 0;
  if (aligned)
    encode_kernel<true><<<blocks, kThreads, 0, s>>>((const float*)x, (const float*)u,
                                                    (const float*)norms, (int8_t*)out, L, P,
                                                    bucket, levels);
  else
    encode_kernel<false><<<blocks, kThreads, 0, s>>>((const float*)x, (const float*)u,
                                                     (const float*)norms, (int8_t*)out, L, P,
                                                     bucket, levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
