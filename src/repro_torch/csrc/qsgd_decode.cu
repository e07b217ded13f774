// Fused QSGD dequantize-and-accumulate for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel qsgd_decode_accumulate_fwd of
// src/repro/kernels/qsgd_decode/kernel.py:41.
//
//   out[c] = sum_i w_i * ((codes[i, c] / levels) * norms[i, c / bucket])
//
// codes (N, L) int8 signed magnitudes, norms (N, L / bucket) float32 bucket
// norms, w (N,) float32 node weights -> out (L,) float32.  The decoded
// (N, L) float32 stack never exists in device memory.
//
// Bound on an H100: device memory.  At the round's shapes (N = 10,
// L = 162,417,664) it moves N * L code bytes + N * L / 512 * 4 norm bytes
// + L * 4 output bytes = 2.29 GB -> 0.68 ms at 3.35 TB/s; it does ~4
// operations per code byte, far below the compute roof.
//
// Design: one thread per 16 consecutive codes.  It reads them as one
// 16-byte load per node (neighbouring threads read neighbouring 16-byte
// words of each row), the one bucket norm those 16 codes share (bucket is a
// multiple of 16), and sums the nodes in node order with round-to-nearest
// divide, multiply and add (no contraction), which is the plain version's
// arithmetic exactly; it writes 16 floats as four 16-byte stores.  Columns
// are independent, so there is no cross-block reduction.
//
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;

__global__ void __launch_bounds__(kThreads)
decode_accumulate_kernel(const int8_t* __restrict__ codes, const float* __restrict__ norms,
                         const float* __restrict__ w, float* __restrict__ out, int n,
                         long long L, int bucket, float levels) {
  const long long c0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (c0 >= L) return;
  const long long nb = L / bucket;
  const long long b = c0 / bucket;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int4 raw = *reinterpret_cast<const int4*>(codes + (long long)i * L + c0);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    const float nrm = norms[(long long)i * nb + b];
    const float wi = w[i];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float dec = __fmul_rn(__fdiv_rn((float)q[e], levels), nrm);
      acc[e] = __fadd_rn(acc[e], __fmul_rn(dec, wi));
    }
  }
  float4* o = reinterpret_cast<float4*>(out + c0);
#pragma unroll
  for (int e = 0; e < kVec / 4; ++e)
    o[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
}

}  // namespace

extern "C" {

// L and bucket must be multiples of 16, L of bucket; codes and out 16-byte aligned.
int qsgd_decode_accumulate_f32(const void* codes, const void* norms, const void* w, void* out,
                               int n, long long L, int bucket, float levels, void* stream) {
  if (n < 1 || bucket < kVec || bucket % kVec || L % bucket) return (int)cudaErrorInvalidValue;
  const long long threads = L / kVec;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  decode_accumulate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)norms, (const float*)w, (float*)out, n, L, bucket,
      levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
