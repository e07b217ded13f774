// Variants of the QSGD decode-accumulate kernel of
// src/repro_torch/csrc/qsgd_decode.cu that split its time between memory
// and arithmetic, for tools/qsgd_decode_probe.py.  The production source is
// included, so the variants run its device code and the library also holds
// its entry point.  Build (the probe does it):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libqsgd_decode_probe.so tools/qsgd_decode_probe.cu
//
// probe_decode_f32's variants, each on a grid of nblk blocks of the kernel's
// 128 threads:
//   0 the kernel (N a template parameter, the rows by cp.async into a static
//     tile, the integer byte-to-float path);
//   1 the same with the conversion unit (I2F) for the bytes;
//   2 the kernel's run-time node loop (its instantiation above 16 nodes);
//   3 the kernel before its redesign: a divide a code (q / levels), I2F, the
//     run-time node loop, one thread a group of 16 codes in blocks of 256
//     (nblk ignored);
//   4 the kernel's loads (cp.async) and stores without the arithmetic (out =
//     the loaded words and norms combined with xor);
//   5 the arithmetic without the loads: codes and norms made in registers
//     from the group and node index, stored only where the result's bits
//     fold to a sentinel (never, in practice);
//   6 register loads (__ldcs) in place of cp.async, in the order the
//     compiler gives them;
//   7 the same with every row prefetched to L2 (prefetch.global.L2) first;
//   8 the kernel with its tile in dynamic shared memory.
// Variants other than 2 and 3 take N = 10 nodes (kProbeN).  Variant 0 may
// ask for dynamic shared memory, which it leaves unused: a cap on the
// blocks an SM holds at once.

#include "../src/repro_torch/csrc/qsgd_decode.cu"

namespace {

constexpr int kProbeN = 10;

constexpr int kBeforeThreads = 256;

// the decode kernel as it stood before its redesign
__global__ void __launch_bounds__(kBeforeThreads)
decode_before_kernel(const int8_t* __restrict__ codes, const float* __restrict__ norms,
                     const float* __restrict__ w, float* __restrict__ out, int n, long long L,
                     int bucket, float levels) {
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

// MODE 0: the kernel's loads and stores, no arithmetic; MODE 1: arithmetic,
// no loads
template <int MODE>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const int8_t* __restrict__ codes, const float* __restrict__ norms,
                    const float* __restrict__ w, float* __restrict__ out, long long L,
                    Buckets bk, float r) {
  constexpr int N = kProbeN;
  __shared__ int4 tile[MODE == 0 ? N : 1][kThreads];
  const long long groups = L / kVec;
  const long long nb = bk.nb;
  const int4* rows = reinterpret_cast<const int4*>(codes);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const long long b = bk.of((unsigned)g);
    float acc[kVec];
    if constexpr (MODE == 0) {
      float nsum = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const unsigned slot = (unsigned)__cvta_generic_to_shared(&tile[i][threadIdx.x]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(slot),
                     "l"(rows + i * groups + g));
      }
#pragma unroll
      for (int i = 0; i < N; ++i) nsum += __ldg(norms + i * nb + b);
      asm volatile("cp.async.wait_all;" ::: "memory");
      unsigned fold[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int4 raw = tile[i][threadIdx.x];
        fold[0] ^= (unsigned)raw.x;
        fold[1] ^= (unsigned)raw.y;
        fold[2] ^= (unsigned)raw.z;
        fold[3] ^= (unsigned)raw.w;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = __uint_as_float(fold[e / 4] >> (e % 4)) + nsum;
      store16(out, g, acc);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const unsigned h = (unsigned)g * 2654435761u + (unsigned)i * 40503u;
        const int4 raw = make_int4((int)h, (int)(h ^ 0x9E3779B9u), (int)(h * 3u),
                                   (int)(h + 0x7F4A7C15u));
        const float nrm = __uint_as_float(0x3f800000u | ((unsigned)b * 2246822519u >> 9));
        add_node<false>(acc, raw, nrm, r, __ldg(w + i));
      }
      unsigned fold = 0u;
#pragma unroll
      for (int e = 0; e < kVec; ++e) fold ^= __float_as_uint(acc[e]);
      if (fold == 0x7FC0FFEEu) store16(out, g, acc);
    }
  }
}

// the N = 10 kernel with register loads (MODE 0), and with every row
// prefetched to L2 before them (MODE 1)
template <int MODE>
__global__ void __launch_bounds__(kThreads)
decode_registers_kernel(const int8_t* __restrict__ codes, const float* __restrict__ norms,
                        const float* __restrict__ w, float* __restrict__ out, long long L,
                        Buckets bk, float r) {
  constexpr int N = kProbeN;
  const long long groups = L / kVec;
  const long long nb = bk.nb;
  const int4* rows = reinterpret_cast<const int4*>(codes);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const long long b = bk.of((unsigned)g);
    if constexpr (MODE == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(rows + i * groups + g));
    }
    int4 raw[N];
    float nrm[N], wi[N], acc[kVec];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      raw[i] = __ldcs(rows + i * groups + g);
      nrm[i] = __ldg(norms + i * nb + b);
      wi[i] = __ldg(w + i);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) add_node<false>(acc, raw[i], nrm[i], r, wi[i]);
    store16(out, g, acc);
  }
}

// the kernel at N = 10 with its tile in dynamic shared memory
__global__ void __launch_bounds__(kThreads)
decode_dynamic_tile_kernel(const int8_t* __restrict__ codes, const float* __restrict__ norms,
                           const float* __restrict__ w, float* __restrict__ out, long long L,
                           Buckets bk, float r) {
  constexpr int N = kProbeN;
  extern __shared__ int4 dtile[];   // dtile[i * kThreads + thread]
  const long long groups = L / kVec;
  const long long nb = bk.nb;
  const int4* rows = reinterpret_cast<const int4*>(codes);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const long long b = bk.of((unsigned)g);
    int4 raw[N];
    float nrm[N], wi[N], acc[kVec];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(dtile + i * kThreads + threadIdx.x);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(rows + i * groups + g));
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      nrm[i] = __ldg(norms + i * nb + b);
      wi[i] = __ldg(w + i);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) raw[i] = dtile[i * kThreads + threadIdx.x];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) add_node<false>(acc, raw[i], nrm[i], r, wi[i]);
    store16(out, g, acc);
  }
}

constexpr int kDynamicTile = kProbeN * kThreads * (int)sizeof(int4);

// a variant's kernel function and the dynamic shared memory its tile needs
// (nullptr for 3)
const void* variant_kernel(int variant, int* tile) {
  *tile = 0;
  switch (variant) {
    case 0: return (const void*)decode_accumulate_kernel<kProbeN, false>;
    case 1: return (const void*)decode_accumulate_kernel<kProbeN, true>;
    case 2: return (const void*)decode_accumulate_kernel<0, false>;
    case 4: return (const void*)decode_split_kernel<0>;
    case 5: return (const void*)decode_split_kernel<1>;
    case 6: return (const void*)decode_registers_kernel<0>;
    case 7: return (const void*)decode_registers_kernel<1>;
    case 8: *tile = kDynamicTile; return (const void*)decode_dynamic_tile_kernel;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// blocks of the kernel's 128 threads that one SM holds at once for a
// variant launched with max(smem, its tile) bytes of dynamic shared memory
// (0 for variant 3; -error on failure)
int probe_decode_blocks_per_sm(int variant, int smem) {
  int tile = 0;
  const void* fn = variant_kernel(variant, &tile);
  if (fn == nullptr) return 0;
  smem = smem > tile ? smem : tile;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int probe_decode_f32(const void* codes, const void* norms, const void* w, void* out, int n,
                     long long L, int bucket, float r, float levels, int variant, unsigned nblk,
                     int smem, void* stream) {
  if (const int err = check_args(n, L, bucket)) return err;
  if (nblk < 1 || (variant != 3 && variant != 2 && n != kProbeN) || (smem && variant != 0))
    return (int)cudaErrorInvalidValue;
  int tile = 0;
  variant_kernel(variant, &tile);
  smem = smem > tile ? smem : tile;
  if (smem && probe_decode_blocks_per_sm(variant, smem) < 1) return (int)cudaErrorInvalidValue;
  const auto c = (const int8_t*)codes;
  const auto nr = (const float*)norms;
  const auto wp = (const float*)w;
  const auto o = (float*)out;
  const auto s = (cudaStream_t)stream;
  const Buckets bk = buckets(L, bucket);
  switch (variant) {
    case 0: decode_accumulate_kernel<kProbeN, false><<<nblk, kThreads, smem, s>>>(
                c, nr, wp, o, n, L, bk, r); break;
    case 1: decode_accumulate_kernel<kProbeN, true><<<nblk, kThreads, 0, s>>>(
                c, nr, wp, o, n, L, bk, r); break;
    case 2: decode_accumulate_kernel<0, false><<<nblk, kThreads, 0, s>>>(
                c, nr, wp, o, n, L, bk, r); break;
    case 3: {
      const unsigned blocks = (unsigned)((L / kVec + kBeforeThreads - 1) / kBeforeThreads);
      decode_before_kernel<<<blocks, kBeforeThreads, 0, s>>>(c, nr, wp, o, n, L, bucket, levels);
      break;
    }
    case 4: decode_split_kernel<0><<<nblk, kThreads, 0, s>>>(c, nr, wp, o, L, bk, r); break;
    case 5: decode_split_kernel<1><<<nblk, kThreads, 0, s>>>(c, nr, wp, o, L, bk, r); break;
    case 6: decode_registers_kernel<0><<<nblk, kThreads, 0, s>>>(c, nr, wp, o, L, bk, r); break;
    case 7: decode_registers_kernel<1><<<nblk, kThreads, 0, s>>>(c, nr, wp, o, L, bk, r); break;
    case 8: decode_dynamic_tile_kernel<<<nblk, kThreads, smem, s>>>(c, nr, wp, o, L, bk, r);
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
