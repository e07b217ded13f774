// Variants of the streaming median and krum d2 kernels of
// src/repro_torch/csrc/masked_agg.cu that split their time between memory
// and arithmetic, for tools/agg_stream_probe.py.  The production source is
// included, so the variants run its device code and the library also holds
// its entry points.  Build (the probe does it):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libagg_stream_probe.so tools/agg_stream_probe.cu
//
// Every variant runs the kernels' grid (first_col / grid_stride, VEC = 4)
// over an (N, D) float32 stack, N = 10 rows, all kept:
//   median mode 0: loads and store, no network (out = the rows' sum);
//   median mode 1: the K = 10 network on values made in registers from the
//                  column index, no loads, no stores (one store where a
//                  result is a sentinel, which values in [1, 2) never are);
//   krum mode 0:   loads, each row's values summed into one register, then
//                  the partials (no pair products);
//   krum mode 1:   the 55 pair products on values made in registers, no
//                  loads, then the partials.

#include "../src/repro_torch/csrc/masked_agg.cu"

namespace {

constexpr int kProbeN = 10;

// a float in [1, 2) from a column and a row, a few integer operations
__device__ __forceinline__ float made(long long c, int s) {
  const unsigned h = (unsigned)c * 2654435761u + (unsigned)s * 40503u;
  return __uint_as_float(0x3f800000u | (h >> 9));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
median_probe(const float* __restrict__ x, float* __restrict__ out, long long d) {
  constexpr int K = kProbeN;
  for (long long c = first_col<4>(); c < d; c += grid_stride<4>()) {
    Cols<4> r[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if constexpr (MODE == 0) {
        r[s] = load_stream<4>(x + (long long)s * d + c);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[s].e[j] = made(c + j, s);
      }
    }
    Cols<4> o;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (MODE == 0) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < K; ++s) acc += r[s].e[j];
        o.e[j] = acc;
      } else {
        float v[K];
#pragma unroll
        for (int s = 0; s < K; ++s) v[s] = r[s].e[j];
        merge_exchange<K>(v);
        o.e[j] = (v[(K - 1) / 2] + v[K / 2]) * 0.5f;
      }
    }
    if (MODE == 0 || o.e[0] < 0.f) store_cols<4>(out + c, o);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
krum_probe(const float* __restrict__ x, float* __restrict__ partial, long long d) {
  constexpr int N = kProbeN;
  constexpr int P = MODE == 0 ? 1 : N * (N + 1) / 2;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  for (long long c = first_col<4>(); c < d; c += grid_stride<4>()) {
    Cols<4> r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (MODE == 0) {
        r[i] = load_stream<4>(x + (long long)i * d + c);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i].e[j] = made(c + j, i);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if constexpr (MODE == 0) {
          acc[0] += r[i].e[e];
        } else {
#pragma unroll
          for (int j = i; j < N; ++j) {
            const int p = pair_index(i, j, N);
            acc[p] = fmaf(r[i].e[e], r[j].e[e], acc[p]);
          }
        }
      }
    }
  }
  write_partials<P>(acc, partial, P);
}

}  // namespace

extern "C" {

// out: (d,) float; x: (10, d) float32, d % 4 == 0, 16-byte aligned
int probe_median_f32(const void* x, void* out, int nblk, long long d, int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!stream_layout_ok(d, nblk, 4, x, out)) return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    median_probe<0><<<nblk, kThreads, 0, s>>>((const float*)x, (float*)out, d);
  } else {
    median_probe<1><<<nblk, kThreads, 0, s>>>((const float*)x, (float*)out, d);
  }
  return (int)cudaGetLastError();
}

// partial: (55, nblk) float scratch (mode 0 writes its first row)
int probe_krum_f32(const void* x, void* partial, int nblk, long long d, int mode,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!stream_layout_ok(d, nblk, 4, x, nullptr)) return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    krum_probe<0><<<nblk, kThreads, 0, s>>>((const float*)x, (float*)partial, d);
  } else {
    krum_probe<1><<<nblk, kThreads, 0, s>>>((const float*)x, (float*)partial, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
