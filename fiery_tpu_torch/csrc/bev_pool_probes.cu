// Probes that chip_smoke.py times beside K1 (csrc/bev_pool.cu); no path of the
// package calls them.
//
// fiery_splat_red_probe: the atomic design that K1's forward replaced, with vector
// reductions. One thread a (pixel, 4 channels) reads its 4 feature values once and,
// for each in-grid depth bin, adds the 4 products (__fmul_rn) into a zeroed f32
// grid with one red.global.add.v4.f32 (PTX ISA 8.1, sm_90): a quarter of the
// scalar design's reduction instructions. Its sums run in the order the atomics
// land, which changes from run to run; it is a measurement, not a port.
//
// fiery_gather_probe: the L2 gather floor of an owner-computes splat. For i < n it
// reads row idx[i] of src (row_bytes each, 16-byte loads, a group of row_bytes / 16
// lanes a row, 8 rows in flight a group) and folds the bits by xor into one word a
// warp of sink, so that the loads cannot be dropped. Fed K1's gather order (the
// feature row of each ordered row, or the gradient row of each in-grid bin), its
// time is the least time that gather takes at the card's L2 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void red_probe_kernel(const T* __restrict__ depth, const T* __restrict__ feat,
                                 const int32_t* __restrict__ ids, float* out, long long n_pix,
                                 long long pix_per_sample, int D, int C, int num_bins,
                                 int z_bins) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int C4 = C / 4;
  if (t >= n_pix * C4) return;
  const long long p = t / C4;
  const int c = (int)(t - p * C4) * 4;
  const long long s = p / pix_per_sample;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = to_float(feat[p * C + c + i]);
  const T* dp = depth + p * D;
  const int32_t* ip = ids + p * D;
  float* o = out + s * (long long)(num_bins / z_bins) * C + c;
  for (int d = 0; d < D; ++d) {
    const int id = ip[d];
    if ((unsigned)id >= (unsigned)num_bins) continue;
    const float w = to_float(dp[d]);
    float* a = o + (long long)(id / z_bins) * C;
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
                 "f"(__fmul_rn(w, f[0])), "f"(__fmul_rn(w, f[1])), "f"(__fmul_rn(w, f[2])),
                 "f"(__fmul_rn(w, f[3]))
                 : "memory");
  }
}

__global__ void gather_probe_kernel(const int32_t* __restrict__ idx, long long n,
                                    const uint4* __restrict__ src, int row_vecs,
                                    unsigned* __restrict__ sink) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, gl = lane & (row_vecs - 1);
  const long long first = (t / row_vecs) * kRows;
  uint4 v[kRows];
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const long long i = first + e;
    v[e] = i < n ? __ldg(src + (long long)__ldg(idx + i) * row_vecs + gl)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned x = 0;
#pragma unroll
  for (int e = 0; e < kRows; ++e) x ^= v[e].x ^ v[e].y ^ v[e].z ^ v[e].w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) sink[t >> 5] = x;
}

}  // namespace

// depth, feat, ids as for fiery_bev_pool (n_pix = S * pix_per_sample pixels), C a
// multiple of 4; out: (S, num_bins / z_bins, C) f32, zeroed by the caller. One
// launch; returns cudaGetLastError().
extern "C" int fiery_splat_red_probe(const void* depth, const void* feat, const void* ids,
                                     void* out, long long n_pix, long long pix_per_sample,
                                     int D, int C, int num_bins, int z_bins, int is_bf16,
                                     void* stream) {
  if (C % 4) return (int)cudaErrorInvalidValue;
  const long long total = n_pix * (C / 4);
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    red_probe_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)depth, (const __nv_bfloat16*)feat, (const int32_t*)ids,
        (float*)out, n_pix, pix_per_sample, D, C, num_bins, z_bins);
  else
    red_probe_kernel<float><<<blocks, kThreads, 0, st>>>(
        (const float*)depth, (const float*)feat, (const int32_t*)ids, (float*)out, n_pix,
        pix_per_sample, D, C, num_bins, z_bins);
  return (int)cudaGetLastError();
}

// The number of words fiery_gather_probe writes to sink for n rows of row_bytes.
extern "C" long long fiery_gather_probe_sink(long long n, int row_bytes) {
  const long long threads = (n + kRows - 1) / kRows * (row_bytes / 16);
  return (threads + 31) / 32 + kThreads / 32;
}

// idx: (n,) int32 row indices of src; src: rows of row_bytes (16, 32, ..., 512;
// 16-byte aligned); sink: fiery_gather_probe_sink(n, row_bytes) words. One launch;
// returns cudaGetLastError().
extern "C" int fiery_gather_probe(const void* idx, long long n, const void* src,
                                  int row_bytes, void* sink, void* stream) {
  const int row_vecs = row_bytes / 16;
  if (row_bytes % 16 || row_vecs > 32 || (row_vecs & (row_vecs - 1)))
    return (int)cudaErrorInvalidValue;
  const long long threads = (n + kRows - 1) / kRows * row_vecs;
  if (threads == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  gather_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (const uint4*)src, row_vecs, (unsigned*)sink);
  return (int)cudaGetLastError();
}
