// bev_pool: fused lift + voxel splat (depth (x) feature outer product, segment-summed
// into the BEV grid) for the Lift-Splat camera-to-BEV projection.
//
// Replaces: fiery_tpu/ops/lift_splat.py `_sorted_splat` (forward), reached through
// `lift_splat` and `depth_feature_outer_product` (the XLA segment-sum over a
// materialised (P, C) lifted volume, P = N*h*w*D rows per sample).
//
// Computes, for every sample s, pixel p of that sample and depth bin d whose voxel
// id is not the dump bin:
//     out[s, id[p, d] / Z, c] += depth[p, d] * feat[p, c]          (f32)
// The (P, C) lifted volume is never built: each thread reads one feature value
// once and multiplies it by the pixel's D depth weights on the fly.
//
// Bound on an H100: bytes. At the baseline serve shapes (3 samples x 6 cameras x
// 28 x 60 pixels x 48 bins, C = 64) the inputs are ~12.6 MB (bf16 depth and
// features, int32 ids) and the f32 output 30.7 MB; the 2 flops per row-channel
// (~0.2 GFLOP) are far below the f32 rate. The simple design below is instead
// limited by its ~93 M global f32 atomics.
//
// Design: one thread per (pixel, channel), channel fastest, so the threads of a
// pixel read its ids and depths as broadcasts, read the features coalesced, and
// issue their atomics to C consecutive floats of one BEV row (coalesced
// reductions in L2). Products are formed in f32 with __fmul_rn (no FMA
// contraction), exactly as the plain PyTorch version forms them; only the order
// of the f32 additions differs, and it varies from run to run with the atomics.
// The wrapper zeroes `out` and casts it to the compute dtype afterwards.
// A BEVPoolv2-style sorted-interval design (one owner thread per output row, no
// atomics) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void bev_pool_kernel(const T* __restrict__ depth, const T* __restrict__ feat,
                                const int32_t* __restrict__ ids, float* __restrict__ out,
                                int64_t n_pix, int64_t pix_per_sample, int D, int C,
                                int num_bins, int z_bins) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pix * C) return;
  const int64_t p = t / C;
  const int c = (int)(t - p * C);
  const int64_t s = p / pix_per_sample;
  const float f = to_float(feat[t]);
  const T* dp = depth + p * D;
  const int32_t* ip = ids + p * D;
  float* o = out + s * (int64_t)(num_bins / z_bins) * C + c;
  for (int d = 0; d < D; ++d) {
    const int id = ip[d];
    // id == num_bins is the dump bin: out-of-bounds points are dropped
    if ((unsigned)id >= (unsigned)num_bins) continue;
    atomicAdd(o + (int64_t)(id / z_bins) * C, __fmul_rn(to_float(dp[d]), f));
  }
}

}  // namespace

// depth, feat: (S, N, h, w, D) / (S, N, h, w, C) contiguous, float32 or bfloat16;
// ids: (S, N, h, w, D) int32 in [0, num_bins]; out: (S, num_bins / z_bins, C) f32,
// zeroed by the caller. Returns cudaGetLastError() after the launch.
extern "C" int fiery_bev_pool(const void* depth, const void* feat, const void* ids,
                              void* out, long long n_pix, long long pix_per_sample,
                              int D, int C, int num_bins, int z_bins, int is_bf16,
                              void* stream) {
  const int threads = 256;
  const long long total = n_pix * (long long)C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    bev_pool_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)depth, (const __nv_bfloat16*)feat, (const int32_t*)ids,
        (float*)out, n_pix, pix_per_sample, D, C, num_bins, z_bins);
  } else {
    bev_pool_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)depth, (const float*)feat, (const int32_t*)ids, (float*)out, n_pix,
        pix_per_sample, D, C, num_bins, z_bins);
  }
  return (int)cudaGetLastError();
}
