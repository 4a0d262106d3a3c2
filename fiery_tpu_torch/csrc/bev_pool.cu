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
//
// Backward (fiery_bev_pool_backward). Replaces `_sorted_splat_bwd`
// (fiery_tpu/ops/lift_splat.py:123, the row gather d_rows[p] = g[ids[p]]) chained
// through the outer product's backward. For every frustum pixel p and bin d whose
// id is not the dump bin, with r = g[s, id[p, d] / Z]:
//     d_feat[p, c]  = sum_d depth[p, d] * r[c]
//     d_depth[p, d] = sum_c feat[p, c] * r[c]
// Each output is owned by one warp, so there are no atomics and the result does
// not depend on the order of launch. The gathered (P, C) gradient rows are never
// written to memory.
// Bound on an H100: bytes. At the training shapes (9 samples) it must read depth
// (8.7 MB bf16), feat (11.6 MB), ids (17.4 MB) and g (46.1 MB) and write d_depth
// and d_feat (20.3 MB); 4 flops per in-grid row-channel are ~0.5 GFLOP.
// Design: one warp per pixel; lane l holds channels l, l + 32, ... (C <= 256) of
// the pixel's features and of its d_feat sums in registers. For each bin d the
// warp reads the C-wide gradient row coalesced, accumulates depth * r into d_feat
// and reduces feat . r across the warp (shuffles) into d_depth. The ids of a
// pixel are read by every lane as broadcasts, so the dump-bin branch is uniform.

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

constexpr int kMaxChannelsPerLane = 8;   // C <= 256

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void pool_backward_kernel(const T* __restrict__ depth, const T* __restrict__ feat,
                                     const int32_t* __restrict__ ids,
                                     const T* __restrict__ g, T* __restrict__ d_depth,
                                     T* __restrict__ d_feat, int64_t n_pix,
                                     int64_t pix_per_sample, int D, int C, int num_bins,
                                     int z_bins) {
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_pix) return;   // the whole warp leaves together
  const int64_t s = p / pix_per_sample;
  const T* dp = depth + p * D;
  const int32_t* ip = ids + p * D;
  const T* gs = g + s * (int64_t)(num_bins / z_bins) * C;
  float f[kMaxChannelsPerLane], acc[kMaxChannelsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerLane; ++k) {
    const int c = lane + 32 * k;
    f[k] = c < C ? to_float(feat[p * C + c]) : 0.0f;
    acc[k] = 0.0f;
  }
  for (int d = 0; d < D; ++d) {
    const int id = ip[d];
    float dd = 0.0f;
    // id == num_bins is the dump bin: out-of-bounds points get no gradient
    if ((unsigned)id < (unsigned)num_bins) {
      const T* r = gs + (int64_t)(id / z_bins) * C;
      const float w = to_float(dp[d]);
#pragma unroll
      for (int k = 0; k < kMaxChannelsPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          const float rv = to_float(r[c]);
          acc[k] = __fadd_rn(acc[k], __fmul_rn(w, rv));
          dd = __fadd_rn(dd, __fmul_rn(f[k], rv));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, off);
    }
    if (lane == 0) d_depth[p * D + d] = from_float<T>(dd);
  }
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < C) d_feat[p * C + c] = from_float<T>(acc[k]);
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

// depth, feat, ids as for fiery_bev_pool; g: (S, num_bins / z_bins, C) contiguous, the
// dtype of depth; d_depth, d_feat: shaped and typed as depth and feat (every value
// is written). C <= 256. Returns cudaGetLastError() after the launch.
extern "C" int fiery_bev_pool_backward(const void* depth, const void* feat, const void* ids,
                                       const void* g, void* d_depth, void* d_feat,
                                       long long n_pix, long long pix_per_sample, int D,
                                       int C, int num_bins, int z_bins, int is_bf16,
                                       void* stream) {
  if (C > 32 * kMaxChannelsPerLane) return (int)cudaErrorInvalidValue;
  const int threads = 256;                 // 8 warps, one pixel each
  const long long total = n_pix * 32;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    pool_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)depth, (const __nv_bfloat16*)feat, (const int32_t*)ids,
        (const __nv_bfloat16*)g, (__nv_bfloat16*)d_depth, (__nv_bfloat16*)d_feat, n_pix,
        pix_per_sample, D, C, num_bins, z_bins);
  } else {
    pool_backward_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)depth, (const float*)feat, (const int32_t*)ids, (const float*)g,
        (float*)d_depth, (float*)d_feat, n_pix, pix_per_sample, D, C, num_bins, z_bins);
  }
  return (int)cudaGetLastError();
}
