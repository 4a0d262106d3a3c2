// bev_warp: SE(2) bilinear warp of channels-last BEV feature maps, with torch
// grid_sample parity (align_corners=False, zero padding).
//
// Replaces: fiery_tpu/ops/warp.py `_grid_sample_single` (bilinear mode), reached
// through `warp_features` -> `_warp_theta` + `_affine_grid` and
// `cumulative_warp_features` (four XLA row gathers over a materialised grid).
//
// Computes, per output pixel (i, j) of map b and channel c:
//     theta = [[cos a, -sin a, ty], [sin a, cos a, tx]],  a = pose[b, 5],
//             tx = -pose[b, 0] / extent_x,  ty = pose[b, 1] / extent_y
//     (gx, gy) = theta . ((2j + 1) / W - 1, (2i + 1) / H - 1, 1)
//     ix = ((gx + 1) W - 1) / 2,  iy = ((gy + 1) H - 1) / 2
//     out = sum over the 4 taps of x[tap] * bilinear weight (zero outside the map)
// Each division is a multiplication by the f32 reciprocal the caller passes, as
// PyTorch's CUDA division by a scalar computes it.
// theta and the grid are rounded to the feature dtype (as warp.py computes them in
// x.dtype); everything after the grid is f32, rounded once on store.
//
// Bound on an H100: bytes. At the baseline serve shapes (2 past frames of
// 200 x 200 x 64 bf16) the kernel must read 10.2 MB and write 10.2 MB; the ~10
// flops per output value are negligible. The grid is never written to memory:
// each thread recomputes theta and its pixel's coordinates from the 6-float pose.
//
// Design: one thread per (output pixel, channel), channel fastest, so the C
// threads of a pixel load each tap's C contiguous values coalesced. Every f32
// operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn: no FMA
// contraction) in the same order as the plain PyTorch version,
// so the two agree bit for bit in f32 up to the cos/sin implementations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to T and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

template <typename T>
__global__ void bev_warp_kernel(const T* __restrict__ x, const float* __restrict__ pose,
                                T* __restrict__ out, int B, int H, int W, int C,
                                float inv_extent_x, float inv_extent_y, float inv_w,
                                float inv_h) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)B * H * W * C;
  if (t >= total) return;
  const int c = (int)(t % C);
  const int64_t pix = t / C;
  const int j = (int)(pix % W);
  const int i = (int)((pix / W) % H);
  const int b = (int)(pix / ((int64_t)W * H));

  const float* pv = pose + (int64_t)b * 6;
  const float cos_a = cosf(pv[5]), sin_a = sinf(pv[5]);
  const float tx = __fmul_rn(-pv[0], inv_extent_x);
  const float ty = __fmul_rn(pv[1], inv_extent_y);
  const float t00 = round_to<T>(cos_a), t01 = round_to<T>(-sin_a), t02 = round_to<T>(ty);
  const float t10 = round_to<T>(sin_a), t11 = round_to<T>(cos_a), t12 = round_to<T>(tx);

  const float bx = __fadd_rn(__fmul_rn(__fadd_rn(2.0f * (float)j, 1.0f), inv_w), -1.0f);
  const float by = __fadd_rn(__fmul_rn(__fadd_rn(2.0f * (float)i, 1.0f), inv_h), -1.0f);
  const float gx = round_to<T>(__fadd_rn(__fadd_rn(__fmul_rn(t00, bx), __fmul_rn(t01, by)), t02));
  const float gy = round_to<T>(__fadd_rn(__fadd_rn(__fmul_rn(t10, bx), __fmul_rn(t11, by)), t12));

  const float ix = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)W), -1.0f), 0.5f);
  const float iy = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)H), -1.0f), 0.5f);
  const float x0f = floorf(ix), y0f = floorf(iy);
  const float wx1 = __fadd_rn(ix, -x0f), wy1 = __fadd_rn(iy, -y0f);
  const float wx0 = __fadd_rn(1.0f, -wx1), wy0 = __fadd_rn(1.0f, -wy1);

  // validity from the float coordinates, so a far-out grid never overflows an int
  const bool vx0 = x0f >= 0.0f && x0f < (float)W;
  const bool vx1 = x0f + 1.0f >= 0.0f && x0f + 1.0f < (float)W;
  const bool vy0 = y0f >= 0.0f && y0f < (float)H;
  const bool vy1 = y0f + 1.0f >= 0.0f && y0f + 1.0f < (float)H;
  const int x0 = vx0 ? (int)x0f : 0, x1 = vx1 ? (int)x0f + 1 : 0;
  const int y0 = vy0 ? (int)y0f : 0, y1 = vy1 ? (int)y0f + 1 : 0;
  const T* xb = x + (int64_t)b * H * W * C + c;
  const float v00 = (vy0 && vx0) ? to_float(xb[((int64_t)y0 * W + x0) * C]) : 0.0f;
  const float v01 = (vy0 && vx1) ? to_float(xb[((int64_t)y0 * W + x1) * C]) : 0.0f;
  const float v10 = (vy1 && vx0) ? to_float(xb[((int64_t)y1 * W + x0) * C]) : 0.0f;
  const float v11 = (vy1 && vx1) ? to_float(xb[((int64_t)y1 * W + x1) * C]) : 0.0f;

  float acc = __fmul_rn(v00, __fmul_rn(wy0, wx0));
  acc = __fadd_rn(acc, __fmul_rn(v01, __fmul_rn(wy0, wx1)));
  acc = __fadd_rn(acc, __fmul_rn(v10, __fmul_rn(wy1, wx0)));
  acc = __fadd_rn(acc, __fmul_rn(v11, __fmul_rn(wy1, wx1)));
  out[t] = from_float<T>(acc);
}

}  // namespace

// x, out: (B, H, W, C) contiguous, float32 or bfloat16; pose: (B, 6) float32;
// inv_*: f32 reciprocals of the extents and of W and H.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_bev_warp(const void* x, const void* pose, void* out, int B, int H,
                              int W, int C, float inv_extent_x, float inv_extent_y,
                              float inv_w, float inv_h, int is_bf16, void* stream) {
  const int threads = 256;
  const long long total = (long long)B * H * W * C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    bev_warp_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)pose, (__nv_bfloat16*)out, B, H, W, C,
        inv_extent_x, inv_extent_y, inv_w, inv_h);
  } else {
    bev_warp_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)pose, (float*)out, B, H, W, C, inv_extent_x,
        inv_extent_y, inv_w, inv_h);
  }
  return (int)cudaGetLastError();
}
