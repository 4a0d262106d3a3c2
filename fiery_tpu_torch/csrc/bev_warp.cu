// bev_warp: SE(2) warps of channels-last BEV maps, with torch grid_sample parity
// (align_corners=False, zero padding): the bilinear warp of the features, its
// backward, and the nearest warp of the label maps.
//
// Replaces: fiery_tpu/ops/warp.py `_grid_sample_single`, reached through
// `warp_features` -> `_warp_theta` + `_affine_grid` (XLA row gathers over a
// materialised grid):
//   - bilinear mode (K2), via `cumulative_warp_features`: fiery_bev_warp;
//   - its transpose, the scatter-add of the four gathers that XLA derives for the
//     backward (K2 backward): fiery_bev_warp_backward;
//   - nearest mode (K4), via `cumulative_warp_features_reverse` in the trainer's
//     label preparation: fiery_bev_warp with nearest = 1.
//
// Computes, per output pixel (i, j) of map b and channel c:
//     theta = [[cos a, -sin a, ty], [sin a, cos a, tx]],  a = pose[b, 5],
//             tx = -pose[b, 0] / extent_x,  ty = pose[b, 1] / extent_y
//     (gx, gy) = theta . ((2j + 1) / W - 1, (2i + 1) / H - 1, 1)
//     ix = ((gx + 1) W - 1) / 2,  iy = ((gy + 1) H - 1) / 2
//     bilinear: out = sum over the 4 taps of x[tap] * weight (zero outside the map)
//     nearest:  out = x[rint(iy), rint(ix)] (round half to even; zero outside)
//     backward: dx[tap] += g[i, j] * weight, for each of the 4 taps
// Each division is a multiplication by the f32 reciprocal the caller passes, as
// PyTorch's CUDA division by a scalar computes it.
// theta and the grid are rounded to the feature dtype (as warp.py computes them in
// x.dtype); everything after the grid is f32, rounded once on store.
//
// Bound on an H100: bytes; the ~10-30 flops per value are negligible.
//   - forward, training shapes (6 past frames of 200 x 200 x 64 bf16): read
//     30.7 MB, write 30.7 MB;
//   - backward, same shapes: read g (30.7 MB), write dx (30.7 MB, bf16);
//   - nearest, the label stack (12 frames of 200 x 200 x 7 f32): read 13.4 MB,
//     write 13.4 MB.
// The grid is never written to memory: each thread recomputes theta and its
// pixel's coordinates from the 6-float pose.
//
// Design: one thread per (output pixel, channel), channel fastest, so the C
// threads of a pixel load (or, backward, update) each tap's C contiguous values
// coalesced. Every f32 operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn: no FMA contraction) in the same order as the plain PyTorch version,
// so forward and nearest agree with it bit for bit in f32 up to the cos/sin
// implementations. The backward adds with f32 atomics into a zeroed f32 buffer
// that the wrapper casts once, as bev_pool does; only the order of the f32 sums
// differs from the plain version, and it varies from run to run.

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

// Sampling coordinates of output pixel (i, j) of map b: (ix, iy) in input pixels.
template <typename T>
__device__ __forceinline__ void sample_point(const float* __restrict__ pose, int b, int i,
                                             int j, int H, int W, float inv_extent_x,
                                             float inv_extent_y, float inv_w, float inv_h,
                                             float* ix, float* iy) {
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

  *ix = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)W), -1.0f), 0.5f);
  *iy = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)H), -1.0f), 0.5f);
}

// The four bilinear taps of (ix, iy): flat pixel offsets (valid taps only) and weights.
struct Taps {
  int64_t off[4];
  float w[4];
  bool valid[4];
};

__device__ __forceinline__ Taps bilinear_taps(float ix, float iy, int H, int W) {
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
  Taps t;
  t.off[0] = (int64_t)y0 * W + x0; t.w[0] = __fmul_rn(wy0, wx0); t.valid[0] = vy0 && vx0;
  t.off[1] = (int64_t)y0 * W + x1; t.w[1] = __fmul_rn(wy0, wx1); t.valid[1] = vy0 && vx1;
  t.off[2] = (int64_t)y1 * W + x0; t.w[2] = __fmul_rn(wy1, wx0); t.valid[2] = vy1 && vx0;
  t.off[3] = (int64_t)y1 * W + x1; t.w[3] = __fmul_rn(wy1, wx1); t.valid[3] = vy1 && vx1;
  return t;
}

template <typename T>
__global__ void bev_warp_kernel(const T* __restrict__ x, const float* __restrict__ pose,
                                T* __restrict__ out, int B, int H, int W, int C,
                                float inv_extent_x, float inv_extent_y, float inv_w,
                                float inv_h, int nearest) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)B * H * W * C;
  if (t >= total) return;
  const int c = (int)(t % C);
  const int64_t pix = t / C;
  const int j = (int)(pix % W);
  const int i = (int)((pix / W) % H);
  const int b = (int)(pix / ((int64_t)W * H));
  float ix, iy;
  sample_point<T>(pose, b, i, j, H, W, inv_extent_x, inv_extent_y, inv_w, inv_h, &ix, &iy);
  const T* xb = x + (int64_t)b * H * W * C + c;

  if (nearest) {
    // round half to even, as torch.round and jnp.round
    const float xr = rintf(ix), yr = rintf(iy);
    const bool valid = xr >= 0.0f && xr < (float)W && yr >= 0.0f && yr < (float)H;
    out[t] = valid ? xb[((int64_t)yr * W + (int64_t)xr) * C] : from_float<T>(0.0f);
    return;
  }
  const Taps tp = bilinear_taps(ix, iy, H, W);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = tp.valid[k] ? to_float(xb[tp.off[k] * C]) : 0.0f;
    acc = k == 0 ? __fmul_rn(v, tp.w[k]) : __fadd_rn(acc, __fmul_rn(v, tp.w[k]));
  }
  out[t] = from_float<T>(acc);
}

// Backward of the bilinear warp with respect to x: each (output pixel, channel)
// scatters g * weight into its four taps. f32 atomics into a zeroed f32 buffer.
template <typename T>
__global__ void warp_scatter_kernel(const T* __restrict__ g, const float* __restrict__ pose,
                                    float* __restrict__ dx, int B, int H, int W, int C,
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
  const float gv = to_float(g[t]);
  if (gv == 0.0f) return;
  float ix, iy;
  sample_point<T>(pose, b, i, j, H, W, inv_extent_x, inv_extent_y, inv_w, inv_h, &ix, &iy);
  const Taps tp = bilinear_taps(ix, iy, H, W);
  float* db = dx + (int64_t)b * H * W * C + c;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (tp.valid[k]) atomicAdd(db + tp.off[k] * C, __fmul_rn(gv, tp.w[k]));
}

}  // namespace

// x, out: (B, H, W, C) contiguous, float32 or bfloat16; pose: (B, 6) float32;
// inv_*: f32 reciprocals of the extents and of W and H; nearest: 0 bilinear, 1 nearest.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_bev_warp(const void* x, const void* pose, void* out, int B, int H,
                              int W, int C, float inv_extent_x, float inv_extent_y,
                              float inv_w, float inv_h, int is_bf16, int nearest,
                              void* stream) {
  const int threads = 256;
  const long long total = (long long)B * H * W * C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    bev_warp_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)pose, (__nv_bfloat16*)out, B, H, W, C,
        inv_extent_x, inv_extent_y, inv_w, inv_h, nearest);
  } else {
    bev_warp_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)pose, (float*)out, B, H, W, C, inv_extent_x,
        inv_extent_y, inv_w, inv_h, nearest);
  }
  return (int)cudaGetLastError();
}

// g: (B, H, W, C) contiguous output gradient, float32 or bfloat16 (the dtype of the
// forward's x, which sets where theta and the grid were rounded); dx: (B, H, W, C)
// f32, zeroed by the caller. Returns cudaGetLastError() after the launch.
extern "C" int fiery_bev_warp_backward(const void* g, const void* pose, void* dx, int B,
                                       int H, int W, int C, float inv_extent_x,
                                       float inv_extent_y, float inv_w, float inv_h,
                                       int is_bf16, void* stream) {
  const int threads = 256;
  const long long total = (long long)B * H * W * C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    warp_scatter_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)g, (const float*)pose, (float*)dx, B, H, W, C, inv_extent_x,
        inv_extent_y, inv_w, inv_h);
  } else {
    warp_scatter_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)g, (const float*)pose, (float*)dx, B, H, W, C, inv_extent_x,
        inv_extent_y, inv_w, inv_h);
  }
  return (int)cudaGetLastError();
}
