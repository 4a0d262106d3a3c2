// bev_warp: SE(2) warps of channels-last BEV maps, with torch grid_sample parity
// (align_corners=False, zero padding): the bilinear warp of the features, its
// backward, and the nearest warp of the label maps.
//
// Replaces: fiery_tpu/ops/warp.py `_grid_sample_single`, reached through
// `warp_features` -> `_warp_theta` + `_affine_grid` (XLA row gathers over a
// materialised grid):
//   - bilinear mode (K2), via `cumulative_warp_features`: fiery_bev_warp;
//   - its transpose, the scatter-add of the four gathers that XLA derives for the
//     backward (K2 backward): fiery_bev_warp_backward, written as a gather;
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
//     backward: dx[p] = sum over taps k = 0..3, then over output pixels o in
//               ascending order whose tap k is p, of g[o] * weight_k(o)
// Each division is a multiplication by the f32 reciprocal the caller passes, as
// PyTorch's CUDA division by a scalar computes it.
// theta and the grid are rounded to the feature dtype (as warp.py computes them in
// x.dtype); everything after the grid is f32, rounded once on store. theta's f32
// cosf and sinf can differ from the host's cos and sin in the last bit:
// fiery_bev_warp_theta writes theta as these kernels compute it, and the plain
// versions on the host, given that theta, compute what the kernels compute.
//
// Bound on an H100: bytes; the ~10-30 flops per value are negligible.
//   - forward, training shapes (6 past frames of 200 x 200 x 64 bf16): read
//     30.7 MB, write 30.7 MB;
//   - backward, same shapes: read g (30.7 MB), write dx (30.7 MB, bf16);
//   - nearest, the label stack (12 frames of 200 x 200 x 7 f32): read 13.4 MB,
//     write 13.4 MB.
//
// Forward and nearest: one thread per (output pixel, channel), channel fastest, so
// the C threads of a pixel load each tap's C contiguous values coalesced; each
// thread recomputes theta and its pixel's coordinates from the 6-float pose. Every
// f32 operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn: no FMA
// contraction) in the same order as the plain PyTorch version, so both agree with
// it bit for bit in f32 up to the cos/sin implementations.
//
// Backward (owner computes): a block owns a 16 x 16 tile of input pixels. It stages,
// once per output pixel, the sample cell and fractional weights of every output
// pixel in the tile's region (the bounding box of the preimage of the tile's cells
// under the map, a rotated and, for H != W, sheared square, widened for the grid's
// rounding to the dtype: half an ulp of |gx| < 2 times W / 2, 0.39 px at W = 200 in
// bf16, and for f32 error), with exactly the forward's arithmetic; lists the
// output pixels of each of the 17 x 17 cells whose taps reach the tile (a count, a
// scan and a fill with integer atomics in shared memory, then each list sorted
// ascending); and gives each input pixel p a group of 8 lanes, 8 channels a lane
// (16-byte accesses of bf16), which walks the lists of cells p - (k & 1, k >> 1)
// for k = 0..3 and sums g[o] * weight_k(o) in the plain version's order: k = 0..3,
// then o ascending, each product and sum rounded (no FMA), from 0, rounded once to
// the dtype, with 4 rows' loads in flight. The plain version's index_add_ adds its
// rows in that order on the host and its out-of-map taps add signed zeros at
// clamped indices, which change no finite sum, so for finite g, given the kernel's
// theta, the two agree bit for bit and two calls give the same bits. No float
// atomics, no zeroed buffer, no cast pass. theta and the region follow from the pose
// and H / W on the card (no host read of the pose); the region's area is bounded for
// every finite theta by the shapes alone (fiery_bev_warp_gather_entries sizes the
// staging). A tile whose region is not finite (a NaN or infinite pose) or larger
// than the staging gets NaN in every value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GATHER_MAX_ENTRIES = 6900;  // staged output pixels a block (32 bytes each)
constexpr int GT = 16;                    // the backward's input tile side

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

struct Theta {
  float t00, t01, t02, t10, t11, t12;
};

// theta of map b from its pose, each entry rounded to T.
template <typename T>
__device__ __forceinline__ Theta make_theta(const float* __restrict__ pose, int64_t b,
                                            float inv_extent_x, float inv_extent_y) {
  const float* pv = pose + b * 6;
  const float cos_a = cosf(pv[5]), sin_a = sinf(pv[5]);
  const float tx = __fmul_rn(-pv[0], inv_extent_x);
  const float ty = __fmul_rn(pv[1], inv_extent_y);
  Theta th;
  th.t00 = round_to<T>(cos_a);
  th.t01 = round_to<T>(-sin_a);
  th.t02 = round_to<T>(ty);
  th.t10 = round_to<T>(sin_a);
  th.t11 = round_to<T>(cos_a);
  th.t12 = round_to<T>(tx);
  return th;
}

// Sampling coordinates of output pixel (i, j): (ix, iy) in input pixels.
template <typename T>
__device__ __forceinline__ void sample_point(const Theta& th, int i, int j, float inv_w,
                                             float inv_h, int H, int W, float* ix, float* iy) {
  const float bx = __fadd_rn(__fmul_rn(__fadd_rn(2.0f * (float)j, 1.0f), inv_w), -1.0f);
  const float by = __fadd_rn(__fmul_rn(__fadd_rn(2.0f * (float)i, 1.0f), inv_h), -1.0f);
  const float gx =
      round_to<T>(__fadd_rn(__fadd_rn(__fmul_rn(th.t00, bx), __fmul_rn(th.t01, by)), th.t02));
  const float gy =
      round_to<T>(__fadd_rn(__fadd_rn(__fmul_rn(th.t10, bx), __fmul_rn(th.t11, by)), th.t12));
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
  sample_point<T>(make_theta<T>(pose, b, inv_extent_x, inv_extent_y), i, j, inv_w, inv_h,
                  H, W, &ix, &iy);
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

// ---------------------------------------------------------------------------
// Backward: the transpose of the four gathers, as a gather
// ---------------------------------------------------------------------------

constexpr int GG = 8;                       // lanes a pixel
constexpr int GTHREADS = 256;               // 32 groups
constexpr int GCH = GG * 8;                 // channels a chunk, 8 a lane
constexpr int NCELL = (GT + 1) * (GT + 1);  // sample cells whose taps reach the tile
constexpr int HB = 4;                       // hits loaded at once

struct Region {
  int i0, i1, j0, j1;  // empty when i0 > i1 or j0 > j1
  bool finite;         // false for a NaN or infinite theta
};

__device__ __forceinline__ void clamp_range(double lo, double hi, int n, int* a, int* b) {
  lo = fmax(lo, 0.0);
  hi = fmin(hi, (double)(n - 1));
  if (lo <= hi) {
    *a = (int)lo;
    *b = (int)hi;
  } else {
    *a = 0;
    *b = -1;
  }
}

// The output pixels whose tap can land in the tile at (tx0, ty0): their sample
// cells lie in [tx0 - 1, tx0 + GT - 1] x [ty0 - 1, ty0 + GT - 1], so their sample
// points in ix in [tx0 - 1, tx0 + GT) (iy likewise), and their points before the
// grid's rounding within ex (ey) of that. With J = j + 0.5 - W/2,
// I = i + 0.5 - H/2, X = ix + 0.5 - kx, Y = iy + 0.5 - ky, kx = (W/2)(t02 + 1),
// ky = (H/2)(t12 + 1), the forward maps [J; I] to [X; Y] by
// [[t00, t01 W/H], [t10 H/W, t11]] (the rounded theta); the region is the bounding
// box of the preimage of the widened square, one pixel wider each way for the f64
// arithmetic, clamped to the map. ex, ey: the grid's rounding to T (half an ulp of
// |gx| < 2: 2^-8 in bf16, none in f32) times W/2 or H/2, plus 2^-12 of W/2 or H/2
// for the f32 error of the forward's arithmetic (below 2^-20 of W). Every f64
// operation is rounded explicitly (no contraction); tests/test_torch_warp_gather.py
// `gather_regions` mirrors it on the CPU.
template <typename T>
__device__ Region tile_region(const Theta& th, int H, int W, int tx0, int ty0) {
  const double a = th.t00, d = th.t11;
  const double b = __ddiv_rn(__dmul_rn((double)th.t01, (double)W), (double)H);
  const double c = __ddiv_rn(__dmul_rn((double)th.t10, (double)H), (double)W);
  const double det = __dsub_rn(__dmul_rn(a, d), __dmul_rn(b, c));
  const double p00 = __ddiv_rn(d, det), p01 = __ddiv_rn(-b, det);
  const double p10 = __ddiv_rn(-c, det), p11 = __ddiv_rn(a, det);
  const double kx = __dmul_rn(0.5 * W, __dadd_rn((double)th.t02, 1.0));
  const double ky = __dmul_rn(0.5 * H, __dadd_rn((double)th.t12, 1.0));
  const double hu = sizeof(T) == 2 ? 0x1p-8 : 0.0;
  const double hx = 0.5 * (GT + 1) + 0.5 * W * (hu + 0x1p-12);  // exact
  const double hy = 0.5 * (GT + 1) + 0.5 * H * (hu + 0x1p-12);
  const double xc = __dsub_rn((double)(tx0 + GT / 2), kx);
  const double yc = __dsub_rn((double)(ty0 + GT / 2), ky);
  const double jc = __dadd_rn(__dadd_rn(__dmul_rn(p00, xc), __dmul_rn(p01, yc)), 0.5 * W - 0.5);
  const double ic = __dadd_rn(__dadd_rn(__dmul_rn(p10, xc), __dmul_rn(p11, yc)), 0.5 * H - 0.5);
  const double rj = __dadd_rn(__dmul_rn(fabs(p00), hx), __dmul_rn(fabs(p01), hy));
  const double ri = __dadd_rn(__dmul_rn(fabs(p10), hx), __dmul_rn(fabs(p11), hy));
  Region r;
  r.finite = isfinite(jc) && isfinite(ic) && isfinite(rj) && isfinite(ri);
  clamp_range(ceil(__dsub_rn(jc, rj)) - 1.0, floor(__dadd_rn(jc, rj)) + 1.0, W, &r.j0, &r.j1);
  clamp_range(ceil(__dsub_rn(ic, ri)) - 1.0, floor(__dadd_rn(ic, ri)) + 1.0, H, &r.i0, &r.i1);
  return r;
}

// 8 channels from c as loaded (16 bytes of bf16, 32 of f32; those below C, as f32,
// unless VEC), and as f32
struct Raw8 {
  uint4 a, b;
};

template <typename T, bool VEC>
__device__ __forceinline__ Raw8 load_raw(const T* __restrict__ p, int c, int C) {
  Raw8 r;
  if constexpr (VEC && sizeof(T) == 2) {
    r.a = *reinterpret_cast<const uint4*>(p);
    r.b = r.a;
  } else if constexpr (VEC) {
    r.a = reinterpret_cast<const uint4*>(p)[0];
    r.b = reinterpret_cast<const uint4*>(p)[1];
  } else {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c + q < C ? to_float(p[q]) : 0.0f;
    r.a = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                     __float_as_uint(v[3]));
    r.b = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                     __float_as_uint(v[7]));
  }
  return r;
}

template <typename T, bool VEC>
__device__ __forceinline__ void unpack(const Raw8& r, float v[8]) {
  if constexpr (VEC && sizeof(T) == 2) {
    const unsigned w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float(r.a.x); v[1] = __uint_as_float(r.a.y);
    v[2] = __uint_as_float(r.a.z); v[3] = __uint_as_float(r.a.w);
    v[4] = __uint_as_float(r.b.x); v[5] = __uint_as_float(r.b.y);
    v[6] = __uint_as_float(r.b.z); v[7] = __uint_as_float(r.b.w);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store8(T* __restrict__ p, int c, int C, const float v[8]) {
  if constexpr (VEC && sizeof(T) == 2) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * q]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * q + 1]));
      w[q] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (c + q < C) p[q] = from_float<T>(v[q]);
  }
}

// The most output pixels a tile's region holds for any finite theta of an H x W map
// (the staging a block needs): the region is at most 2 r + 3 wide, r the half-widths
// of tile_region, since the rounded |cos|, |sin| are at most 1 and the map's
// determinant cos^2 + sin^2 after rounding at least (1 - 2^-8)^2 (a factor 1 + 2^-8
// covers the f64 rounding).
inline long long gather_entries(int H, int W, bool bf16) {
  const double hu = bf16 ? 0x1p-8 : 0.0;
  const double ex = 0.5 * W * (hu + 0x1p-12), ey = 0.5 * H * (hu + 0x1p-12);
  const double s = (1.0 + 0x1p-8) / ((1.0 - 0x1p-8) * (1.0 - 0x1p-8));
  const double hx = 0.5 * (GT + 1) + ex, hy = 0.5 * (GT + 1) + ey;
  const double rj = s * (hx + hy * W / H), ri = s * (hx * H / W + hy);
  return (long long)ceil(2.0 * rj + 3.0) * (long long)ceil(2.0 * ri + 3.0);
}

// A block: one 16 x 16 tile of input pixels of map b. cap: the most region entries
// (output pixels) a block stages, gather_entries(H, W) (the wrapper's bound).
template <typename T, bool VEC>
__global__ void __launch_bounds__(GTHREADS)
warp_gather_kernel(const T* __restrict__ g, const float* __restrict__ pose,
                   T* __restrict__ dx, int H, int W, int C, float inv_extent_x,
                   float inv_extent_y, float inv_w, float inv_h, int tiles_w,
                   int tiles_per_map, int cap) {
  extern __shared__ int4 smem4[];
  int4* s_ent = smem4;        // [cap] region entries: cell (or -1), row, wx1, wy1
  int4* s_list = smem4 + cap;  // [cap] the entries of each cell: row, wx1, wy1
  __shared__ int s_start[NCELL + 1], s_cur[NCELL];
  __shared__ Theta s_th;
  __shared__ Region s_reg;
  const int b = blockIdx.x / tiles_per_map;
  const int tile = blockIdx.x - b * tiles_per_map;
  const int ty0 = (tile / tiles_w) * GT, tx0 = (tile - (tile / tiles_w) * tiles_w) * GT;
  if (threadIdx.x == 0) {
    s_th = make_theta<T>(pose, b, inv_extent_x, inv_extent_y);
    s_reg = tile_region<T>(s_th, H, W, tx0, ty0);
  }
  for (int c = threadIdx.x; c < NCELL; c += GTHREADS) s_cur[c] = 0;
  __syncthreads();
  const Theta th = s_th;
  const Region reg = s_reg;
  const int lg = threadIdx.x & (GG - 1);
  const int64_t map0 = (int64_t)b * H * W;
  const int rw = reg.j1 - reg.j0 + 1;
  const long long area =
      reg.i0 <= reg.i1 && reg.j0 <= reg.j1 ? (long long)(reg.i1 - reg.i0 + 1) * rw : 0;
  if (!reg.finite || area > cap) {
    // no finite sums to stage: NaN in every value of the tile
    float nan8[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) nan8[u] = __int_as_float(0x7fc00000);
    for (int m = threadIdx.x / GG; m < GT * GT; m += GTHREADS / GG) {
      const int py = ty0 + m / GT, px = tx0 + m % GT;
      if (py >= H || px >= W) continue;
      for (int cl = lg * 8; cl < C; cl += GCH)
        store8<T, VEC>(dx + (map0 + (int64_t)py * W + px) * C + cl, cl, C, nan8);
    }
    return;
  }

  // 1. each region entry's sample cell (if its taps reach the tile) and weights,
  //    exactly as the forward computes them; count the entries of each cell
  for (int e = threadIdx.x; e < area; e += GTHREADS) {
    const int i = reg.i0 + e / rw, j = reg.j0 + e % rw;
    float ix, iy;
    sample_point<T>(th, i, j, inv_w, inv_h, H, W, &ix, &iy);
    const float x0f = floorf(ix), y0f = floorf(iy);
    const float cx = x0f - (float)(tx0 - 1), cy = y0f - (float)(ty0 - 1);
    int cell = -1;
    if (cx >= 0.0f && cx <= (float)GT && cy >= 0.0f && cy <= (float)GT) {
      cell = (int)cy * (GT + 1) + (int)cx;
      atomicAdd(&s_cur[cell], 1);
    }
    s_ent[e] = make_int4(cell, i * W + j, __float_as_int(__fadd_rn(ix, -x0f)),
                         __float_as_int(__fadd_rn(iy, -y0f)));
  }
  __syncthreads();

  // 2. the cells' starts (one warp scans the counts)
  if (threadIdx.x < 32) {
    constexpr int PER = (NCELL + 31) / 32;
    const int lane = threadIdx.x;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = lane * PER + q;
      sum += c < NCELL ? s_cur[c] : 0;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += n;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = lane * PER + q;
      if (c < NCELL) {
        const int n = s_cur[c];
        s_start[c] = run;
        s_cur[c] = run;
        run += n;
      }
    }
    if (lane == 31) s_start[NCELL] = incl;
  }
  __syncthreads();

  // 3. the entries into their cells' lists, then each list in ascending row
  //    (ascending output pixel)
  for (int e = threadIdx.x; e < area; e += GTHREADS) {
    const int4 en = s_ent[e];
    if (en.x >= 0) s_list[atomicAdd(&s_cur[en.x], 1)] = make_int4(en.y, en.z, en.w, 0);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NCELL; c += GTHREADS) {
    const int lo = s_start[c], hi = s_start[c + 1];
    for (int x = lo + 1; x < hi; ++x) {
      const int4 v = s_list[x];
      int y = x - 1;
      while (y >= lo && s_list[y].x > v.x) {
        s_list[y + 1] = s_list[y];
        --y;
      }
      s_list[y + 1] = v;
    }
  }
  __syncthreads();

  // 4. a group of 8 lanes an input pixel p: the lists of cells p - (k & 1, k >> 1),
  //    k = 0..3, in that order, HB hits' rows loaded at once, summed in order
  for (int m = threadIdx.x / GG; m < GT * GT; m += GTHREADS / GG) {
    const int py = ty0 + m / GT, px = tx0 + m % GT;
    if (py >= H || px >= W) continue;
    const int c0 = (m / GT + 1) * (GT + 1) + m % GT + 1;  // the cell of tap 0
    const int s0 = s_start[c0], s1 = s_start[c0 - 1], s2 = s_start[c0 - GT - 1],
              s3 = s_start[c0 - GT - 2];
    const int n0 = s_start[c0 + 1] - s0, n1 = s_start[c0] - s1;
    const int n2 = s_start[c0 - GT] - s2, n3 = s_start[c0 - GT - 1] - s3;
    const int nh = n0 + n1 + n2 + n3;
    for (int cc = 0; cc < C; cc += GCH) {
      const int cl = cc + lg * 8;
      float acc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = 0.0f;
      for (int h0 = 0; h0 < nh; h0 += HB) {
        Raw8 raw[HB];
        float wk[HB];
#pragma unroll
        for (int q = 0; q < HB; ++q) {
          const int h = h0 + q;
          wk[q] = 0.0f;
          if (h < nh) {
            const int k = h < n0 ? 0 : h < n0 + n1 ? 1 : h < n0 + n1 + n2 ? 2 : 3;
            const int pos = k == 0 ? s0 + h
                          : k == 1 ? s1 + h - n0
                          : k == 2 ? s2 + h - n0 - n1
                                   : s3 + h - n0 - n1 - n2;
            const int4 t = s_list[pos];
            const float sx = __int_as_float(t.y), sy = __int_as_float(t.z);
            const float wx = (k & 1) ? sx : __fadd_rn(1.0f, -sx);
            const float wy = (k >> 1) ? sy : __fadd_rn(1.0f, -sy);
            wk[q] = __fmul_rn(wy, wx);
            if (cl < C) raw[q] = load_raw<T, VEC>(g + (map0 + t.x) * C + cl, cl, C);
          }
        }
#pragma unroll
        for (int q = 0; q < HB; ++q) {
          if (h0 + q < nh && cl < C) {
            float v[8];
            unpack<T, VEC>(raw[q], v);
#pragma unroll
            for (int u = 0; u < 8; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(v[u], wk[q]));
          }
        }
      }
      if (cl < C) store8<T, VEC>(dx + (map0 + (int64_t)py * W + px) * C + cl, cl, C, acc);
    }
  }
}

// theta of each map as the kernels compute it: (B, 6) in T
template <typename T>
__global__ void theta_kernel(const float* __restrict__ pose, T* __restrict__ theta, int B,
                             float inv_extent_x, float inv_extent_y) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Theta th = make_theta<T>(pose, b, inv_extent_x, inv_extent_y);
  const float v[6] = {th.t00, th.t01, th.t02, th.t10, th.t11, th.t12};
  for (int k = 0; k < 6; ++k) theta[(int64_t)b * 6 + k] = from_float<T>(v[k]);
}

template <typename T, bool VEC>
int launch_gather(const void* g, const void* pose, void* dx, int B, int H, int W, int C,
                  float iex, float iey, float inv_w, float inv_h, int cap, cudaStream_t st) {
  const int tiles_w = (W + GT - 1) / GT, tiles_h = (H + GT - 1) / GT;
  const long long blocks = (long long)B * tiles_w * tiles_h;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)cap * 2 * sizeof(int4);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_gather_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GATHER_MAX_ENTRIES * 2 * (int)sizeof(int4));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  warp_gather_kernel<T, VEC><<<(unsigned)blocks, GTHREADS, shared, st>>>(
      (const T*)g, (const float*)pose, (T*)dx, H, W, C, iex, iey, inv_w, inv_h, tiles_w,
      tiles_w * tiles_h, cap);
  return (int)cudaGetLastError();
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

// pose: (B, 6) float32; theta: (B, 2, 3) float32 or bfloat16 (is_bf16), written with
// the theta that fiery_bev_warp and fiery_bev_warp_backward compute for each map.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_bev_warp_theta(const void* pose, void* theta, int B, float inv_extent_x,
                                    float inv_extent_y, int is_bf16, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((B + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    theta_kernel<__nv_bfloat16><<<blocks, 128, 0, st>>>(
        (const float*)pose, (__nv_bfloat16*)theta, B, inv_extent_x, inv_extent_y);
  } else {
    theta_kernel<float><<<blocks, 128, 0, st>>>((const float*)pose, (float*)theta, B,
                                                inv_extent_x, inv_extent_y);
  }
  return (int)cudaGetLastError();
}

// The output pixels a block of fiery_bev_warp_backward stages for an H x W map (its
// cap), or 0 when that is more than the kernel stages (GATHER_MAX_ENTRIES).
extern "C" int fiery_bev_warp_gather_entries(int H, int W, int is_bf16) {
  if (H < 1 || W < 1) return 0;
  const long long n = gather_entries(H, W, is_bf16 != 0);
  return n <= GATHER_MAX_ENTRIES ? (int)n : 0;
}

// g: (B, H, W, C) contiguous output gradient, float32 or bfloat16 (the dtype of the
// forward's x, which sets where theta and the grid were rounded); pose: (B, 6)
// float32; dx: (B, H, W, C) in g's dtype, written whole (no zeroing). vec: 1 when
// C % 8 == 0 and g and dx are 16-byte aligned. cap:
// fiery_bev_warp_gather_entries(H, W, is_bf16), nonzero. Any C. Returns
// cudaGetLastError() after the launch.
extern "C" int fiery_bev_warp_backward(const void* g, const void* pose, void* dx, int B,
                                       int H, int W, int C, float inv_extent_x,
                                       float inv_extent_y, float inv_w, float inv_h,
                                       int is_bf16, int vec, int cap, void* stream) {
  if ((long long)B * H * W * C == 0) return (int)cudaSuccess;
  if (cap < 1 || cap > GATHER_MAX_ENTRIES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return vec ? launch_gather<__nv_bfloat16, true>(g, pose, dx, B, H, W, C, inv_extent_x,
                                                   inv_extent_y, inv_w, inv_h, cap, st)
               : launch_gather<__nv_bfloat16, false>(g, pose, dx, B, H, W, C, inv_extent_x,
                                                    inv_extent_y, inv_w, inv_h, cap, st);
  }
  return vec ? launch_gather<float, true>(g, pose, dx, B, H, W, C, inv_extent_x, inv_extent_y,
                                          inv_w, inv_h, cap, st)
             : launch_gather<float, false>(g, pose, dx, B, H, W, C, inv_extent_x, inv_extent_y,
                                           inv_w, inv_h, cap, st);
}
