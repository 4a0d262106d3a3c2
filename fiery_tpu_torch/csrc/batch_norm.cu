// batch_norm: BatchNorm over the channels of channels-last activations, with the
// epilogue that follows it fused in; forward (eval and training) and backward.
//
// Replaces: fiery_tpu/models/layers.py `_BNCore.__call__` with `_apply_post` (the
// hand-rolled BN core with its packed-lane epilogue), reached through every
// `BatchNorm(post=...)` of the model: the encoder, the temporal model, the two
// distributions, the SpatialGRU's state conv, the residual blocks and the decoder.
//
// Computes, over x viewed as M rows of C channels (a channels-last tensor):
//   training statistics: mean = S1 / M, mean2 = S2 / M rounded to f32, with S1, S2
//     the f64 sums of x and x^2 per channel; var = max(mean2 - mean^2, 0) in f32;
//     running <- (1 - m) running + m batch (the biased variance); clamp = the
//     derivative of the max (1 above 0, 1/2 at 0, 0 below);
//   eval: mean, var = the running statistics;
//   mul = w / sqrt(var + eps) (f32), then mean, mul and bias rounded to T;
//   z = ((x - mean) * mul) + bias and y = post(z, r), every operation rounded to T
//     (the rounding of the JAX package's bf16 operations on XLA's CPU), with
//     sigmoid(z) = 1 / (1 + exp(-z)) for swish;
//   backward: dz = the epilogue's gradient at the recomputed z (f32), written out as
//     the residual's gradient for add_relu; S_dz = sum dz, S_dzx = sum dz * xhat in
//     f64 (xhat = (x - mean) * rstd, rstd = 1 / sqrt(var + eps)); dbias = S_dz,
//     dweight = S_dzx; dx = w rstd ((dz - S_dz / M) - xhat clamp S_dzx / M) in
//     training, w rstd dz in eval.
// Every f32 operation is an explicitly rounded intrinsic (no FMA contraction) in
// the order of the plain PyTorch version in ops/batch_norm.py.
//
// Bound on an H100: bytes. A training forward reads x twice (statistics, apply)
// and writes y once; eval reads x (and the residual) once; the backward reads dy
// and x twice and writes dx (and dres). dy may be a channel slice of wider rows
// (the gradient of a concat), read in place. At the largest call of a training step
// (the encoder's first expanded layer, 54 images x 112 x 240 x 144 bf16, 418 MB)
// that is ~0.37 ms forward and ~0.62 ms backward at 3.35 TB/s; the ~10-20 flops
// per value are far below the rate.
//
// Design: a block's lanes are G = max(1, 256 / C) whole rows (G C <= 1024 lanes,
// one per thread), so each thread keeps one channel, computes that channel's
// constants once, and neighbouring threads touch neighbouring addresses. The
// reductions walk the row groups with a fixed grid (a grid stride), sum each lane
// in f64 in registers, then the G lanes of a channel in shared memory in a fixed
// order into one partial per block; a second small kernel sums the partials of
// each channel in a fixed order, one warp per channel. No atomics, so two runs
// give the same bits. The elementwise passes use the same number of blocks, each
// over a run of consecutive row groups, four loaded before any is stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Post { kNone = 0, kRelu = 1, kSwish = 2, kAdd = 3, kAddRelu = 4, kReluAdd = 5 };
constexpr int kUnroll = 4;        // row groups a thread loads before it uses them
constexpr int kMaxLanes = 1024;   // G C, one thread each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to T and back (identity for f32)
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_float(from_float<T>(v)); }

// The per-channel constants of the forward, rounded to T as _BNCore casts them.
struct Consts {
  float mean, rstd, mean_t, mul_t, bias_t, mul;
};

template <typename T>
__device__ __forceinline__ Consts channel_consts(const float* mean, const float* var,
                                                 const float* w, const float* bias,
                                                 float eps, int c) {
  Consts k;
  k.mean = mean[c];
  k.rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c], eps)));
  k.mul = __fmul_rn(w[c], k.rstd);
  k.mean_t = rnd<T>(k.mean);
  k.mul_t = rnd<T>(k.mul);
  k.bias_t = rnd<T>(bias[c]);
  return k;
}

template <typename T>
__device__ __forceinline__ float normalise(float x, const Consts& k) {
  const float a = rnd<T>(__fsub_rn(x, k.mean_t));
  const float b = rnd<T>(__fmul_rn(a, k.mul_t));
  return rnd<T>(__fadd_rn(b, k.bias_t));
}

template <typename T>
__device__ __forceinline__ float epilogue(float z, float r, int post) {
  switch (post) {
    case kRelu: return fmaxf(z, 0.0f);
    case kSwish: {
      const float e = rnd<T>(expf(-z));
      const float s = rnd<T>(__fdiv_rn(1.0f, rnd<T>(__fadd_rn(1.0f, e))));
      return rnd<T>(__fmul_rn(z, s));
    }
    case kAdd: return rnd<T>(__fadd_rn(z, r));
    case kAddRelu: return fmaxf(rnd<T>(__fadd_rn(z, r)), 0.0f);
    case kReluAdd: return rnd<T>(__fadd_rn(fmaxf(z, 0.0f), r));
    default: return z;
  }
}

// The gradient before the epilogue, at the forward's z (f32).
__device__ __forceinline__ float epilogue_grad(float dy, float z, float r, int post) {
  switch (post) {
    case kRelu:
    case kReluAdd: return z > 0.0f ? dy : 0.0f;
    case kSwish: {
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      return __fmul_rn(dy, __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s)))));
    }
    case kAddRelu: return __fadd_rn(z, r) > 0.0f ? dy : 0.0f;
    default: return dy;
  }
}

__device__ __forceinline__ bool has_residual(int post) {
  return post == kAdd || post == kAddRelu || post == kReluAdd;
}

// Sum the G lanes of each channel in shared memory (fixed order) and write the
// block's partial sums: partial[block][0][c] = a, partial[block][1][c] = b.
__device__ __forceinline__ void write_partial(double a, double b, int W, int C,
                                              double* __restrict__ partial) {
  __shared__ double sa[kMaxLanes], sb[kMaxLanes];
  const int t = threadIdx.x;
  if (t < W) { sa[t] = a; sb[t] = b; }
  __syncthreads();
  if (t < C) {
    double ta = 0.0, tb = 0.0;
    for (int l = t; l < W; l += C) { ta += sa[l]; tb += sb[l]; }
    partial[(size_t)blockIdx.x * 2 * C + t] = ta;
    partial[((size_t)blockIdx.x * 2 + 1) * C + t] = tb;
  }
}

// Training statistics, pass 1: per block and channel, the f64 sums of x and x^2.
template <typename T>
__global__ void stats_kernel(const T* __restrict__ x, long long total, int C, int W,
                             double* __restrict__ partial) {
  const int t = threadIdx.x;
  double s1 = 0.0, s2 = 0.0;
  if (t < W) {
    const long long step = (long long)gridDim.x * W;
    long long off = (long long)blockIdx.x * W + t;
    for (; off + (kUnroll - 1) * step < total; off += kUnroll * step) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = to_float(x[off + u * step]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) { s1 += (double)v[u]; s2 += (double)v[u] * v[u]; }
    }
    for (; off < total; off += step) {
      const float v = to_float(x[off]);
      s1 += (double)v;
      s2 += (double)v * v;
    }
  }
  write_partial(s1, s2, W, C, partial);
}

// The blocks' partial sums of channel c, one warp per channel: lane l adds blocks
// l, l + 32, ... in order, then a fixed shuffle tree; valid in lane 0, and the
// same bits on every run.
__device__ __forceinline__ void sum_partials(const double* __restrict__ partial, int blocks,
                                             int C, int c, double* a, double* b) {
  const int lane = threadIdx.x & 31;
  double sa = 0.0, sb = 0.0;
  for (int k = lane; k < blocks; k += 32) {
    sa += partial[(size_t)2 * k * C + c];
    sb += partial[(size_t)(2 * k + 1) * C + c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sa += __shfl_down_sync(0xffffffffu, sa, o);
    sb += __shfl_down_sync(0xffffffffu, sb, o);
  }
  *a = sa;
  *b = sb;
}

constexpr int kFinalizeWarps = 8;   // channels per finalize block

// Training statistics, pass 2: one warp per channel sums the partials; writes
// mean, var and clamp, and updates the running statistics.
__global__ void stats_finalize_kernel(const double* __restrict__ partial, int blocks,
                                      long long M, int C, float* __restrict__ mean,
                                      float* __restrict__ var, float* __restrict__ clamp,
                                      float* __restrict__ running_mean,
                                      float* __restrict__ running_var, float momentum,
                                      float one_minus_momentum) {
  const int c = blockIdx.x * kFinalizeWarps + threadIdx.x / 32;
  if (c >= C) return;
  double a, b;
  sum_partials(partial, blocks, C, c, &a, &b);
  if ((threadIdx.x & 31) != 0) return;
  const float m = (float)(a / (double)M);
  const float m2 = (float)(b / (double)M);
  const float raw = __fsub_rn(m2, __fmul_rn(m, m));
  const float v = fmaxf(raw, 0.0f);
  mean[c] = m;
  var[c] = v;
  clamp[c] = raw > 0.0f ? 1.0f : (raw == 0.0f ? 0.5f : 0.0f);
  running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], one_minus_momentum),
                              __fmul_rn(m, momentum));
  running_var[c] = __fadd_rn(__fmul_rn(running_var[c], one_minus_momentum),
                             __fmul_rn(v, momentum));
}

// y = post(normalise(x), r): block b takes row groups [b * per_block, (b + 1) *
// per_block), kUnroll at a time, loading them before it stores any.
template <typename T>
__global__ void apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                             T* __restrict__ y, const float* __restrict__ mean,
                             const float* __restrict__ var, const float* __restrict__ w,
                             const float* __restrict__ bias, float eps, long long total,
                             int C, int W, int per_block, int post) {
  const int t = threadIdx.x;
  if (t >= W) return;
  const Consts k = channel_consts<T>(mean, var, w, bias, eps, t % C);
  const bool with_res = has_residual(post);
  const long long first = (long long)blockIdx.x * per_block * W + t;
  for (int g = 0; g < per_block; g += kUnroll) {
    const long long base = first + (long long)g * W;
    if (base >= total) break;
    float xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)u * W;
      xv[u] = off < total ? to_float(x[off]) : 0.0f;
      rv[u] = with_res && off < total ? to_float(res[off]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)u * W;
      if (off < total) y[off] = from_float<T>(epilogue<T>(normalise<T>(xv[u], k), rv[u], post));
    }
  }
}

// Backward, pass 1: dz per value (written as dres for add_relu), and per block and
// channel the f64 sums of dz and dz * xhat. Row m of dy starts at m * dy_rs (dy
// may be a channel slice of wider rows, as the gradient of a concat is).
template <typename T>
__global__ void backward_reduce_kernel(const T* __restrict__ dy, long long dy_rs,
                                       const T* __restrict__ x, const T* __restrict__ res,
                                       T* __restrict__ dres, const float* __restrict__ mean,
                                       const float* __restrict__ var,
                                       const float* __restrict__ w,
                                       const float* __restrict__ bias, float eps,
                                       long long M, int C, int G, int post,
                                       double* __restrict__ partial) {
  const int t = threadIdx.x, W = G * C;
  double s1 = 0.0, s2 = 0.0;
  if (t < W) {
    const int c = t % C, r = t / C;
    const Consts k = channel_consts<T>(mean, var, w, bias, eps, c);
    const bool with_res = post == kAddRelu;
    for (long long g0 = blockIdx.x; g0 * G < M; g0 += (long long)kUnroll * gridDim.x) {
      float xv[kUnroll], dv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long m = (g0 + (long long)u * gridDim.x) * G + r;
        const bool in = m < M;
        xv[u] = in ? to_float(x[m * C + c]) : 0.0f;
        dv[u] = in ? to_float(dy[m * dy_rs + c]) : 0.0f;
        rv[u] = with_res && in ? to_float(res[m * C + c]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long m = (g0 + (long long)u * gridDim.x) * G + r;
        if (m >= M) break;
        const float dz = epilogue_grad(dv[u], normalise<T>(xv[u], k), rv[u], post);
        if (with_res) dres[m * C + c] = from_float<T>(dz);
        const float xhat = __fmul_rn(__fsub_rn(xv[u], k.mean), k.rstd);
        s1 += (double)dz;
        s2 += (double)dz * (double)xhat;
      }
    }
  }
  write_partial(s1, s2, W, C, partial);
}

// Backward, pass 2: dweight, dbias and the two coefficients of dx, one warp per
// channel.
__global__ void backward_finalize_kernel(const double* __restrict__ partial, int blocks,
                                         long long M, int C, const float* __restrict__ clamp,
                                         int training, float* __restrict__ dparams) {
  const int c = blockIdx.x * kFinalizeWarps + threadIdx.x / 32;
  if (c >= C) return;
  double a, b;
  sum_partials(partial, blocks, C, c, &a, &b);
  if ((threadIdx.x & 31) != 0) return;
  dparams[c] = (float)b;          // dweight
  dparams[C + c] = (float)a;      // dbias
  dparams[2 * C + c] = training ? (float)(a / (double)M) : 0.0f;
  dparams[3 * C + c] = training ? __fmul_rn(clamp[c], (float)(b / (double)M)) : 0.0f;
}

// Backward, pass 3: dx; block b takes row groups [b * per_block, (b + 1) * per_block).
template <typename T>
__global__ void backward_apply_kernel(const T* __restrict__ dy, long long dy_rs,
                                      const T* __restrict__ x, const T* __restrict__ res,
                                      T* __restrict__ dx, const float* __restrict__ mean,
                                      const float* __restrict__ var,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ dparams, float eps,
                                      long long M, int C, int G, int per_block, int post,
                                      int training) {
  const int t = threadIdx.x;
  if (t >= G * C) return;
  const int c = t % C, r = t / C;
  const Consts k = channel_consts<T>(mean, var, w, bias, eps, c);
  const float a = dparams[2 * C + c], b = dparams[3 * C + c];
  const bool with_res = post == kAddRelu;
  const long long first = (long long)blockIdx.x * per_block;
  for (int gg = 0; gg < per_block; gg += kUnroll) {
    if ((first + gg) * G >= M) break;
    float xv[kUnroll], dv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long m = (first + gg + u) * G + r;
      const bool in = m < M;
      xv[u] = in ? to_float(x[m * C + c]) : 0.0f;
      dv[u] = in ? to_float(dy[m * dy_rs + c]) : 0.0f;
      rv[u] = with_res && in ? to_float(res[m * C + c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long m = (first + gg + u) * G + r;
      if (m >= M) continue;
      const float dz = epilogue_grad(dv[u], normalise<T>(xv[u], k), rv[u], post);
      float gx;
      if (training) {
        const float xhat = __fmul_rn(__fsub_rn(xv[u], k.mean), k.rstd);
        gx = __fmul_rn(k.mul, __fsub_rn(__fsub_rn(dz, a), __fmul_rn(xhat, b)));
      } else {
        gx = __fmul_rn(k.mul, dz);
      }
      dx[m * C + c] = from_float<T>(gx);
    }
  }
}

struct Grid {
  int W, threads, per_block;
  long long total;
  unsigned apply_blocks;
};

// The elementwise passes' grid: about `blocks` blocks (the grid that fills the
// card, as the reductions use it), each taking a run of consecutive row groups,
// a multiple of kUnroll.
Grid grid_of(long long M, int C, int G, int blocks) {
  Grid g;
  g.W = G * C;
  g.threads = (g.W + 31) / 32 * 32;
  g.total = M * C;
  const long long groups = (M + G - 1) / G;
  const long long per_block = (groups + blocks - 1) / blocks;
  g.per_block = (int)((per_block + kUnroll - 1) / kUnroll * kUnroll);
  g.apply_blocks = (unsigned)((groups + g.per_block - 1) / g.per_block);
  return g;
}

template <typename T>
int forward(const void* x, const void* res, void* y, float* mean, float* var, float* clamp,
            float* running_mean, float* running_var, const float* w, const float* bias,
            double* partial, long long M, int C, int G, int blocks, float eps,
            float momentum, int training, int post, cudaStream_t st) {
  const Grid g = grid_of(M, C, G, blocks);
  if (training) {
    stats_kernel<T><<<blocks, g.threads, 0, st>>>((const T*)x, g.total, C, g.W, partial);
    stats_finalize_kernel<<<(C + kFinalizeWarps - 1) / kFinalizeWarps, 32 * kFinalizeWarps, 0,
                            st>>>(
        partial, blocks, M, C, mean, var, clamp, running_mean, running_var, momentum,
        (float)(1.0 - (double)momentum));
  }
  apply_kernel<T><<<g.apply_blocks, g.threads, 0, st>>>(
      (const T*)x, (const T*)res, (T*)y, mean, var, w, bias, eps, g.total, C, g.W,
      g.per_block, post);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* dy, long long dy_rs, const void* x, const void* res, void* dx,
             void* dres, const float* mean, const float* var, const float* clamp,
             const float* w, const float* bias, float* dparams, double* partial, long long M,
             int C, int G, int blocks, float eps, int training, int post, cudaStream_t st) {
  const Grid g = grid_of(M, C, G, blocks);
  backward_reduce_kernel<T><<<blocks, g.threads, 0, st>>>(
      (const T*)dy, dy_rs, (const T*)x, (const T*)res, (T*)dres, mean, var, w, bias, eps, M,
      C, G, post, partial);
  backward_finalize_kernel<<<(C + kFinalizeWarps - 1) / kFinalizeWarps, 32 * kFinalizeWarps,
                             0, st>>>(partial, blocks, M, C, clamp, training, dparams);
  backward_apply_kernel<T><<<g.apply_blocks, g.threads, 0, st>>>(
      (const T*)dy, dy_rs, (const T*)x, (const T*)res, (T*)dx, mean, var, w, bias, dparams,
      eps, M, C, G, g.per_block, post, training);
  return (int)cudaGetLastError();
}

}  // namespace

// x, res, y: M rows of C channels, contiguous (res may be null), float32 or bfloat16;
// mean, var, clamp: (C,) f32, written in training (clamp may be null in eval), read
// in eval (the running statistics); running_mean, running_var: (C,) f32, updated in
// training; w, bias: (C,) f32; partial: (blocks, 2, C) f64 scratch (training);
// G rows per block row group (G C <= 1024); blocks: the grid of each pass;
// post: 0 none, 1 relu, 2 swish, 3 add, 4 add_relu, 5 relu_add.
// Returns cudaGetLastError() after the launches.
extern "C" int fiery_batch_norm_forward(const void* x, const void* res, void* y, float* mean,
                                        float* var, float* clamp, float* running_mean,
                                        float* running_var, const float* w,
                                        const float* bias, double* partial, long long M,
                                        int C, int G, int blocks, float eps, float momentum,
                                        int training, int post, int is_bf16, void* stream) {
  if (M == 0 || C == 0) return (int)cudaSuccess;
  if (G * C > kMaxLanes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
      ? forward<__nv_bfloat16>(x, res, y, mean, var, clamp, running_mean, running_var, w,
                               bias, partial, M, C, G, blocks, eps, momentum, training,
                               post, st)
      : forward<float>(x, res, y, mean, var, clamp, running_mean, running_var, w, bias,
                       partial, M, C, G, blocks, eps, momentum, training, post, st);
}

// dy: M rows of C channels, row m at m * dy_rs (dy_rs >= C); x, res, dx, dres: M
// rows of C channels, contiguous (res and dres for add_relu only, else null);
// mean, var: the statistics the forward used; clamp: (C,) f32 (training);
// dparams: (4, C) f32 out: dweight, dbias and two coefficients of dx; partial:
// (blocks, 2, C) f64 scratch. Returns cudaGetLastError() after the launches.
extern "C" int fiery_batch_norm_backward(const void* dy, long long dy_rs, const void* x,
                                         const void* res, void* dx, void* dres,
                                         const float* mean, const float* var,
                                         const float* clamp, const float* w,
                                         const float* bias, float* dparams, double* partial,
                                         long long M, int C, int G, int blocks, float eps,
                                         int training, int post, int is_bf16, void* stream) {
  if (M == 0 || C == 0) return (int)cudaSuccess;
  if (G * C > kMaxLanes || dy_rs < C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
      ? backward<__nv_bfloat16>(dy, dy_rs, x, res, dx, dres, mean, var, clamp, w, bias,
                                dparams, partial, M, C, G, blocks, eps, training, post, st)
      : backward<float>(dy, dy_rs, x, res, dx, dres, mean, var, clamp, w, bias, dparams,
                        partial, M, C, G, blocks, eps, training, post, st);
}
