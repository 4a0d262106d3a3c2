// spatial_gru: the gate arithmetic of one SpatialGRU step around its convolutions,
// forward (two launches a step) and backward (two launches a step).
//
// Replaces: the gate math of fiery_tpu/models/temporal_layers.py
// `SpatialGRU.__call__` (sigmoid of the fused gate conv, the reset-gated concat,
// the state update and the stack of the states), which XLA fuses around the convs:
//   fiery_gru_reset_concat:  cat[b, p, :] = [x_t, (1 - r) h],  r = sigmoid(r_pre),
//     the input of the state conv, written directly (no concat pass);
//   fiery_gru_state_update:  out[b, t, p, c] = (1 - u) h + u h_tilde,
//     u = sigmoid(u_pre), written into slot t of the sequence output (no stack);
//   fiery_gru_reset_concat_backward:  from g = dcat's state half,
//     dr_pre = (-(g h)) (r (1 - r)),  dh = g (1 - r);
//   fiery_gru_state_update_backward:  from g = dout,
//     du_pre = (g (h_tilde - h)) (u (1 - u)),  dh = g (1 - u),  dh_tilde = g u.
// The x_t half of the concat's gradient is a view of dcat and needs no kernel.
// Forward: every operation rounds to T, as the JAX package's bf16 operations round
// on XLA's CPU, with sigmoid(z) = 1 / (1 + exp(-z)); backward: f32, rounded once.
// f32 operations are explicitly rounded intrinsics (no FMA contraction), in the
// order of the plain PyTorch versions in ops/spatial_gru.py.
//
// Bound on an H100: bytes; ~10 flops a value. At the training shape (B = 3,
// 200 x 200, C = C_x = 64, bf16; 15.4 MB a map) a step reads x_t, r_pre, h, u_pre
// and h_tilde and writes the 128-channel concat and h': 123 MB, 37 us at 3.35
// TB/s; the backward reads six maps (dcat's state half, dout, r_pre, u_pre, h,
// h_tilde) and writes four (dr_pre, du_pre, dh, dh_tilde): 154 MB, 46 us. These
// kernels write dh in two parts, one a launch, which autograd sums: 11 maps.
//
// Design: one thread per (map, pixel, channel), channel fastest, so a warp reads
// and writes contiguous channels of a pixel. Each operand is addressed as
// base + b * batch_stride + i * row_stride + j * column_stride + c, which covers a
// slot of the (B, T, H, W, C) output, a frame of the input sequence, the latent
// broadcast over the map (zero row and column strides) and a channel slice of the
// concat's gradient alike.

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

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_float(from_float<T>(v)); }

// sigmoid in T's rounding: 1 / (1 + exp(-z)), each operation rounded
template <typename T>
__device__ __forceinline__ float sigmoid_t(float z) {
  const float e = rnd<T>(expf(-z));
  return rnd<T>(__fdiv_rn(1.0f, rnd<T>(__fadd_rn(1.0f, e))));
}

__device__ __forceinline__ float sigmoid_f32(float z) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
}

// An operand: element (b, i, j, c) of a (B, H, W, C) map at
// ptr[b * bs + i * hs + j * ws + c]; pixel p = i * W + j.
template <typename P>
struct Op {
  P* ptr;
  long long bs, hs, ws;
  __device__ __forceinline__ P& at(int b, int i, int j, int c) const {
    return ptr[(long long)b * bs + (long long)i * hs + (long long)j * ws + c];
  }
};

// The (map, row, column, channel) of thread index n over (B, H, W, C).
struct Index {
  int b, i, j, c;
};

__device__ __forceinline__ bool index_of(int B, int H, int W, int C, Index* ix) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * H * W * C) return false;
  ix->c = (int)(n % C);
  n /= C;
  ix->j = (int)(n % W);
  n /= W;
  ix->i = (int)(n % H);
  ix->b = (int)(n / H);
  return true;
}

template <typename T>
__global__ void reset_concat_kernel(Op<const T> x, Op<const T> r_pre, Op<const T> h,
                                    Op<T> cat, int B, int H, int W, int Cx, int C) {
  Index q;
  if (!index_of(B, H, W, Cx + C, &q)) return;
  if (q.c < Cx) {
    cat.at(q.b, q.i, q.j, q.c) = x.at(q.b, q.i, q.j, q.c);
    return;
  }
  const int k = q.c - Cx;
  const float r = sigmoid_t<T>(to_float(r_pre.at(q.b, q.i, q.j, k)));
  const float g = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(1.0f, r)),
                                   to_float(h.at(q.b, q.i, q.j, k))));
  cat.at(q.b, q.i, q.j, q.c) = from_float<T>(g);
}

template <typename T>
__global__ void state_update_kernel(Op<const T> u_pre, Op<const T> h, Op<const T> ht,
                                    Op<T> out, int B, int H, int W, int C) {
  Index q;
  if (!index_of(B, H, W, C, &q)) return;
  const float u = sigmoid_t<T>(to_float(u_pre.at(q.b, q.i, q.j, q.c)));
  const float a = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(1.0f, u)),
                                   to_float(h.at(q.b, q.i, q.j, q.c))));
  const float v = rnd<T>(__fmul_rn(u, to_float(ht.at(q.b, q.i, q.j, q.c))));
  out.at(q.b, q.i, q.j, q.c) = from_float<T>(__fadd_rn(a, v));
}

template <typename T>
__global__ void reset_concat_backward_kernel(Op<const T> dcat, Op<const T> r_pre,
                                             Op<const T> h, Op<T> dr, Op<T> dh, int B, int H,
                                             int W, int C) {
  Index q;
  if (!index_of(B, H, W, C, &q)) return;
  const float r = sigmoid_f32(to_float(r_pre.at(q.b, q.i, q.j, q.c)));
  const float g = to_float(dcat.at(q.b, q.i, q.j, q.c));
  const float one_minus = __fsub_rn(1.0f, r);
  dr.at(q.b, q.i, q.j, q.c) = from_float<T>(__fmul_rn(
      -__fmul_rn(g, to_float(h.at(q.b, q.i, q.j, q.c))), __fmul_rn(r, one_minus)));
  dh.at(q.b, q.i, q.j, q.c) = from_float<T>(__fmul_rn(g, one_minus));
}

template <typename T>
__global__ void state_update_backward_kernel(Op<const T> dout, Op<const T> u_pre,
                                             Op<const T> h, Op<const T> ht, Op<T> du,
                                             Op<T> dh, Op<T> dht, int B, int H, int W,
                                             int C) {
  Index q;
  if (!index_of(B, H, W, C, &q)) return;
  const float u = sigmoid_f32(to_float(u_pre.at(q.b, q.i, q.j, q.c)));
  const float g = to_float(dout.at(q.b, q.i, q.j, q.c));
  const float one_minus = __fsub_rn(1.0f, u);
  const float diff = __fsub_rn(to_float(ht.at(q.b, q.i, q.j, q.c)),
                               to_float(h.at(q.b, q.i, q.j, q.c)));
  du.at(q.b, q.i, q.j, q.c) = from_float<T>(__fmul_rn(__fmul_rn(g, diff),
                                                      __fmul_rn(u, one_minus)));
  dh.at(q.b, q.i, q.j, q.c) = from_float<T>(__fmul_rn(g, one_minus));
  dht.at(q.b, q.i, q.j, q.c) = from_float<T>(__fmul_rn(g, u));
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename P>
Op<P> op(const void* ptr, const long long* st) {
  return Op<P>{(P*)ptr, st[0], st[1], st[2]};
}

}  // namespace

// Each operand is a pointer and its (batch, row, column) strides in elements of a
// (B, H, W, C) map, its channels contiguous; float32 or bfloat16 (is_bf16), one
// dtype for all. cat: (B, H, W, Cx + C). Each returns cudaGetLastError() after
// its launch.
extern "C" int fiery_gru_reset_concat(const void* x, const long long* x_st, const void* r_pre,
                                      const long long* r_st, const void* h,
                                      const long long* h_st, void* cat,
                                      const long long* c_st, int B, int H, int W, int Cx,
                                      int C, int is_bf16, void* stream) {
  const long long n = (long long)B * H * W * (Cx + C);
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    reset_concat_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(x, x_st), op<const T>(r_pre, r_st), op<const T>(h, h_st),
        op<T>(cat, c_st), B, H, W, Cx, C);
  } else {
    using T = float;
    reset_concat_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(x, x_st), op<const T>(r_pre, r_st), op<const T>(h, h_st),
        op<T>(cat, c_st), B, H, W, Cx, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int fiery_gru_state_update(const void* u_pre, const long long* u_st,
                                      const void* h, const long long* h_st, const void* ht,
                                      const long long* t_st, void* out,
                                      const long long* o_st, int B, int H, int W, int C,
                                      int is_bf16, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    state_update_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(u_pre, u_st), op<const T>(h, h_st), op<const T>(ht, t_st),
        op<T>(out, o_st), B, H, W, C);
  } else {
    using T = float;
    state_update_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(u_pre, u_st), op<const T>(h, h_st), op<const T>(ht, t_st),
        op<T>(out, o_st), B, H, W, C);
  }
  return (int)cudaGetLastError();
}

// dcat: the state half of the concat's gradient (B, H, W, C).
extern "C" int fiery_gru_reset_concat_backward(const void* dcat, const long long* d_st,
                                               const void* r_pre, const long long* r_st,
                                               const void* h, const long long* h_st,
                                               void* dr, const long long* dr_st, void* dh,
                                               const long long* dh_st, int B, int H, int W,
                                               int C, int is_bf16, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    reset_concat_backward_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(dcat, d_st), op<const T>(r_pre, r_st), op<const T>(h, h_st),
        op<T>(dr, dr_st), op<T>(dh, dh_st), B, H, W, C);
  } else {
    using T = float;
    reset_concat_backward_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(dcat, d_st), op<const T>(r_pre, r_st), op<const T>(h, h_st),
        op<T>(dr, dr_st), op<T>(dh, dh_st), B, H, W, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int fiery_gru_state_update_backward(
    const void* dout, const long long* d_st, const void* u_pre, const long long* u_st,
    const void* h, const long long* h_st, const void* ht, const long long* t_st, void* du,
    const long long* du_st, void* dh, const long long* dh_st, void* dht,
    const long long* dt_st, int B, int H, int W, int C, int is_bf16, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    state_update_backward_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(dout, d_st), op<const T>(u_pre, u_st), op<const T>(h, h_st),
        op<const T>(ht, t_st), op<T>(du, du_st), op<T>(dh, dh_st), op<T>(dht, dt_st), B, H,
        W, C);
  } else {
    using T = float;
    state_update_backward_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
        op<const T>(dout, d_st), op<const T>(u_pre, u_st), op<const T>(h, h_st),
        op<const T>(ht, t_st), op<T>(du, du_st), op<T>(dh, dh_st), op<T>(dht, dt_st), B, H,
        W, C);
  }
  return (int)cudaGetLastError();
}
