// spatial_gru: the gate arithmetic of one SpatialGRU step around its convolutions,
// forward (two launches a step) and backward (two launches a step).
//
// Replaces: the gate math of fiery_tpu/models/temporal_layers.py
// `SpatialGRU.__call__` (sigmoid of the fused gate conv, the reset-gated concat,
// the state update and the stack of the states), which XLA fuses around the convs:
//   reset_concat_kernel:  cat[b, p, :] = [x_t, (1 - r) h],  r = sigmoid(r_pre),
//     the input of the state conv, written directly (no concat pass);
//   state_update_kernel:  out[b, t, p, c] = (1 - u) h + u h_tilde,
//     u = sigmoid(u_pre), written into slot t of the sequence output (no stack);
//   reset_concat_backward_kernel:  from g = dcat's state half,
//     dr_pre = (-(g h)) (r (1 - r)),  dh = g (1 - r);
//   state_update_backward_kernel:  from g = dout,
//     du_pre = (g (h_tilde - h)) (u (1 - u)),  dh = g (1 - u),  dh_tilde = g u.
// The x_t half of the concat's gradient is a view of dcat and needs no kernel.
// Forward: every operation rounds to T, as the JAX package's bf16 operations round
// on XLA's CPU, with sigmoid(z) = 1 / (1 + exp(-z)); backward: f32, rounded once.
// f32 operations are explicitly rounded intrinsics (no FMA contraction), in the
// order of the plain PyTorch versions in ops/spatial_gru.py; 1 / v is __frcp_rn(v),
// which rounds as the IEEE division __fdiv_rn(1, v) does.
//
// Bound on an H100: bytes; ~10 flops a value. At the training shape (B = 3,
// 200 x 200, C = C_x = 64, bf16; 15.4 MB a map) a step reads x_t, r_pre, h, u_pre
// and h_tilde and writes the 128-channel concat and h': 123 MB, 37 us at 3.35
// TB/s; the backward reads six maps (dcat's state half, dout, r_pre, u_pre, h,
// h_tilde) and writes four (dr_pre, du_pre, dh, dh_tilde): 154 MB, 46 us. These
// kernels write dh in two parts, one a launch, which autograd sums with the
// gradient of the gates' input concat: 11 maps.
//
// Design (for the H100):
// - Vector access. A thread moves V consecutive channels of one pixel with one
//   load or store of V * sizeof(T) bytes: 16 (8 bf16, 4 f32) when every operand's
//   address, batch and pixel strides and channel counts allow it, else 8, 4 or 2
//   bytes. The wrapper decides V once per shape, strides and alignment
//   (ops/spatial_gru.py `_plan`).
// - No division. Each operand is addressed as base + b * bs + p * ps + c, pixel
//   p = i W + j (the wrapper checks that the row stride is W times the pixel
//   stride, or copies a gradient that is not so laid out). That covers a slot of
//   the (B, T, H, W, C) output, a frame of the input sequence, the latent
//   broadcast over the map (pixel stride 0) and a channel slice of the concat's
//   gradient alike. A block is G x PIX threads: threadIdx.x the G vectors of a
//   pixel, threadIdx.y PIX consecutive pixels; the grid is (pixel tiles, maps).
// - Arithmetic. bf16 pairs take sub/mul/add.rn.bf16x2, which round the exact
//   result of two bf16 operands once to bf16; that equals rounding it to f32 and
//   then to bf16 (the f32 emulation of the JAX package's bf16 operations), since
//   f32 keeps 24 >= 2 * 8 + 2 bits (the same argument as batch_norm.cu's). exp
//   stays an f32 expf per value, rounded to bf16 as before; the reciprocal is
//   __frcp_rn. One-value (V = 1) bf16 accesses and f32 use the scalar f32 forms.
// - The concat's x_t half is a copy of V values a thread.
// Launches: 2 a GRU step forward, 2 backward; no synchronisation, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

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

// sigmoid in T's rounding: 1 / (1 + exp(-z)), each operation rounded
template <typename T>
__device__ __forceinline__ float sigmoid_t(float z) {
  const float e = rnd<T>(expf(-z));
  return rnd<T>(__frcp_rn(rnd<T>(__fadd_rn(1.0f, e))));
}

__device__ __forceinline__ float sigmoid_f32(float z) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-z)));
}

// V values of T moved as one access of V * sizeof(T) bytes (2 to 16), held as
// 32-bit words
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = V * (int)sizeof(T);
  static constexpr int kWords = (kBytes + 3) / 4;
  unsigned int w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kBytes == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<unsigned int*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    }
  }
  // element i as f32 (exact)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const unsigned int x = w[i >> 1];
      return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
    }
  }
  // elements from f32 values, each rounded to T
  __device__ __forceinline__ void set(const float (&v)[V]) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < V; ++i) w[i] = __float_as_uint(v[i]);
    } else if constexpr (V == 1) {
      w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
    } else {
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned int*>(&h);
      }
    }
  }
};

// bf16x2 arithmetic, each half rounded once to nearest-even (sm_90)
__device__ __forceinline__ unsigned int bf2_sub(unsigned int a, unsigned int b) {
  unsigned int d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned int bf2_add(unsigned int a, unsigned int b) {
  unsigned int d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned int bf2_mul(unsigned int a, unsigned int b) {
  unsigned int d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// the two halves of a bf16x2 word as f32 (exact), and two f32 values rounded into one
__device__ __forceinline__ float lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned int pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}
constexpr unsigned int kOne2 = 0x3f803f80u;   // (1, 1) in bf16x2

// sigmoid_t<bf16> of two values at once
__device__ __forceinline__ unsigned int sigmoid2(unsigned int z) {
  const unsigned int d = bf2_add(kOne2, pack2(expf(-lo(z)), expf(-hi(z))));
  return pack2(__frcp_rn(lo(d)), __frcp_rn(hi(d)));
}

// (1 - sigmoid(z)) h, every operation rounded to T
template <typename T, int V>
__device__ __forceinline__ void reset_gate(const Vec<T, V>& z, const Vec<T, V>& h,
                                           Vec<T, V>& out) {
  if constexpr (kBf16<T> && V >= 2) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) out.w[i] = bf2_mul(bf2_sub(kOne2, sigmoid2(z.w[i])), h.w[i]);
  } else {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float r = sigmoid_t<T>(z.get(i));
      o[i] = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(1.0f, r)), h.get(i)));
    }
    out.set(o);
  }
}

// (1 - u) h + u h_tilde with u = sigmoid(z), every operation rounded to T
template <typename T, int V>
__device__ __forceinline__ void update_gate(const Vec<T, V>& z, const Vec<T, V>& h,
                                            const Vec<T, V>& ht, Vec<T, V>& out) {
  if constexpr (kBf16<T> && V >= 2) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const unsigned int u = sigmoid2(z.w[i]);
      out.w[i] = bf2_add(bf2_mul(bf2_sub(kOne2, u), h.w[i]), bf2_mul(u, ht.w[i]));
    }
  } else {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float u = sigmoid_t<T>(z.get(i));
      const float a = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(1.0f, u)), h.get(i)));
      const float b = rnd<T>(__fmul_rn(u, ht.get(i)));
      o[i] = __fadd_rn(a, b);
    }
    out.set(o);
  }
}

// An operand: element (b, p, c) of a (B, P, C) map at ptr[b * bs + p * ps + c]
template <typename P>
struct Op {
  P* ptr;
  long long bs, ps;
  __device__ __forceinline__ P* at(int b, int p, int c) const {
    return ptr + ((long long)b * bs + (long long)p * ps + c);
  }
};

// the thread's (map, pixel, first channel); false past the last pixel
template <int V>
__device__ __forceinline__ bool place(int P, int* b, int* p, int* c) {
  *p = blockIdx.x * blockDim.y + threadIdx.y;
  *b = blockIdx.y;
  *c = threadIdx.x * V;
  return *p < P;
}

template <typename T, int V>
__global__ void reset_concat_kernel(Op<const T> x, Op<const T> r_pre, Op<const T> h,
                                    Op<T> cat, int P, int Cx) {
  int b, p, c;
  if (!place<V>(P, &b, &p, &c)) return;
  Vec<T, V> out;
  if (c < Cx) {
    out.load(x.at(b, p, c));
  } else {
    Vec<T, V> z, hv;
    z.load(r_pre.at(b, p, c - Cx));
    hv.load(h.at(b, p, c - Cx));
    reset_gate<T, V>(z, hv, out);
  }
  out.store(cat.at(b, p, c));
}

template <typename T, int V>
__global__ void state_update_kernel(Op<const T> u_pre, Op<const T> h, Op<const T> ht,
                                    Op<T> out, int P) {
  int b, p, c;
  if (!place<V>(P, &b, &p, &c)) return;
  Vec<T, V> z, hv, tv, o;
  z.load(u_pre.at(b, p, c));
  hv.load(h.at(b, p, c));
  tv.load(ht.at(b, p, c));
  update_gate<T, V>(z, hv, tv, o);
  o.store(out.at(b, p, c));
}

template <typename T, int V>
__global__ void reset_concat_backward_kernel(Op<const T> dcat, Op<const T> r_pre,
                                             Op<const T> h, Op<T> dr, Op<T> dh, int P) {
  int b, p, c;
  if (!place<V>(P, &b, &p, &c)) return;
  Vec<T, V> g, z, hv, a, d;
  g.load(dcat.at(b, p, c));
  z.load(r_pre.at(b, p, c));
  hv.load(h.at(b, p, c));
  float va[V], vd[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float r = sigmoid_f32(z.get(i));
    const float one_minus = __fsub_rn(1.0f, r);
    va[i] = __fmul_rn(-__fmul_rn(g.get(i), hv.get(i)), __fmul_rn(r, one_minus));
    vd[i] = __fmul_rn(g.get(i), one_minus);
  }
  a.set(va);
  d.set(vd);
  a.store(dr.at(b, p, c));
  d.store(dh.at(b, p, c));
}

template <typename T, int V>
__global__ void state_update_backward_kernel(Op<const T> dout, Op<const T> u_pre,
                                             Op<const T> h, Op<const T> ht, Op<T> du,
                                             Op<T> dh, Op<T> dht, int P) {
  int b, p, c;
  if (!place<V>(P, &b, &p, &c)) return;
  Vec<T, V> g, z, hv, tv, a, d, e;
  g.load(dout.at(b, p, c));
  z.load(u_pre.at(b, p, c));
  hv.load(h.at(b, p, c));
  tv.load(ht.at(b, p, c));
  float va[V], vd[V], ve[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float u = sigmoid_f32(z.get(i));
    const float one_minus = __fsub_rn(1.0f, u);
    const float diff = __fsub_rn(tv.get(i), hv.get(i));
    va[i] = __fmul_rn(__fmul_rn(g.get(i), diff), __fmul_rn(u, one_minus));
    vd[i] = __fmul_rn(g.get(i), one_minus);
    ve[i] = __fmul_rn(g.get(i), u);
  }
  a.set(va);
  d.set(vd);
  e.set(ve);
  a.store(du.at(b, p, c));
  d.store(dh.at(b, p, c));
  e.store(dht.at(b, p, c));
}

// The plan the wrapper computes once per shape (ops/spatial_gru.py `_plan`):
// kind, is_bf16, V, P (pixels), B, G (vectors a pixel), PIX (pixels a block),
// pixel tiles, C_x (channels of x_t, reset_concat only), then each operand's
// (batch, pixel) strides in elements.
enum Kind { kResetConcat = 0, kStateUpdate = 1, kResetConcatBwd = 2, kStateUpdateBwd = 3 };
constexpr int kMaxOperands = 7;
struct Plan {
  long long kind, is_bf16, V, P, B, G, pix, tiles, cx;
  long long st[kMaxOperands][2];
};

template <typename P>
Op<P> op(void* ptr, const Plan& pl, int k) {
  return Op<P>{(P*)ptr, pl.st[k][0], pl.st[k][1]};
}

template <typename T, int V>
void launch(const Plan& pl, void* const* a, cudaStream_t st) {
  const dim3 grid((unsigned)pl.tiles, (unsigned)pl.B), block((unsigned)pl.G, (unsigned)pl.pix);
  const int P = (int)pl.P;
  switch (pl.kind) {
    case kResetConcat:
      reset_concat_kernel<T, V><<<grid, block, 0, st>>>(
          op<const T>(a[0], pl, 0), op<const T>(a[1], pl, 1), op<const T>(a[2], pl, 2),
          op<T>(a[3], pl, 3), P, (int)pl.cx);
      break;
    case kStateUpdate:
      state_update_kernel<T, V><<<grid, block, 0, st>>>(
          op<const T>(a[0], pl, 0), op<const T>(a[1], pl, 1), op<const T>(a[2], pl, 2),
          op<T>(a[3], pl, 3), P);
      break;
    case kResetConcatBwd:
      reset_concat_backward_kernel<T, V><<<grid, block, 0, st>>>(
          op<const T>(a[0], pl, 0), op<const T>(a[1], pl, 1), op<const T>(a[2], pl, 2),
          op<T>(a[3], pl, 3), op<T>(a[4], pl, 4), P);
      break;
    default:
      state_update_backward_kernel<T, V><<<grid, block, 0, st>>>(
          op<const T>(a[0], pl, 0), op<const T>(a[1], pl, 1), op<const T>(a[2], pl, 2),
          op<const T>(a[3], pl, 3), op<T>(a[4], pl, 4), op<T>(a[5], pl, 5),
          op<T>(a[6], pl, 6), P);
  }
}

}  // namespace

// One launch of kernel plan->kind on the operands a0..a6 (unused ones null), in
// the order of the kernels' parameters: reset_concat (x_t, r_pre, h, cat),
// state_update (u_pre, h, h_tilde, out), reset_concat_backward (dcat's state half,
// r_pre, h, dr_pre, dh), state_update_backward (dout, u_pre, h, h_tilde, du_pre,
// dh, dh_tilde). Every operand is float32 or bfloat16 (plan->is_bf16), its V
// channels at a thread's offset 16-byte, 8-byte, ... aligned as the plan's V
// requires. Returns cudaGetLastError() after the launch.
extern "C" int fiery_gru(const long long* plan, void* a0, void* a1, void* a2, void* a3,
                         void* a4, void* a5, void* a6, void* stream) {
  const Plan& pl = *reinterpret_cast<const Plan*>(plan);
  if (pl.P * pl.B == 0) return (int)cudaSuccess;
  void* const a[kMaxOperands] = {a0, a1, a2, a3, a4, a5, a6};
  cudaStream_t st = (cudaStream_t)stream;
  if (pl.is_bf16) {
    using T = __nv_bfloat16;
    switch (pl.V) {
      case 8: launch<T, 8>(pl, a, st); break;
      case 4: launch<T, 4>(pl, a, st); break;
      case 2: launch<T, 2>(pl, a, st); break;
      default: launch<T, 1>(pl, a, st);
    }
  } else {
    using T = float;
    switch (pl.V) {
      case 4: launch<T, 4>(pl, a, st); break;
      case 2: launch<T, 2>(pl, a, st); break;
      default: launch<T, 1>(pl, a, st);
    }
  }
  return (int)cudaGetLastError();
}
