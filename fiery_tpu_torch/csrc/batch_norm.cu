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
// the order of the plain PyTorch version in ops/batch_norm.py; 1 / v is
// __frcp_rn(v), which rounds as the IEEE division __fdiv_rn(1, v) does.
//
// Bound on an H100: bytes. A training forward reads x twice (statistics, apply)
// and writes y once; eval reads x (and the residual) once; the backward reads dy
// and x twice and writes dx (and dres). dy may be a channel slice of wider rows
// (the gradient of a concat), read in place. At the largest call of a training step
// (the encoder's first expanded layer, 54 images x 112 x 240 x 144 bf16, 418 MB)
// the bound is 0.25 ms forward and 0.37 ms backward at 3.35 TB/s.
//
// Design (for the H100):
// - Vector access. A thread moves V consecutive values of a row with one load or
//   store of V * sizeof(T) bytes: 16 bytes when C is a multiple of 8 (bf16) or 4
//   (f32) and every row start is 16-byte aligned; 8, 4 or 2 bytes otherwise. The
//   wrapper picks V once per shape and alignment (ops/batch_norm.py `_plan`).
//   A C that is not a multiple of V (21, 23, 35 channels) takes fold = V / gcd(C, V)
//   consecutive rows as one kernel row of W = fold C values, when the rows are
//   dense and their count allows it; value p of a kernel row is channel p % C.
//   A block's threads are G row groups of W / V lanes; a thread keeps one lane and
//   its channels' constants in registers, computed once per block into shared
//   memory.
// - Rows. Block b owns the kernel rows [b R, (b + 1) R); its thread of row group g
//   takes the rows b R + g, b R + g + G, ... of that chunk, kUnroll (forward) or
//   unroll_bwd (backward) loads in flight. The grid is as many blocks as the rows
//   fill, at most one per SM (512 threads; the registers of V = 8 hold one block).
// - One launch for a reduction and its finalize. Each block sums its rows in f64
//   in registers, then its G row groups (and fold rows) in shared memory in a
//   fixed order, and writes one partial per block. The last block to finish (a
//   ticket: fence, then an integer atomicAdd) sums the partials in block order,
//   writes the statistics (or the parameter gradients and the two dx
//   coefficients) and resets the ticket. When blocks x C is large (C = 960: 132 x
//   960 x 16 bytes), two levels keep this serial tail short: the last block of each
//   group of kGroup blocks sums the group's, the last group the groups'. No
//   floating-point atomics: two runs give the same bits.
// - L2 reuse. The second pass (apply) walks each thread's rows in the reverse order
//   of the first, so the rows the first pass read last are reread from L2 first; a
//   call under ~40 MB rereads all of x (and dy) from L2.
// - Arithmetic. bf16 pairs form z with sub/mul/add.rn.bf16x2 (each rounds as the
//   f32 operation rounded to bf16 does); swish's exp and reciprocal stay f32
//   intrinsics, rounded where the JAX package rounds. The epilogue is a template
//   parameter, so a kernel carries only its own epilogue's registers and code.
// - Eval is one launch of the apply pass.
// - Wide layers. A launch takes at most kMaxC channels (its constants and its last
//   block's sums live in shared memory). The wrapper splits a wider call (the
//   encoder's expanded layers at downsample 16: 1,632 and 2,688 channels) into
//   channel slices of at most kMaxC, one launch each: a slice's rows are `ld`
//   values apart (the whole row), its per-channel vectors start at its first
//   channel. Channels are independent, so the slices give the whole call's bits.
// Launches: training forward 2 (statistics + finalize, apply), eval 1, backward 2
// (reduce + finalize, apply), each once a channel slice. The tickets are global to the device, so the kernels
// of one call run on one stream at a time (the port uses one stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

enum Post { kNone = 0, kRelu = 1, kSwish = 2, kAdd = 3, kAddRelu = 4, kReluAdd = 5 };
// row steps a thread loads before it uses them: the backward loads two tensors a
// step (three for add_relu, with fewer steps) and keeps more channel constants
constexpr int kUnroll = 8;
template <int GRAD> __host__ __device__ constexpr int unroll_bwd() {
  return GRAD == kAddRelu ? 2 : 4;
}
constexpr int kMaxC = 1024;
constexpr int kGroup = 8;           // blocks whose partials a first-level sum adds
constexpr int kOneLevel = 16384;    // blocks x C up to which one level adds them all
constexpr int kMaxGroups = 128;     // groups of a grid (1024 blocks)
constexpr int kConsts = 6;          // channel constants kept in shared memory

// the tickets of the two reductions (statistics, backward): per group of kGroup
// blocks, the count of its blocks that have written their partial, and last the
// count of groups that have written theirs; the last block to count resets it
__device__ unsigned int g_tickets[2][kMaxGroups + 1];

// threads a block may have: V = 1 takes up to 1024 lanes, wider vectors 512
template <int V> __host__ __device__ constexpr int max_threads() { return V == 1 ? 1024 : 512; }


// a block's f64 scratch: the G W <= threads V sums of a block and threads slices
// of them, or the 2 max(threads, C) of the last block's sum of the partials
template <int V> __host__ __device__ constexpr int red_doubles() {
  return max_threads<V>() * (V + 1) > 2 * kMaxC ? max_threads<V>() * (V + 1) : 2 * kMaxC;
}

// shared memory of a block that keeps both the channel constants (kConsts x kMaxC
// f32) and, after them, its f64 scratch
template <int V> __host__ __device__ constexpr int smem_bytes() {
  return kConsts * kMaxC * 4 > red_doubles<V>() * 8 ? kConsts * kMaxC * 4
                                                    : red_doubles<V>() * 8;
}

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

// bf16x2 arithmetic, each half rounded once to nearest-even (sm_90). For bf16
// operands it rounds as the f32 operation rounded to bf16 does: f32 keeps 24 >=
// 2 * 8 + 2 bits, so rounding twice gives the correctly rounded result.
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

// The rows of a call as the kernels walk them: M rows of W = fold C values (fold
// consecutive rows of C channels, so that W is a multiple of V; value p of a row
// is channel p % C); block b owns rows [b R, min((b + 1) R, M)); its threads are
// G row groups of W / V lanes.
struct Rows {
  long long M, R;
  int W, C, G;
  long long S;    // values from one kernel row of x, res, y, dres and dx to the next
};

// The rows of one thread: first, first + G, ..., last (none when !any).
struct Walk {
  long long first, last;
  bool any;
};

__device__ __forceinline__ Walk walk_of(const Rows& rw, int g) {
  const long long r0 = (long long)blockIdx.x * rw.R;
  const long long r1 = min(rw.M, r0 + rw.R);
  Walk k;
  k.first = r0 + g;
  k.any = k.first < r1;
  k.last = k.any ? k.first + (r1 - 1 - k.first) / rw.G * rw.G : k.first;
  return k;
}

// The thread's place: row group g, lane (values p0 .. p0 + V - 1 of a row); false
// for the threads past the G row groups.
template <int V>
__device__ __forceinline__ bool lane_of(const Rows& rw, int* g, int* p0) {
  const int L = rw.W / V, t = threadIdx.x;
  *g = t / L;
  *p0 = (t - *g * L) * V;
  return *g < rw.G;
}

// Per-channel constants of the forward, rounded to T as _BNCore casts them, into
// shared memory: k[0] mean_t, k[1] mul_t, k[2] bias_t, k[3] mean, k[4] rstd,
// k[5] mul (f32). Ends with a barrier.
template <typename T>
__device__ __forceinline__ void channel_consts(const float* __restrict__ mean,
                                               const float* __restrict__ var,
                                               const float* __restrict__ w,
                                               const float* __restrict__ bias, float eps,
                                               int C, float (*k)[kMaxC]) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float m = mean[c];
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var[c], eps)));
    const float mul = __fmul_rn(w[c], rstd);
    k[0][c] = rnd<T>(m);
    k[1][c] = rnd<T>(mul);
    k[2][c] = rnd<T>(bias[c]);
    k[3][c] = m;
    k[4][c] = rstd;
    k[5][c] = mul;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float normalise(float x, float mean_t, float mul_t, float bias_t) {
  const float a = rnd<T>(__fsub_rn(x, mean_t));
  const float b = rnd<T>(__fmul_rn(a, mul_t));
  return rnd<T>(__fadd_rn(b, bias_t));
}

template <typename T>
__device__ __forceinline__ float epilogue(float z, float r, int post) {
  switch (post) {
    case kRelu: return fmaxf(z, 0.0f);
    case kSwish: {
      const float e = rnd<T>(expf(-z));
      const float s = rnd<T>(__frcp_rn(rnd<T>(__fadd_rn(1.0f, e))));
      return rnd<T>(__fmul_rn(z, s));
    }
    case kAdd: return rnd<T>(__fadd_rn(z, r));
    case kAddRelu: return fmaxf(rnd<T>(__fadd_rn(z, r)), 0.0f);
    case kReluAdd: return rnd<T>(__fadd_rn(fmaxf(z, 0.0f), r));
    default: return z;
  }
}

__device__ __forceinline__ unsigned int relu2(unsigned int w) {
  return pack2(fmaxf(lo(w), 0.0f), fmaxf(hi(w), 0.0f));
}

// The epilogue on two bf16 values at once, each operation rounded as `epilogue`
// rounds it.
__device__ __forceinline__ unsigned int epilogue2(unsigned int z, unsigned int r, int post) {
  switch (post) {
    case kRelu: return relu2(z);
    case kSwish: {
      const unsigned int e = pack2(expf(-lo(z)), expf(-hi(z)));
      const unsigned int d = bf2_add(kOne2, e);
      return bf2_mul(z, pack2(__frcp_rn(lo(d)), __frcp_rn(hi(d))));
    }
    case kAdd: return bf2_add(z, r);
    case kAddRelu: return relu2(bf2_add(z, r));
    case kReluAdd: return bf2_add(relu2(z), r);
    default: return z;
  }
}

// The gradient before the epilogue, at the forward's z (f32).
__device__ __forceinline__ float epilogue_grad(float dy, float z, float r, int post) {
  switch (post) {
    case kRelu:
    case kReluAdd: return z > 0.0f ? dy : 0.0f;
    case kSwish: {
      const float s = __frcp_rn(__fadd_rn(1.0f, expf(-z)));
      return __fmul_rn(dy, __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s)))));
    }
    case kAddRelu: return __fadd_rn(z, r) > 0.0f ? dy : 0.0f;
    default: return dy;
  }
}

__host__ __device__ constexpr bool has_residual(int post) {
  return post == kAdd || post == kAddRelu || post == kReluAdd;
}

// A thread's channel constants, for its V values: the T-rounded ones that form
// z (two to a word for bf16 pairs), and the f32 ones of the backward.
template <typename T, int V>
struct Lane {
  static constexpr bool kPacked = sizeof(T) == 2 && V >= 2;
  static constexpr int kPairs = (V + 1) / 2;
  float mean_t[V], mul_t[V], bias_t[V];
  unsigned int mean2[kPairs], mul2[kPairs], bias2[kPairs];
  float mu[V], rstd[V], mul[V];

  // from the block's shared constants, value p0 + v being channel (p0 + v) % C;
  // with_f32: also mean, rstd and mul
  __device__ __forceinline__ void load(float (*k)[kMaxC], int p0, int C, bool with_f32) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = (p0 + v) % C;
      mean_t[v] = k[0][c];
      mul_t[v] = k[1][c];
      bias_t[v] = k[2][c];
      if (with_f32) {
        mu[v] = k[3][c];
        rstd[v] = k[4][c];
        mul[v] = k[5][c];
      }
    }
    if constexpr (kPacked) {
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        mean2[i] = pack2(mean_t[2 * i], mean_t[2 * i + 1]);
        mul2[i] = pack2(mul_t[2 * i], mul_t[2 * i + 1]);
        bias2[i] = pack2(bias_t[2 * i], bias_t[2 * i + 1]);
      }
    }
  }

  // z = ((x - mean) * mul) + bias, each operation rounded to T
  __device__ __forceinline__ Vec<T, V> normalise_vec(const Vec<T, V>& x) const {
    Vec<T, V> z;
    if constexpr (kPacked) {
#pragma unroll
      for (int i = 0; i < V / 2; ++i)
        z.w[i] = bf2_add(bf2_mul(bf2_sub(x.w[i], mean2[i]), mul2[i]), bias2[i]);
    } else {
      float f[V];
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = normalise<T>(x.get(v), mean_t[v], mul_t[v], bias_t[v]);
      z.set(f);
    }
    return z;
  }
};

// y = post(z, r) for a vector
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> epilogue_vec(const Vec<T, V>& z, const Vec<T, V>& r,
                                                  int post) {
  Vec<T, V> y;
  if constexpr (Lane<T, V>::kPacked) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) y.w[i] = epilogue2(z.w[i], r.w[i], post);
  } else {
    const bool with_res = has_residual(post);
    float f[V];
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = epilogue<T>(z.get(v), with_res ? r.get(v) : 0.0f, post);
    y.set(f);
  }
  return y;
}

// One f64 sum per channel of the block: the thread of row group g and values
// p0 .. p0 + V - 1 holds s[v]. Viewed as Q = G fold rows of C channels, the
// block's values are summed per channel in a fixed order, with the block's
// threads in parallel: thread (j, c) of P = max(1, threads / C) slices sums rows
// q = j, j + P, ... of channel c, then the P slices are added in order into
// out[c]. red: shared scratch of G W + threads doubles. Barriers before and after.
template <int V>
__device__ __forceinline__ void block_sum(const double (&s)[V], bool active, int g, int p0,
                                          const Rows& rw, double* red,
                                          double* __restrict__ out) {
  __syncthreads();
  if (active) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[g * rw.W + p0 + v] = s[v];
  }
  __syncthreads();
  const int C = rw.C, Q = rw.G * (rw.W / C), P = max(1, (int)blockDim.x / C);
  double* slices = red + (size_t)rw.G * rw.W;
  for (int i = threadIdx.x; i < P * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    double a = 0.0;
    for (int q = j; q < Q; q += P) a += red[q * C + c];
    if (P > 1) {
      slices[i] = a;
    } else {
      out[c] = a;
    }
  }
  if (P > 1) {
    __syncthreads();
    const int c = threadIdx.x;
    if (c < C) {
      double a = 0.0;
      for (int j = 0; j < P; ++j) a += slices[j * C + c];
      out[c] = a;
    }
  }
}

// After `count` blocks each wrote and counted a result on `ticket`: true in the
// last of them (all of their writes are then visible to it).
__device__ __forceinline__ bool last_of(unsigned int* ticket, int count) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == (unsigned int)count - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// Slots [first, first + count) of (2, C) f64 partials summed in slot order, with
// the block's loads in flight: thread (j, c) of P = max(1, threads / C) slices
// sums slots first + j, first + j + P, ... of channel c, then the P slices are
// added in order. Leaves the sums of channel c in red[c] and red[C + c]; red:
// shared scratch of max(2 threads, 2 C) doubles. Barriers inside and after.
__device__ __forceinline__ void sum_slots(const double* __restrict__ partial, int first,
                                          int count, int C, double* red) {
  const int P = max(1, (int)blockDim.x / C);
  __syncthreads();
  for (int i = threadIdx.x; i < P * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    double sa = 0.0, sb = 0.0;
#pragma unroll 8
    for (int k = first + j; k < first + count; k += P) {
      sa += __ldcg(partial + (size_t)2 * k * C + c);
      sb += __ldcg(partial + (size_t)(2 * k + 1) * C + c);
    }
    red[i] = sa;
    red[P * C + i] = sb;
  }
  __syncthreads();
  if (P > 1) {
    double a[2] = {0.0, 0.0};
    const int c = threadIdx.x;
    if (c < C)
      for (int h = 0; h < 2; ++h)
        for (int j = 0; j < P; ++j) a[h] += red[h * P * C + j * C + c];
    __syncthreads();
    if (c < C) {
      red[c] = a[0];
      red[C + c] = a[1];
    }
    __syncthreads();
  }
}

// After each block wrote its (2, C) partial into slot blockIdx.x: true in the one
// block that ends with the grid's sums in red[c], red[C + c]. A grid of one block
// reads its own. Else the partials are added in slot order by the last block to
// finish, in two levels when blocks x C > kOneLevel, so that no block adds more
// than max(kGroup, groups) of them: the last block of each group of kGroup blocks
// sums the group's into slot blocks + group; the last of those sums the groups'.
// partial: blocks + ceil(blocks / kGroup) slots. Resets the tickets it used.
__device__ __forceinline__ bool reduce_partials(double* __restrict__ partial, int C,
                                                double* red, unsigned int* tickets) {
  const int nb = gridDim.x;
  if (nb == 1) {
    __syncthreads();
    sum_slots(partial, 0, 1, C, red);
    return true;
  }
  const int group = (long long)nb * C <= kOneLevel ? nb : kGroup;
  const int ng = (nb + group - 1) / group, g = blockIdx.x / group;
  const int first = g * group, count = min(group, nb - first);
  if (!last_of(&tickets[g], count)) return false;
  if (threadIdx.x == 0) tickets[g] = 0;
  sum_slots(partial, first, count, C, red);
  if (ng == 1) return true;
  double* slot = partial + (size_t)(nb + g) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) slot[c] = red[c];
  if (!last_of(&tickets[kMaxGroups], ng)) return false;
  if (threadIdx.x == 0) tickets[kMaxGroups] = 0;
  sum_slots(partial, nb, ng, C, red);
  return true;
}

// Training statistics in one launch: each block sums x and x^2 over its rows
// (f64) into its partial; the last block sums the partials and writes mean, var
// and clamp, and updates the running statistics.
template <typename T, int V>
__global__ void __launch_bounds__(max_threads<V>())
stats_kernel(const T* __restrict__ x, Rows rw, double* __restrict__ partial,
             float* __restrict__ mean, float* __restrict__ var, float* __restrict__ clamp,
             float* __restrict__ running_mean, float* __restrict__ running_var,
             float momentum, float one_minus_momentum) {
  __shared__ __align__(16) double red[red_doubles<V>()];
  int g, p0;
  const bool active = lane_of<V>(rw, &g, &p0);
  double s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.0;
  const Walk k = walk_of(rw, g);
  if (active && k.any) {
    const long long step = (long long)kUnroll * rw.G;
    for (long long r = k.first; r <= k.last; r += step) {
      Vec<T, V> xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long m = r + (long long)u * rw.G;
        if (m <= k.last) xv[u].load(x + m * rw.S + p0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + (long long)u * rw.G > k.last) break;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const double d = (double)xv[u].get(v);
          s1[v] += d;
          s2[v] += d * d;
        }
      }
    }
  }
  double* part = partial + (size_t)blockIdx.x * 2 * rw.C;
  block_sum<V>(s1, active, g, p0, rw, red, part);
  block_sum<V>(s2, active, g, p0, rw, red, part + rw.C);
  if (!reduce_partials(partial, rw.C, red, g_tickets[0])) return;
  const double n = (double)rw.M * (double)(rw.W / rw.C);
  for (int c = threadIdx.x; c < rw.C; c += blockDim.x) {
    const double a = red[c], b = red[rw.C + c];
    const float m = (float)(a / n);
    const float m2 = (float)(b / n);
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
}

// y = POST(normalise(x), r), each thread walking its rows last to first.
template <typename T, int V, int POST>
__global__ void __launch_bounds__(max_threads<V>())
apply_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
             const float* __restrict__ mean, const float* __restrict__ var,
             const float* __restrict__ w, const float* __restrict__ bias, float eps,
             Rows rw) {
  __shared__ __align__(16) float ks[kConsts][kMaxC];
  channel_consts<T>(mean, var, w, bias, eps, rw.C, ks);
  int g, p0;
  if (!lane_of<V>(rw, &g, &p0)) return;
  const Walk k = walk_of(rw, g);
  if (!k.any) return;
  Lane<T, V> lane;
  lane.load(ks, p0, rw.C, false);
  constexpr bool with_res = has_residual(POST);
  const long long step = (long long)kUnroll * rw.G;
  for (long long r = k.last; r >= k.first; r -= step) {
    Vec<T, V> xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long m = r - (long long)u * rw.G;
      if (m >= k.first) {
        xv[u].load(x + m * rw.S + p0);
        if (with_res) rv[u].load(res + m * rw.S + p0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long m = r - (long long)u * rw.G;
      if (m < k.first) break;
      epilogue_vec(lane.normalise_vec(xv[u]), rv[u], POST).store(y + m * rw.S + p0);
    }
  }
}

// Backward, pass 1 in one launch: dz per value (written as dres for add_relu),
// and per block the f64 sums of dz and dz * xhat; the last block sums the
// partials into dparams: dweight, dbias and the two coefficients of dx. Row m of
// dy starts at m * dy_rs. GRAD: the epilogue whose gradient is taken (none for
// add, relu for relu_add: they pass dy to the residual unchanged).
template <typename T, int V, int GRAD>
__global__ void __launch_bounds__(max_threads<V>())
backward_reduce_kernel(const T* __restrict__ dy, long long dy_rs, const T* __restrict__ x,
                       const T* __restrict__ res, T* __restrict__ dres,
                       const float* __restrict__ mean, const float* __restrict__ var,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       const float* __restrict__ clamp, float eps, Rows rw, int training,
                       double* __restrict__ partial,
                       float* __restrict__ dparams) {
  // the constants go to registers before the loop; block_sum's first barrier
  // then lets the block's sums take their place
  __shared__ __align__(16) unsigned char smem[smem_bytes<V>()];
  auto ks = reinterpret_cast<float (*)[kMaxC]>(smem);
  double* red = reinterpret_cast<double*>(smem);
  channel_consts<T>(mean, var, w, bias, eps, rw.C, ks);
  int g, p0;
  const bool active = lane_of<V>(rw, &g, &p0);
  double s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.0;
  const Walk k = walk_of(rw, g);
  if (active && k.any) {
    Lane<T, V> lane;
    lane.load(ks, p0, rw.C, true);
    constexpr bool with_res = GRAD == kAddRelu;
    const long long step = (long long)unroll_bwd<GRAD>() * rw.G;
    for (long long r = k.first; r <= k.last; r += step) {
      Vec<T, V> xv[unroll_bwd<GRAD>()], dv[unroll_bwd<GRAD>()], rv[unroll_bwd<GRAD>()];
#pragma unroll
      for (int u = 0; u < unroll_bwd<GRAD>(); ++u) {
        const long long m = r + (long long)u * rw.G;
        if (m <= k.last) {
          xv[u].load(x + m * rw.S + p0);
          dv[u].load(dy + m * dy_rs + p0);
          if (with_res) rv[u].load(res + m * rw.S + p0);
        }
      }
#pragma unroll
      for (int u = 0; u < unroll_bwd<GRAD>(); ++u) {
        const long long m = r + (long long)u * rw.G;
        if (m > k.last) break;
        const Vec<T, V> z = lane.normalise_vec(xv[u]);
        float dzs[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xf = xv[u].get(v);
          const float dz = epilogue_grad(dv[u].get(v), z.get(v),
                                         with_res ? rv[u].get(v) : 0.0f, GRAD);
          const float xhat = __fmul_rn(__fsub_rn(xf, lane.mu[v]), lane.rstd[v]);
          s1[v] += (double)dz;
          s2[v] += (double)dz * (double)xhat;
          dzs[v] = dz;
        }
        if (with_res) {
          Vec<T, V> out;
          out.set(dzs);
          out.store(dres + m * rw.S + p0);
        }
      }
    }
  }
  double* part = partial + (size_t)blockIdx.x * 2 * rw.C;
  block_sum<V>(s1, active, g, p0, rw, red, part);
  block_sum<V>(s2, active, g, p0, rw, red, part + rw.C);
  if (!reduce_partials(partial, rw.C, red, g_tickets[1])) return;
  const double n = (double)rw.M * (double)(rw.W / rw.C);
  for (int c = threadIdx.x; c < rw.C; c += blockDim.x) {
    const double a = red[c], b = red[rw.C + c];
    dparams[c] = (float)b;          // dweight
    dparams[rw.C + c] = (float)a;   // dbias
    dparams[2 * rw.C + c] = training ? (float)(a / n) : 0.0f;
    dparams[3 * rw.C + c] = training ? __fmul_rn(clamp[c], (float)(b / n)) : 0.0f;
  }
}

// Backward, pass 2: dx, each thread walking its rows last to first.
template <typename T, int V, int GRAD>
__global__ void __launch_bounds__(max_threads<V>())
backward_apply_kernel(const T* __restrict__ dy, long long dy_rs, const T* __restrict__ x,
                      const T* __restrict__ res, T* __restrict__ dx,
                      const float* __restrict__ mean, const float* __restrict__ var,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      const float* __restrict__ dparams, float eps, Rows rw,
                      int training) {
  __shared__ __align__(16) float ks[kConsts][kMaxC];
  channel_consts<T>(mean, var, w, bias, eps, rw.C, ks);
  int g, p0;
  if (!lane_of<V>(rw, &g, &p0)) return;
  const Walk k = walk_of(rw, g);
  if (!k.any) return;
  Lane<T, V> lane;
  lane.load(ks, p0, rw.C, true);
  float ca[V], cb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = (p0 + v) % rw.C;
    ca[v] = dparams[2 * rw.C + c];
    cb[v] = dparams[3 * rw.C + c];
  }
  constexpr bool with_res = GRAD == kAddRelu;
  const long long step = (long long)unroll_bwd<GRAD>() * rw.G;
  for (long long r = k.last; r >= k.first; r -= step) {
    Vec<T, V> xv[unroll_bwd<GRAD>()], dv[unroll_bwd<GRAD>()], rv[unroll_bwd<GRAD>()];
#pragma unroll
    for (int u = 0; u < unroll_bwd<GRAD>(); ++u) {
      const long long m = r - (long long)u * rw.G;
      if (m >= k.first) {
        xv[u].load(x + m * rw.S + p0);
        dv[u].load(dy + m * dy_rs + p0);
        if (with_res) rv[u].load(res + m * rw.S + p0);
      }
    }
#pragma unroll
    for (int u = 0; u < unroll_bwd<GRAD>(); ++u) {
      const long long m = r - (long long)u * rw.G;
      if (m < k.first) break;
      const Vec<T, V> z = lane.normalise_vec(xv[u]);
      float out[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float dz = epilogue_grad(dv[u].get(v), z.get(v),
                                       with_res ? rv[u].get(v) : 0.0f, GRAD);
        if (training) {
          const float xhat = __fmul_rn(__fsub_rn(xv[u].get(v), lane.mu[v]), lane.rstd[v]);
          out[v] = __fmul_rn(lane.mul[v],
                             __fsub_rn(__fsub_rn(dz, ca[v]), __fmul_rn(xhat, cb[v])));
        } else {
          out[v] = __fmul_rn(lane.mul[v], dz);
        }
      }
      Vec<T, V> o;
      o.set(out);
      o.store(dx + m * rw.S + p0);
    }
  }
}

// The launch shape the wrapper planned: V values a thread, fold rows of C channels
// a kernel row, G row groups, threads a block, R kernel rows a block, blocks.
struct Plan {
  Rows rw;
  int V, threads, blocks;
};

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (uintptr_t)(bytes - 1)) == 0; }

// The plan of the arguments, if the kernels can take it (else false): M rows of C
// channels, ld values apart, fold of them a kernel row of fold C values, a
// multiple of V (fold > 1 only for dense rows, ld = C).
template <typename T>
bool plan_of(long long M, int C, long long ld, int V, int fold, int G, int threads,
             long long R, int blocks, std::initializer_list<const void*> ptrs, Plan* p) {
  const int bytes = V * (int)sizeof(T);
  if (V < 1 || bytes > 16 || (V & (V - 1)) || ld < C || (fold == 1 ? ld % V != 0 : ld != C)
      || C > kMaxC || fold < 1 || M % fold
      || (fold * C) % V || fold * C > kMaxC * 8 || G < 1 || blocks < 1
      || blocks > kGroup * kMaxGroups || threads > (V == 1 ? 1024 : 512)
      || threads < G * (fold * C / V)
      || (long long)blocks * R < M / fold)
    return false;
  for (const void* q : ptrs)
    if (q && !aligned(q, bytes)) return false;
  p->rw.M = M / fold;
  p->rw.R = R;
  p->rw.W = fold * C;
  p->rw.S = fold * ld;
  p->rw.C = C;
  p->rw.G = G;
  p->V = V;
  p->threads = threads;
  p->blocks = blocks;
  return true;
}

template <typename T, int V, int POST>
int forward_v(const Plan& p, const void* x, const void* res, void* y, float* mean, float* var,
              float* clamp, float* running_mean, float* running_var, const float* w,
              const float* bias, double* partial, float eps, float momentum, int training,
              cudaStream_t st) {
  if (training) {
    stats_kernel<T, V><<<p.blocks, p.threads, 0, st>>>(
        (const T*)x, p.rw, partial, mean, var, clamp, running_mean, running_var, momentum,
        (float)(1.0 - (double)momentum));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  apply_kernel<T, V, POST><<<p.blocks, p.threads, 0, st>>>(
      (const T*)x, (const T*)res, (T*)y, mean, var, w, bias, eps, p.rw);
  return (int)cudaGetLastError();
}

template <typename T, int V, int GRAD>
int backward_v(const Plan& p, const void* dy, long long dy_rs, const void* x, const void* res,
               void* dx, void* dres, const float* mean, const float* var, const float* clamp,
               const float* w, const float* bias, float* dparams, double* partial, float eps,
               int training, cudaStream_t st) {
  backward_reduce_kernel<T, V, GRAD><<<p.blocks, p.threads, 0, st>>>(
      (const T*)dy, dy_rs, (const T*)x, (const T*)res, (T*)dres, mean, var, w, bias, clamp,
      eps, p.rw, training, partial, dparams);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  backward_apply_kernel<T, V, GRAD><<<p.blocks, p.threads, 0, st>>>(
      (const T*)dy, dy_rs, (const T*)x, (const T*)res, (T*)dx, mean, var, w, bias, dparams,
      eps, p.rw, training);
  return (int)cudaGetLastError();
}

// F(V) over the vector widths a T allows (16 bytes at most)
template <typename T, typename F>
int by_width(int V, F&& f) {
  switch (V) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8:
      if constexpr (sizeof(T) == 2) return f(std::integral_constant<int, 8>());
      [[fallthrough]];
    default: return (int)cudaErrorInvalidValue;
  }
}

// F(POST) over the epilogues
template <typename F>
int by_post(int post, F&& f) {
  switch (post) {
    case kNone: return f(std::integral_constant<int, kNone>());
    case kRelu: return f(std::integral_constant<int, kRelu>());
    case kSwish: return f(std::integral_constant<int, kSwish>());
    case kAdd: return f(std::integral_constant<int, kAdd>());
    case kAddRelu: return f(std::integral_constant<int, kAddRelu>());
    case kReluAdd: return f(std::integral_constant<int, kReluAdd>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// F(GRAD) over the epilogues' gradients: add passes dy on as none does, relu_add
// as relu does
template <typename F>
int by_grad(int post, F&& f) {
  switch (post) {
    case kNone:
    case kAdd: return f(std::integral_constant<int, kNone>());
    case kRelu:
    case kReluAdd: return f(std::integral_constant<int, kRelu>());
    case kSwish: return f(std::integral_constant<int, kSwish>());
    case kAddRelu: return f(std::integral_constant<int, kAddRelu>());
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int forward_t(const void* x, const void* res, void* y, float* mean, float* var, float* clamp,
              float* running_mean, float* running_var, const float* w, const float* bias,
              double* partial, long long M, int C, int V, int fold, int G, int threads,
              long long R, int blocks, float eps, float momentum, int training, int post,
              cudaStream_t st, long long ld) {
  Plan p;
  if (!plan_of<T>(M, C, ld, V, fold, G, threads, R, blocks, {x, res, y}, &p))
    return (int)cudaErrorInvalidValue;
  return by_width<T>(V, [&](auto v) {
    return by_post(post, [&](auto e) {
      return forward_v<T, decltype(v)::value, decltype(e)::value>(
          p, x, res, y, mean, var, clamp, running_mean, running_var, w, bias, partial, eps,
          momentum, training, st);
    });
  });
}

template <typename T>
int backward_t(const void* dy, long long dy_rs, const void* x, const void* res, void* dx,
               void* dres, const float* mean, const float* var, const float* clamp,
               const float* w, const float* bias, float* dparams, double* partial,
               long long M, int C, int V, int fold, int G, int threads, long long R,
               int blocks, float eps, int training, int post, cudaStream_t st,
               long long ld) {
  Plan p;
  if (dy_rs < C || (fold == 1 ? dy_rs % V != 0 : dy_rs != C)
      || !plan_of<T>(M, C, ld, V, fold, G, threads, R, blocks, {dy, x, res, dx, dres}, &p))
    return (int)cudaErrorInvalidValue;
  const long long dy_row = fold > 1 ? p.rw.W : dy_rs;   // a kernel row of dy
  return by_width<T>(V, [&](auto v) {
    return by_grad(post, [&](auto e) {
      return backward_v<T, decltype(v)::value, decltype(e)::value>(
          p, dy, dy_row, x, res, dx, dres, mean, var, clamp, w, bias, dparams, partial, eps,
          training, st);
    });
  });
}

}  // namespace

// x, res, y: M rows of C channels, row m at m * ld (ld = C: contiguous; more: a
// channel slice of wider rows, with C <= 1024), res may be null, float32 or bfloat16;
// mean, var, clamp: (C,) f32, written in training (clamp may be null in eval), read
// in eval (the running statistics); running_mean, running_var: (C,) f32, updated in
// training; w, bias: (C,) f32; partial: (blocks + ceil(blocks / 8), 2, C) f64
// scratch (training);
// the plan (ops/batch_norm.py `grid`): V values a thread (x, res, y aligned to V
// elements), fold rows a kernel row (fold C a multiple of V, M a multiple of fold),
// G row groups and `threads` threads a block, R kernel rows a block, blocks;
// post: 0 none, 1 relu, 2 swish, 3 add, 4 add_relu, 5 relu_add; ld last.
// Returns the first launch's error (cudaGetLastError() after each launch), or
// cudaErrorInvalidValue for a plan the kernels cannot take.
extern "C" int fiery_batch_norm_forward(const void* x, const void* res, void* y, float* mean,
                                        float* var, float* clamp, float* running_mean,
                                        float* running_var, const float* w,
                                        const float* bias, double* partial, long long M,
                                        int C, int V, int fold, int G, int threads,
                                        long long R, int blocks, float eps, float momentum,
                                        int training, int post, int is_bf16, void* stream,
                                        long long ld) {
  if (M == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? forward_t<__nv_bfloat16>(x, res, y, mean, var, clamp, running_mean,
                                            running_var, w, bias, partial, M, C, V, fold, G,
                                            threads, R, blocks, eps, momentum, training, post,
                                            st, ld)
                 : forward_t<float>(x, res, y, mean, var, clamp, running_mean, running_var, w,
                                    bias, partial, M, C, V, fold, G, threads, R, blocks, eps,
                                    momentum, training, post, st, ld);
}

// dy: M rows of C channels, row m at m * dy_rs (dy_rs >= C, a multiple of V; C when
// fold > 1); x, res, dx, dres: M rows of C channels, row m at m * ld (res and dres
// for add_relu only, else null); mean, var: the statistics the forward used; clamp:
// (C,) f32 (training); dparams: (4, C) f32 out: dweight, dbias and two
// coefficients of dx; partial: as for the forward; the plan as for the
// forward. Returns as the forward does.
extern "C" int fiery_batch_norm_backward(const void* dy, long long dy_rs, const void* x,
                                         const void* res, void* dx, void* dres,
                                         const float* mean, const float* var,
                                         const float* clamp, const float* w,
                                         const float* bias, float* dparams, double* partial,
                                         long long M, int C, int V, int fold, int G,
                                         int threads, long long R, int blocks, float eps,
                                         int training, int post, int is_bf16, void* stream,
                                         long long ld) {
  if (M == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? backward_t<__nv_bfloat16>(dy, dy_rs, x, res, dx, dres, mean, var, clamp, w,
                                             bias, dparams, partial, M, C, V, fold, G, threads,
                                             R, blocks, eps, training, post, st, ld)
                 : backward_t<float>(dy, dy_rs, x, res, dx, dres, mean, var, clamp, w, bias,
                                     dparams, partial, M, C, V, fold, G, threads, R, blocks,
                                     eps, training, post, st, ld);
}
