// topk_select: the exact top-k depth bins of each frustum pixel, compacted into k
// slots, for the sparse top-k splat (LIFT.TOPK).
//
// Replaces: fiery_tpu/ops/lift_splat.py `_topk_select_nosort` (with `_order_bits`
// and `_kth_largest_bits`), reached through `lift_splat_topk`: a 4-bit radix
// descent to the k-th largest depth weight of each pixel, then a rank compaction
// of the selected bins.
//
// Computes, for each pixel p of D depth weights depth[p, :] and voxel ids
// ids[p, :]: the set of the k largest weights, where all weights above the k-th
// largest are taken and ties at the k-th value take the lowest bin indices (the
// stable rule of lax.top_k); the selected bins go to slots 0..k-1 in ascending bin
// order:
//     top_w[p, j] = depth[p, d_j],  ids_k[p, j] = ids[p, d_j],  idx[p, j] = d_j.
// Weights are ordered by the JAX package's order key: the float's bits with the
// sign bit set for values >= 0 and all bits flipped for negative ones (so -0.0 and
// +0.0 are distinct keys), 16 bits wide for bf16 and 32 for f32.
// Bin d is selected iff its position in the order (key descending, bin index
// ascending), pos_d = #{e : key_e > key_d} + #{e < d : key_e == key_d}, is below k;
// that is the set `_topk_select_nosort` forms from the exact k-th key.
//
// Bound on an H100: bytes. At the combo's serve shapes (3 samples x 6 cameras x
// 28 x 60 = 30,240 pixels, D = 48, k = 8, bf16) it reads 96 B of depth and 192 B
// of ids per pixel and writes 16 + 32 + 8 B: ~10.4 MB, 3.1 us at 3.35 TB/s. The
// selection below costs D x (key bits) integer compares a pixel (768 in bf16, 1,536
// in f32; 23 M and 46 M at the serve shape), far below the card's rate.
//
// Design. The first design spent a warp on a pixel and walked all D keys by
// shuffles, O(D^2) compares, and was issue-bound at 10x its byte bound. Here one
// thread takes a pixel, kPixels = 64 pixels a block, with no shared memory.
//   1. A thread reads its pixel's D weights into registers as order keys, by 16-byte
//      loads where the rows allow it (D x 2 or D x 4 bytes a multiple of 16), all
//      issued at once; registers past D hold key 0. Thread 0 first asks L2 for the
//      block's voxel ids (one bulk prefetch), which are read only after step 3.
//   2. The k-th largest key, bit by bit from the top: cand = kth | bit is kept when
//      #{key >= cand} >= k (16 steps in bf16, whose keys are 16 bits wide as
//      `_order_bits` makes them, 32 in f32). cand >= 1, so the padding's key 0 is
//      never counted.
//   3. The selected set as a 64-bit mask over the bins: every bin above the key,
//      and the lowest k - #{above} bins at the key (bins < D only).
//   4. The slots in ascending bin order, by peeling the mask's lowest bit: the
//      weight read again at the selected bin (from L1), the voxel id gathered there
//      (from L2), written 8 slots at a time as 16-, 32- and 8-byte vector stores
//      (scalar stores when k is not a multiple of 8).
// The register loops are unrolled to MAXD (D rounded up to 16, 32, 48 or 64), so D
// is a runtime argument (fishing_setting.yml has D = 28).
//
// Backward (fiery_topk_select_backward). Replaces the transpose of the selection in
// the JAX gradient of `lift_splat_topk` (the one-hot sum's VJP):
//     d_depth[p, idx[p, j]] = g[p, j], and 0 at the unselected bins.
// Bound: bytes, ~120 B a pixel at the training shape (90,720 pixels, bf16): read g
// (16 B) and idx (8 B), write d_depth (96 B); 10.9 MB, 3.2 us.
// Design: a block takes kBwdPixels = 128 consecutive pixels, whose d_depth rows are
// one contiguous span of 128 x D values. It zeroes a shared tile of that span, reads
// the pixels' k slots once (the block's g and idx are contiguous spans too, read a
// value a thread, coalesced), writes each g value into the tile at its bin, and
// copies the tile out with 16-byte stores (whole 16-byte words of the span; the
// values past the last whole word, and every value when d_depth is not 16-byte
// aligned, one at a time). A slot's pixel within the block is e / k, taken as a
// multiply-high by ceil(2^32 / k), exact for e < 2^32 / k; no division per value.
// The idx of a pixel are distinct (K5 forward writes them in ascending bin order),
// so the writes into the tile never collide.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 64;      // forward: a thread a pixel
constexpr int kBwdPixels = 128;  // backward: pixels a block
constexpr int kBwdThreads = 256;
constexpr int kMaxBins = 64;

// The JAX package's order key in the weight's native width (`_order_bits`): the
// sign bit set for values >= 0, every bit flipped for negative ones.
__device__ __forceinline__ unsigned order_key(uint16_t raw) {
  return (raw >> 15) == 0 ? (raw | 0x8000u) : (~(unsigned)raw & 0xFFFFu);
}
__device__ __forceinline__ unsigned order_key(uint32_t raw) {
  return (raw >> 31) == 0 ? (raw | 0x80000000u) : ~raw;
}

// Weight d of a row held as 32-bit words.
template <typename T>
__device__ __forceinline__ T weight(const unsigned* words, int d) {
  if constexpr (sizeof(T) == 4) {
    return words[d];
  } else {
    return (T)(words[d >> 1] >> (16 * (d & 1)));
  }
}

// T: the raw storage of the weights (uint16_t for bf16, uint32_t for f32); MAXD: D
// rounded up to a multiple of 16; VEC: rows of whole 16-byte words at 16-byte
// alignment, read as such (else a weight at a time); vec_out: k % 8 == 0 and the
// outputs 16-byte aligned.
template <typename T, int MAXD, bool VEC>
__global__ void __launch_bounds__(kPixels)
topk_select_kernel(const T* __restrict__ depth, const int32_t* __restrict__ ids,
                   T* __restrict__ top_w, int32_t* __restrict__ ids_k, uint8_t* __restrict__ idx,
                   int64_t n_pix, int D, int k, bool vec_out) {
  const int64_t p0 = (int64_t)blockIdx.x * kPixels;
  if (threadIdx.x == 0) {
    // the block's voxel ids are read at the selected bins only, after the selection:
    // start them on their way to L2 now (a hint; whole 16-byte words)
    const int64_t bytes = (n_pix - p0 < kPixels ? n_pix - p0 : kPixels) * D * 4;
    const int32_t* start = ids + p0 * D;
    if ((((uintptr_t)start) & 15) == 0 && bytes >= 16)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(start),
                   "r"((unsigned)(bytes & ~15LL))
                   : "memory");
  }
  const int64_t p = p0 + threadIdx.x;
  if (p >= n_pix) return;
  const T* row = depth + p * D;
  unsigned key[MAXD];
  if constexpr (VEC) {
    constexpr int WORDS = MAXD * (int)sizeof(T) / 4;
    unsigned words[WORDS];
    const int live = D * (int)sizeof(T) / 16;
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 q = i < live ? reinterpret_cast<const uint4*>(row)[i] : make_uint4(0, 0, 0, 0);
      words[4 * i] = q.x, words[4 * i + 1] = q.y, words[4 * i + 2] = q.z, words[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d) key[d] = d < D ? order_key(weight<T>(words, d)) : 0u;
  } else {
#pragma unroll
    for (int d = 0; d < MAXD; ++d) key[d] = d < D ? order_key(row[d]) : 0u;
  }

  unsigned kth = 0;
#pragma unroll 1
  for (int bit = 8 * (int)sizeof(T) - 1; bit >= 0; --bit) {
    const unsigned cand = kth | (1u << bit);
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int d = 0; d < MAXD; d += 4) {
      c0 += key[d] >= cand;
      c1 += key[d + 1] >= cand;
      c2 += key[d + 2] >= cand;
      c3 += key[d + 3] >= cand;
    }
    if (c0 + c1 + c2 + c3 >= k) kth = cand;
  }

  unsigned long long gt = 0, eq = 0;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    gt |= (unsigned long long)(key[d] > kth) << d;
    eq |= (unsigned long long)(key[d] == kth) << d;
  }
  eq &= D == 64 ? ~0ull : (1ull << D) - 1ull;   // the padding's key 0 may equal kth
  unsigned long long sel = gt;
  for (int t = k - __popcll(gt); t > 0; --t) {   // the lowest ties
    sel |= eq & (0ull - eq);
    eq &= eq - 1ull;
  }

  const int32_t* id_row = ids + p * D;
  for (int j0 = 0; j0 < k; j0 += 8) {
    alignas(16) T w[8];
    alignas(16) int32_t id[8];
    alignas(8) uint8_t ix[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = T(0), id[j] = 0, ix[j] = 0;
      if (j0 + j < k) {   // past the k-th slot the mask is empty
        const int d = __ffsll((long long)sel) - 1;
        sel &= sel - 1ull;
        w[j] = row[d];   // read above: from L1
        id[j] = id_row[d];
        ix[j] = (uint8_t)d;
      }
    }
    const int64_t o = p * k + j0;
    if (vec_out) {
#pragma unroll
      for (int v = 0; v < (int)sizeof(w) / 16; ++v)
        reinterpret_cast<uint4*>(top_w + o)[v] = reinterpret_cast<const uint4*>(w)[v];
      reinterpret_cast<int4*>(ids_k + o)[0] = reinterpret_cast<const int4*>(id)[0];
      reinterpret_cast<int4*>(ids_k + o)[1] = reinterpret_cast<const int4*>(id)[1];
      *reinterpret_cast<uint2*>(idx + o) = *reinterpret_cast<const uint2*>(ix);
    } else {
      for (int j = 0; j < 8 && j0 + j < k; ++j) {
        top_w[o + j] = w[j];
        ids_k[o + j] = id[j];
        idx[o + j] = ix[j];
      }
    }
  }
}

// T: the raw storage of g and d_depth (uint16_t for bf16, uint32_t for f32); k_inv:
// ceil(2^32 / k) (k > 1); vec: d_depth is 16-byte aligned, so every block's span is.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
topk_select_backward_kernel(const T* __restrict__ g, const uint8_t* __restrict__ idx,
                            T* __restrict__ d_depth, int64_t n_pix, int D, int k,
                            unsigned k_inv, bool vec) {
  __shared__ uint4 tile_words[kBwdPixels * kMaxBins * sizeof(T) / 16];
  T* tile = reinterpret_cast<T*>(tile_words);
  const int64_t p0 = (int64_t)blockIdx.x * kBwdPixels;
  const int np = n_pix - p0 < kBwdPixels ? (int)(n_pix - p0) : kBwdPixels;
  const int values = np * D;
  const int bytes = values * (int)sizeof(T);
  for (int i = threadIdx.x; i < (bytes + 15) / 16; i += kBwdThreads)
    tile_words[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const T* gp = g + p0 * k;
  const uint8_t* ip = idx + p0 * k;
#pragma unroll 4
  for (int e = threadIdx.x; e < np * k; e += kBwdThreads) {
    const int p = k == 1 ? e : (int)__umulhi((unsigned)e, k_inv);
    const int d = ip[e];
    if (d < D) tile[p * D + d] = gp[e];
  }
  __syncthreads();
  T* out = d_depth + p0 * D;
  const int words = vec ? bytes / 16 : 0;
  for (int i = threadIdx.x; i < words; i += kBwdThreads)
    reinterpret_cast<uint4*>(out)[i] = tile_words[i];
  for (int v = words * (16 / (int)sizeof(T)) + threadIdx.x; v < values; v += kBwdThreads)
    out[v] = tile[v];
}

}  // namespace

// depth: (n_pix, D) contiguous float32 or bfloat16; ids: (n_pix, D) int32;
// top_w: (n_pix, k) of depth's dtype, ids_k: (n_pix, k) int32, idx: (n_pix, k)
// uint8 (every value is written). 1 <= k <= D <= 64. Returns cudaGetLastError()
// after the launch.
extern "C" int fiery_topk_select(const void* depth, const void* ids, void* top_w, void* ids_k,
                                 void* idx, long long n_pix, int D, int k, int is_bf16,
                                 void* stream) {
  if (D < 1 || D > kMaxBins || k < 1 || k > D) return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  const long long blocks = (n_pix + kPixels - 1) / kPixels;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec_out =
      k % 8 == 0 && (((uintptr_t)top_w | (uintptr_t)ids_k | (uintptr_t)idx) & 15) == 0;
  const int es = is_bf16 ? 2 : 4;
  const bool vec_in = (D * es) % 16 == 0 && ((uintptr_t)depth & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int maxd = (D + 15) / 16 * 16;
#define FIERY_TOPK_LAUNCH(T, M, V)                                                           \
  topk_select_kernel<T, M, V><<<(unsigned)blocks, kPixels, 0, st>>>(                          \
      (const T*)depth, (const int32_t*)ids, (T*)top_w, (int32_t*)ids_k, (uint8_t*)idx, n_pix, \
      D, k, vec_out)
#define FIERY_TOPK_WIDTHS(T, V)                  \
  switch (maxd) {                                \
    case 16: FIERY_TOPK_LAUNCH(T, 16, V); break; \
    case 32: FIERY_TOPK_LAUNCH(T, 32, V); break; \
    case 48: FIERY_TOPK_LAUNCH(T, 48, V); break; \
    default: FIERY_TOPK_LAUNCH(T, 64, V); break; \
  }
  if (is_bf16 && vec_in) {
    FIERY_TOPK_WIDTHS(uint16_t, true)
  } else if (is_bf16) {
    FIERY_TOPK_WIDTHS(uint16_t, false)
  } else if (vec_in) {
    FIERY_TOPK_WIDTHS(uint32_t, true)
  } else {
    FIERY_TOPK_WIDTHS(uint32_t, false)
  }
#undef FIERY_TOPK_WIDTHS
#undef FIERY_TOPK_LAUNCH
  return (int)cudaGetLastError();
}

// g: (n_pix, k) contiguous float32 or bfloat16; idx: (n_pix, k) uint8 from
// fiery_topk_select; d_depth: (n_pix, D) of g's dtype (every value is written).
// 1 <= k <= D <= 64. Returns cudaGetLastError() after the launch.
extern "C" int fiery_topk_select_backward(const void* g, const void* idx, void* d_depth,
                                          long long n_pix, int D, int k, int is_bf16,
                                          void* stream) {
  if (D < 1 || D > kMaxBins || k < 1 || k > D || n_pix < 0) return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return (int)cudaSuccess;
  const long long blocks = (n_pix + kBwdPixels - 1) / kBwdPixels;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned k_inv = k == 1 ? 0u : (unsigned)(((1ull << 32) + k - 1) / k);
  const bool vec = ((uintptr_t)d_depth & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    topk_select_backward_kernel<uint16_t><<<(unsigned)blocks, kBwdThreads, 0, st>>>(
        (const uint16_t*)g, (const uint8_t*)idx, (uint16_t*)d_depth, n_pix, D, k, k_inv, vec);
  } else {
    topk_select_backward_kernel<uint32_t><<<(unsigned)blocks, kBwdThreads, 0, st>>>(
        (const uint32_t*)g, (const uint8_t*)idx, (uint32_t*)d_depth, n_pix, D, k, k_inv, vec);
  }
  return (int)cudaGetLastError();
}
