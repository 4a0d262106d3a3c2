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
// +0.0 are distinct keys). A bf16 weight takes the key of its f32 upcast, whose
// order and ties are those of its 16-bit key.
// Bin d is selected iff its position in the order (key descending, bin index
// ascending), pos_d = #{e : key_e > key_d} + #{e < d : key_e == key_d}, is below k;
// that is the set `_topk_select_nosort` forms from the exact k-th key.
//
// Bound on an H100: bytes. At the combo's serve shapes (3 samples x 6 cameras x
// 28 x 60 = 30,240 pixels, D = 48, k = 8, bf16) it reads 96 B of depth and 192 B
// of ids per pixel and writes 16 + 32 + 8 B: ~10.4 MB, 3.1 us at 3.35 TB/s; the
// ~D^2 = 2,304 key comparisons per pixel (70 M, integer) are far below the rate.
//
// Design: one warp per pixel; lane l holds the keys of bins l and l + 32 (D <= 64).
// Each lane counts pos for its two bins over all D keys, which it receives by
// warp shuffles (D shuffles a pixel, no shared memory, no atomics); a ballot of the
// selected bins and a popcount of the lanes below give each selected bin its slot.
// Values are copied as raw bits, so the selection and the outputs are exact.
//
// Backward (fiery_topk_select_backward). Replaces the transpose of the selection in
// the JAX gradient of `lift_splat_topk` (the one-hot sum's VJP):
//     d_depth[p, idx[p, j]] = g[p, j], and 0 at the unselected bins.
// Bound: bytes, ~120 B a pixel at the training shape (90,720 pixels, bf16): read g
// (16 B) and idx (8 B), write d_depth (96 B); 10.9 MB, 3.2 us.
// Design: one thread per (pixel, bin), which looks its bin up among the pixel's k
// slots (broadcast reads) and writes its d_depth value, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, one pixel each
constexpr int kMaxBins = 64;    // two bins a lane

__device__ __forceinline__ unsigned bits32(uint32_t raw) { return raw; }
__device__ __forceinline__ unsigned bits32(uint16_t raw) { return (unsigned)raw << 16; }

__device__ __forceinline__ unsigned order_key(unsigned bits) {
  return (bits >> 31) == 0 ? (bits | 0x80000000u) : ~bits;
}

// T: the raw storage of the weights (uint16_t for bf16, uint32_t for f32)
template <typename T>
__global__ void topk_select_kernel(const T* __restrict__ depth, const int32_t* __restrict__ ids,
                                   T* __restrict__ top_w, int32_t* __restrict__ ids_k,
                                   uint8_t* __restrict__ idx, int64_t n_pix, int D, int k) {
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_pix) return;   // the whole warp leaves together
  const T* dp = depth + p * D;
  const int d_lo = lane, d_hi = lane + 32;
  const bool has_lo = d_lo < D, has_hi = d_hi < D;
  const T raw_lo = has_lo ? dp[d_lo] : T(0);
  const T raw_hi = has_hi ? dp[d_hi] : T(0);
  const unsigned key_lo = order_key(bits32(raw_lo));
  const unsigned key_hi = order_key(bits32(raw_hi));
  int pos_lo = 0, pos_hi = 0;
  for (int e = 0; e < D; ++e) {
    // e is the same in every lane, so every lane sends the same register
    const unsigned key_e = __shfl_sync(0xffffffffu, e < 32 ? key_lo : key_hi, e & 31);
    pos_lo += (key_e > key_lo) | ((key_e == key_lo) & (e < d_lo));
    pos_hi += (key_e > key_hi) | ((key_e == key_hi) & (e < d_hi));
  }
  const bool sel_lo = has_lo && pos_lo < k;
  const bool sel_hi = has_hi && pos_hi < k;
  const unsigned ballot_lo = __ballot_sync(0xffffffffu, sel_lo);
  const unsigned ballot_hi = __ballot_sync(0xffffffffu, sel_hi);
  const unsigned below = (1u << lane) - 1u;
  const int64_t out = p * k;
  if (sel_lo) {
    const int slot = __popc(ballot_lo & below);
    top_w[out + slot] = raw_lo;
    ids_k[out + slot] = ids[p * D + d_lo];
    idx[out + slot] = (uint8_t)d_lo;
  }
  if (sel_hi) {
    const int slot = __popc(ballot_lo) + __popc(ballot_hi & below);
    top_w[out + slot] = raw_hi;
    ids_k[out + slot] = ids[p * D + d_hi];
    idx[out + slot] = (uint8_t)d_hi;
  }
}

template <typename T>
__global__ void topk_select_backward_kernel(const T* __restrict__ g,
                                            const uint8_t* __restrict__ idx,
                                            T* __restrict__ d_depth, int64_t n_pix, int D,
                                            int k) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pix * D) return;
  const int64_t p = t / D;
  const int d = (int)(t - p * D);
  const uint8_t* ip = idx + p * k;
  T v = T(0);
  for (int j = 0; j < k; ++j) {
    if (ip[j] == d) v = g[p * k + j];
  }
  d_depth[t] = v;
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
  const unsigned blocks = (unsigned)((n_pix * 32 + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    topk_select_kernel<uint16_t><<<blocks, kThreads, 0, st>>>(
        (const uint16_t*)depth, (const int32_t*)ids, (uint16_t*)top_w, (int32_t*)ids_k,
        (uint8_t*)idx, n_pix, D, k);
  } else {
    topk_select_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)depth, (const int32_t*)ids, (uint32_t*)top_w, (int32_t*)ids_k,
        (uint8_t*)idx, n_pix, D, k);
  }
  return (int)cudaGetLastError();
}

// g: (n_pix, k) contiguous float32 or bfloat16; idx: (n_pix, k) uint8 from
// fiery_topk_select; d_depth: (n_pix, D) of g's dtype (every value is written).
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_topk_select_backward(const void* g, const void* idx, void* d_depth,
                                          long long n_pix, int D, int k, int is_bf16,
                                          void* stream) {
  if (D < 1 || D > kMaxBins || k < 1 || k > D) return (int)cudaErrorInvalidValue;
  const long long total = n_pix * (long long)D;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    topk_select_backward_kernel<uint16_t><<<blocks, kThreads, 0, st>>>(
        (const uint16_t*)g, (const uint8_t*)idx, (uint16_t*)d_depth, n_pix, D, k);
  } else {
    topk_select_backward_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)g, (const uint8_t*)idx, (uint32_t*)d_depth, n_pix, D, k);
  }
  return (int)cudaGetLastError();
}
