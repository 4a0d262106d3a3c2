// kth_largest: the exact k-th largest value of each row of a float32 matrix, by radix
// select on the values' bits.
//
// Replaces: fiery_tpu/training/losses.py `_kth_largest` (8 levels of 4-bit dense
// histograms over order-preserving uint32 keys), which feeds `_top_k_mean`, the
// top-k hardest-pixel mean of the segmentation loss (SEMANTIC_SEG.USE_TOP_K).
//
// Computes, for each row r of x (rows, n): out[r] = the k-th largest x[r, :], ties
// counted with multiplicity (torch.topk(x, k).values[:, -1]). Floats map to uint32
// keys whose unsigned order is the float order (non-negative: set the sign bit;
// negative: flip every bit); four passes each fix 8 more bits of the k-th key:
// a 256-bin histogram of the keys that share the bits fixed so far, then the bin
// in which the remaining rank falls.
//
// Bound on an H100: bytes. At the training shape (15 rows of 40,000 f32, k =
// 10,000) the input is 2.4 MB and the output 60 bytes; the ~4 integer operations
// per element and pass are ~2.4 M operations. The simple design reads each row
// four times (from L2 after the first pass) and runs one block per row, so 15 of
// the card's 132 SMs work; latency, not bandwidth, bounds it.
//
// Design: one block of 1024 threads per row. Each pass zeroes a 256-bin histogram
// in shared memory, every thread strides over the row and adds its matching keys
// with shared-memory atomics, then warp 0 finds the bin: lane l sums bins
// 255 - 8l .. 248 - 8l, a warp prefix sum (shuffles) over the lanes gives the
// count above each lane's bins, and the lane whose range holds the rank walks its
// 8 bins. Integer counts make the result exact and independent of the order of
// the atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) == 0 ? (bits | 0x80000000u) : ~bits;
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key >> 31) == 1 ? (key ^ 0x80000000u) : ~key);
}

__global__ void kth_largest_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   int64_t n, unsigned k) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_rank;
  const float* row = x + (int64_t)blockIdx.x * n;
  unsigned prefix = 0, rank = k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned high = pass == 0 ? 0u : (0xFFFFFFFFu << (shift + 8));
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned u = order_key(row[i]);
      if ((u & high) == prefix) atomicAdd(&hist[(u >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) local += hist[255 - 8 * lane - j];
      unsigned incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const unsigned above = incl - local;   // keys in the bins above this lane's
      if (above < rank && rank <= incl) {
        unsigned cum = above;
        for (int j = 0; j < 8; ++j) {
          const unsigned b = 255 - 8 * lane - j;
          if (cum + hist[b] >= rank) {
            s_prefix = prefix | (b << shift);
            s_rank = rank - cum;
            break;
          }
          cum += hist[b];
        }
      }
    }
    __syncthreads();
    // every thread reads the new prefix before the next pass's first barrier, and
    // warp 0 writes it again only after that pass's second one
    prefix = s_prefix;
    rank = s_rank;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = key_value(prefix);
}

}  // namespace

// x: (rows, n) contiguous float32; out: (rows,) float32; 1 <= k <= n.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_kth_largest(const void* x, void* out, int rows, long long n, int k,
                                 void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (k < 1 || (long long)k > n) return (int)cudaErrorInvalidValue;
  kth_largest_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (int64_t)n, (unsigned)k);
  return (int)cudaGetLastError();
}
