// instance_centers: thresholded 3x3 max-pool NMS of the centre heatmap and an exact
// top-k of the surviving peaks, one frame per block.
//
// Replaces: fiery_tpu/postprocess/instance.py `find_instance_centers` with
// `_top_k_scores_nosort` (radix select of the k-th largest order-mapped key, rank
// compaction of the selected pixels, one k-element ordering sort).
//
// Computes, per frame of an (h, w) f32 heatmap:
//     x = c >= thr ? c : -1;  pooled = max of x over the (2p+1)^2 window (-inf outside)
//     score = (x == pooled && x > 0) ? x : -inf
//     the k largest scores in lax.top_k's order: descending, ties by lowest pixel
//     index (the -inf padding included); centre = (index / w, index % w),
//     valid = score > 0.
//
// Bound on an H100: bytes. At the serve shape (5 frames of 200 x 200) the kernel must
// read 0.8 MB of heatmap and write 4.5 KB; the 9 compares per pixel are negligible.
// It is far from that bound by design: one block per frame (5 blocks on 132 SMs), and
// the frame's keys are re-read from an L2-resident scratch once per radix level.
//
// Design: pass 1 writes each pixel's order-mapped score key to a scratch buffer.
// Pass 2 finds the exact k-th largest key by a 4-level, 8-bit radix descent
// (shared-memory histogram, block scan to find the digit). Pass 3 walks the pixels in
// order, 1024 at a time, with one block scan of packed (greater, equal) counts, and
// writes the k selected (key, index) pairs to shared memory: all keys greater than
// the k-th, then the first k - n_greater keys equal to it. Pass 4 orders the k
// survivors by counting ranks (key descending, index ascending), O(k^2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_K = 1024;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b >> 31) == 0 ? (b | 0x80000000u) : ~b;
}

__device__ __forceinline__ float thresholded(float c, float thr) { return c >= thr ? c : -1.0f; }

// Inclusive scan of x over the block (blockDim.x == THREADS); *total = block sum.
__device__ int block_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  *total = warp_sums[31];
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(THREADS)
centers_kernel(const float* __restrict__ heat, uint32_t* __restrict__ keys,
               int* __restrict__ centers, uint8_t* __restrict__ valid, int h, int w,
               float thr, int pad, int k) {
  __shared__ int warp_sums[32];
  __shared__ int hist[256];
  __shared__ uint32_t s_prefix, s_mask;
  __shared__ int s_rank, s_bstar, s_cgt;
  __shared__ uint32_t sel_key[MAX_K];
  __shared__ int sel_idx[MAX_K];

  const int t = threadIdx.x;
  const int hw = h * w;
  const float* H = heat + (int64_t)blockIdx.x * hw;
  uint32_t* K = keys + (int64_t)blockIdx.x * hw;

  // pass 1: NMS score keys
  for (int p = t; p < hw; p += THREADS) {
    const int i = p / w, j = p - (p / w) * w;
    const float x = thresholded(H[p], thr);
    float pooled = -INFINITY;
    for (int di = -pad; di <= pad; ++di) {
      const int ii = i + di;
      if (ii < 0 || ii >= h) continue;
      for (int dj = -pad; dj <= pad; ++dj) {
        const int jj = j + dj;
        if (jj < 0 || jj >= w) continue;
        pooled = fmaxf(pooled, thresholded(H[ii * w + jj], thr));
      }
    }
    K[p] = order_key((x == pooled && x > 0.0f) ? x : -INFINITY);
  }
  if (t == 0) {
    s_prefix = 0u;
    s_mask = 0u;
    s_rank = k;
  }
  __syncthreads();

  // pass 2: the k-th largest key, 8 bits at a time from the top
  for (int level = 0; level < 4; ++level) {
    const int shift = 24 - 8 * level;
    if (t < 256) hist[t] = 0;
    __syncthreads();
    const uint32_t prefix = s_prefix, mask = s_mask;
    for (int p = t; p < hw; p += THREADS) {
      const uint32_t key = K[p];
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    // thread t holds digit 255 - t: its inclusive scan is the count of keys >= digit
    const int cnt = t < 256 ? hist[255 - t] : 0;
    int total;
    const int ge = block_scan(cnt, warp_sums, &total);
    const int rank = s_rank;
    if (t < 256 && ge >= rank && ge - cnt < rank) {
      s_bstar = 255 - t;
      s_cgt = ge - cnt;
    }
    __syncthreads();
    if (t == 0) {
      s_rank = rank - s_cgt;
      s_prefix = prefix | ((uint32_t)s_bstar << shift);
      s_mask = mask | (255u << shift);
    }
    __syncthreads();
  }
  const uint32_t kth = s_prefix;
  const int need_eq = s_rank;   // how many keys equal to the k-th are taken

  // pass 3: compact the selected pixels, in pixel order
  int run_gt = 0, run_eq = 0;
  for (int base = 0; base < hw; base += THREADS) {
    const int p = base + t;
    const uint32_t key = p < hw ? K[p] : 0u;
    const int gt = (p < hw && key > kth) ? 1 : 0;
    const int eq = (p < hw && key == kth) ? 1 : 0;
    int total;
    const int incl = block_scan(gt | (eq << 16), warp_sums, &total);
    const int gt_incl = run_gt + (incl & 0xffff);
    const int eq_incl = run_eq + (incl >> 16);
    if (gt || (eq && eq_incl <= need_eq)) {
      const int slot = gt_incl + min(eq_incl, need_eq) - 1;
      sel_key[slot] = key;
      sel_idx[slot] = p;
    }
    run_gt += total & 0xffff;
    run_eq += total >> 16;
  }
  __syncthreads();

  // pass 4: order the k survivors (key descending, index ascending)
  if (t < k) {
    const uint32_t key = sel_key[t];
    const int idx = sel_idx[t];
    int pos = 0;
    for (int s = 0; s < k; ++s) {
      const uint32_t ks = sel_key[s];
      pos += (ks > key || (ks == key && sel_idx[s] < idx)) ? 1 : 0;
    }
    const int64_t o = (int64_t)blockIdx.x * k + pos;
    centers[2 * o] = idx / w;
    centers[2 * o + 1] = idx - (idx / w) * w;
    valid[o] = key > 0x80000000u ? 1 : 0;   // score > +0
  }
}

}  // namespace

// heat: (B, h, w) float32 contiguous; keys: (B, h, w) uint32 scratch;
// centers: (B, k, 2) int32 out; valid: (B, k) uint8 out. k <= min(1024, h * w).
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_instance_centers(const void* heat, void* keys, void* centers, void* valid,
                                      int B, int h, int w, float thr, int pad, int k,
                                      void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > MAX_K || k > h * w) return (int)cudaErrorInvalidValue;
  centers_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)heat, (uint32_t*)keys, (int*)centers, (uint8_t*)valid, h, w, thr, pad, k);
  return (int)cudaGetLastError();
}
