// instance_centers: thresholded 3x3 max-pool NMS of the centre heatmap and an exact
// top-k of the surviving peaks, one cluster of 8 blocks a frame, every frame of a
// request in one launch.
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
// A score is a positive peak value or -inf, so that order is: the peaks by value
// descending, ties by lowest index, then, when the frame has n < k peaks, the k - n
// lowest-index pixels that are not peaks, ascending.
//
// Bound on an H100: bytes. At the serve shape (5 frames of 200 x 200) the kernel must
// read 0.8 MB of heatmap and write 4.5 KB: 0.00024 ms, under the launch floor; the
// 9 compares a pixel are negligible. What costs is latency: the frame's selection is
// a chain of dependent steps.
//
// Design: a frame is spread over a cluster of NB = 8 blocks, each a strip of
// ceil(h / 8) rows. A block stages its strip with the halo rows and columns in
// shared memory (16 loads in flight a thread), computes the strip's NMS there
// (a thread a column, no division a pixel), keeps the keys in shared memory and
// compacts its peaks in pixel order (warp ballots, a scan of the warps' counts).
// The blocks' peak counts, read through distributed shared memory, give the
// frame's peak count n and each strip's place in pixel order. When n > k, the k-th
// largest peak key is found by a 4-level, 8-bit radix descent over the peaks only:
// each block histograms its peaks (one shared-memory atomic per distinct digit of
// a warp) and adds the histogram into block 0's (integer sums), and every block
// reads that sum and takes the same digit; the ties at the k-th key are taken
// lowest index first, the strips' tie counts coming from their last-level
// histograms. Each block pushes its selected peaks, as (~key, index) pairs, into
// block 0's shared memory (an atomic slot counter there); when n < k the blocks
// write the padding slots of the k - n lowest-index non-peaks straight to the
// output, from a scan of their non-peak counts. Block 0 then orders the min(n, k)
// pairs by a bitonic sort held in registers (strides under 32 by warp shuffles,
// longer ones through shared memory) and writes their slots. No global scratch,
// no zeroed buffer, no float atomics; the output does not depend on the order in
// which the blocks run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NB = 8;                    // blocks a frame: one cluster
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_K = 1024;
constexpr uint32_t NONPEAK = 0u;         // the key of a -inf score; a peak's is above 2^31
constexpr int MAX_DYNAMIC = 200 * 1024;  // bytes of a strip's keys and peak list
constexpr int STAGE_LOADS = 16;          // heatmap loads in flight a thread

__device__ __forceinline__ float thresholded(float c, float thr) { return c >= thr ? c : -1.0f; }

// Calls emit(i, rank) for every i in [0, n) with flag(i), rank the number of
// flagged items before i, and returns their count. A warp walks a contiguous
// segment twice: its count, then ranks from ballots after a scan of the warps'
// counts. Every thread of the block calls it.
template <typename Flag, typename Emit>
__device__ int ranked(int n, Flag flag, Emit emit, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = ((n + NWARPS - 1) / NWARPS + 31) & ~31;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  int count = 0;
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    count += __popc(__ballot_sync(FULL, i < hi && flag(i)));
  }
  if (lane == 0) s_warp[warp] = count;
  __syncthreads();
  int before = 0, total = 0;
  for (int v = 0; v < NWARPS; ++v) {
    const int c = s_warp[v];
    before += v < warp ? c : 0;
    total += c;
  }
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool f = i < hi && flag(i);
    const unsigned m = __ballot_sync(FULL, f);
    if (f) emit(i, before + __popc(m & ((1u << lane) - 1u)));
    before += __popc(m);
  }
  __syncthreads();
  return total;
}

// The cluster's sum of an int in every block's shared memory, and the sum over
// the blocks of lower rank; each warp reads it for itself.
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, int* local, int rank,
                                             int* total, int* before) {
  const int lane = threadIdx.x & 31;
  const int v = lane < NB ? *cluster.map_shared_rank(local, lane) : 0;
  int t = v, b = lane < rank ? v : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t += __shfl_xor_sync(FULL, t, o);
    b += __shfl_xor_sync(FULL, b, o);
  }
  *total = t;
  *before = b;
}

// Inclusive scan of x over threads 0..255 (the others' results are not used).
__device__ __forceinline__ int scan256(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31 && warp < 8) s_warp[warp] = x;
  __syncthreads();
  for (int v = 0; v < warp && v < 8; ++v) x += s_warp[v];
  __syncthreads();
  return x;
}

__global__ void __cluster_dims__(NB, 1, 1) __launch_bounds__(THREADS)
centers_cluster_kernel(const float* __restrict__ heat, int* __restrict__ centers,
                       uint8_t* __restrict__ valid, int h, int w, float thr, int pad, int k,
                       int strip_rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int frame = blockIdx.x / NB;
  const int lane = threadIdx.x & 31;
  extern __shared__ uint32_t smem[];
  __shared__ int s_hist[4][256];   // this strip's peak histogram at each radix level
  __shared__ int s_total[4][256];  // block 0: the cluster's, summed
  __shared__ unsigned long long s_sel[MAX_K];  // block 0: the selected (~key, index)
  __shared__ int s_warp[NWARPS];
  __shared__ int s_npeak, s_nsel, s_digit, s_greater;

  const int r0 = min(h, rank * strip_rows), r1 = min(h, r0 + strip_rows);
  const int npx = (r1 - r0) * w, first = r0 * w;  // the strip's pixels and its first
  uint32_t* keys = smem;                            // [strip_rows w]
  int* plist = reinterpret_cast<int*>(smem + strip_rows * w);  // the peaks, in order
  // the strip with pad halo rows and columns, thresholded, -inf outside the frame;
  // it shares plist's memory (sized for both), which is written after the NMS
  float* stage = reinterpret_cast<float*>(plist);  // [(strip_rows + 2 pad) (w + 2 pad)]
  const int nrows = r1 - r0, sw = w + 2 * pad, srows = nrows + 2 * pad;
  const float* __restrict__ H = heat + (int64_t)frame * h * w;

  // 1. stage the rows, STAGE_LOADS loads in flight a thread; then each pixel's NMS
  //    key from shared memory. Thread t takes column t % cw of rows t / cw,
  //    t / cw + rpp, ...: no division a pixel, a warp on consecutive columns
  if (nrows > 0) {
    const int cw = min(sw, THREADS), rpp = THREADS / cw;
    const int tc = threadIdx.x % cw, tr = threadIdx.x / cw;
    for (int c = tc; tr < rpp && c < sw; c += cw) {
      const int gc = c - pad;
      const bool col_in = gc >= 0 && gc < w;
      for (int R0 = tr; R0 < srows; R0 += rpp * STAGE_LOADS) {
        float v[STAGE_LOADS];
#pragma unroll
        for (int u = 0; u < STAGE_LOADS; ++u) {
          const int R = R0 + u * rpp, gr = r0 - pad + R;
          v[u] = R < srows && col_in && gr >= 0 && gr < h
                     ? thresholded(__ldg(H + gr * w + gc), thr) : -INFINITY;
        }
#pragma unroll
        for (int u = 0; u < STAGE_LOADS; ++u) {
          const int R = R0 + u * rpp;
          if (R < srows) stage[R * sw + c] = v[u];
        }
      }
    }
  }
  __syncthreads();
  {
    const int cw = min(w, THREADS), rpp = THREADS / cw;
    const int tc = threadIdx.x % cw, tr = threadIdx.x / cw;
    for (int j = tc; tr < rpp && j < w; j += cw) {
      for (int li = tr; li < nrows; li += rpp) {
        const float* win = stage + li * sw + j;   // the window's top-left
        const float x = win[pad * sw + pad];
        float pooled;
        if (pad == 1) {
          pooled = fmaxf(fmaxf(fmaxf(win[0], win[1]), fmaxf(win[2], win[sw])),
                         fmaxf(fmaxf(win[sw + 1], win[sw + 2]),
                               fmaxf(fmaxf(win[2 * sw], win[2 * sw + 1]), win[2 * sw + 2])));
        } else {
          pooled = -INFINITY;
          for (int di = 0; di <= 2 * pad; ++di)
            for (int dj = 0; dj <= 2 * pad; ++dj) pooled = fmaxf(pooled, win[di * sw + dj]);
        }
        keys[li * w + j] = (x == pooled && x > 0.0f) ? (__float_as_uint(x) | 0x80000000u)
                                                     : NONPEAK;
      }
    }
  }
  if (threadIdx.x == 0) s_nsel = 0;
  for (int i = threadIdx.x; i < 4 * 256; i += THREADS) {
    (&s_hist[0][0])[i] = 0;
    (&s_total[0][0])[i] = 0;
  }
  __syncthreads();

  // 2. the strip's peaks in pixel order; the frame's count n, the peaks before it
  const int np = ranked(npx, [&](int p) { return keys[p] != NONPEAK; },
                        [&](int p, int r) { plist[r] = p; }, s_warp);
  if (threadIdx.x == 0) s_npeak = np;
  cluster.sync();
  int n, peaks_before;
  cluster_sums(cluster, &s_npeak, rank, &n, &peaks_before);

  // 3. n > k: the k-th largest peak key, and how many of its ties lie in earlier
  //    strips; the ties are taken lowest index first
  uint32_t kth = 0u;   // n <= k: every peak is taken
  if (n > k) {
    uint32_t prefix = 0u, mask = 0u;
    int want = k;
    for (int level = 0; level < 4; ++level) {
      const int shift = 24 - 8 * level;
      int* hist = s_hist[level];
      for (int b = 0; b < np; b += THREADS) {
        const int q = b + threadIdx.x;
        const uint32_t key = q < np ? keys[plist[q]] : 0u;
        const bool m = q < np && (key & mask) == prefix;
        const uint32_t digit = (key >> shift) & 255u;
        const unsigned peers = __match_any_sync(FULL, m ? digit : 0xffffffffu);
        if (m && __ffs(peers) - 1 == lane) atomicAdd(&hist[digit], __popc(peers));
      }
      __syncthreads();
      // the cluster's histogram, summed into block 0's (integer sums: any order)
      if (threadIdx.x < 256 && hist[threadIdx.x])
        atomicAdd(cluster.map_shared_rank(&s_total[level][threadIdx.x], 0), hist[threadIdx.x]);
      cluster.sync();
      // thread t holds digit 255 - t; its inclusive scan counts the matching keys
      // whose digit is at least that
      const int cnt =
          threadIdx.x < 256 ? *cluster.map_shared_rank(&s_total[level][255 - threadIdx.x], 0) : 0;
      const int ge = scan256(cnt, s_warp);
      if (threadIdx.x < 256 && ge >= want && ge - cnt < want) {
        s_digit = 255 - threadIdx.x;
        s_greater = ge - cnt;
      }
      __syncthreads();
      prefix |= (uint32_t)s_digit << shift;
      mask |= 255u << shift;
      want -= s_greater;
    }
    kth = prefix;
    // the last level's histograms count each strip's keys equal to kth: this
    // strip takes its first want - (ties in earlier strips) of them
    int ties, ties_before;
    cluster_sums(cluster, &s_hist[3][kth & 255u], rank, &ties, &ties_before);
    const int take = want - ties_before;
    // drop the ties beyond this strip's share (an index of -1 - pixel)
    ranked(np, [&](int q) { return keys[plist[q]] == kth; },
           [&](int q, int r) { if (r >= take) plist[q] = -1 - plist[q]; }, s_warp);
  }

  // 4. the selected peaks, into block 0's list, a warp's slots at once
  unsigned long long* list = cluster.map_shared_rank(s_sel, 0);
  int* count = cluster.map_shared_rank(&s_nsel, 0);
  for (int b = 0; b < np; b += THREADS) {
    const int q = b + threadIdx.x;
    const int p = q < np ? plist[q] : -1;
    const uint32_t key = p >= 0 ? keys[p] : 0u;
    const bool sel = p >= 0 && key >= kth && key != NONPEAK;
    const unsigned m = __ballot_sync(FULL, sel);
    int slot = 0;
    if (lane == 0 && m) slot = atomicAdd(count, __popc(m));
    slot = __shfl_sync(FULL, slot, 0) + __popc(m & ((1u << lane) - 1u));
    if (sel) list[slot] = ((unsigned long long)~key << 32) | (unsigned)(first + p);
  }

  // 5. n < k: the padding slots n.. of the k - n lowest-index non-peaks
  if (n < k && first - peaks_before < k - n) {
    const int before = first - peaks_before;   // non-peaks in earlier strips
    int* c = centers + (int64_t)frame * k * 2;
    uint8_t* v = valid + (int64_t)frame * k;
    ranked(npx, [&](int p) { return keys[p] == NONPEAK; },
           [&](int p, int r) {
             const int s = n + before + r;
             if (s < k) {
               c[2 * s] = (first + p) / w;
               c[2 * s + 1] = (first + p) % w;
               v[s] = 0;
             }
           }, s_warp);
  }
  cluster.sync();   // block 0's list is whole; no block reads another's memory after this

  // 6. block 0 orders the min(n, k) peaks (key descending, index ascending): a
  //    bitonic sort of P = 2^ceil(log2 m) pairs, element e in slot e / THREADS of
  //    thread e % THREADS, only the warps that hold elements below P working;
  //    strides under 32 by warp shuffles, 32 to THREADS / 2 through shared memory,
  //    THREADS between a thread's two slots
  if (rank != 0) return;
  constexpr int SLOTS = MAX_K / THREADS;
  const int m = min(n, k);
  int P = 1;
  while (P < m) P <<= 1;
  const bool active = (threadIdx.x & ~31) < P;   // whole warps: shuffles take all lanes
  unsigned long long a[SLOTS];
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    const int e = u * THREADS + threadIdx.x;
    a[u] = e < m ? s_sel[e] : ~0ull;
  }
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= THREADS) {
        // lo = threadIdx.x; size >= 2 THREADS > lo, so ascending
        if (a[0] > a[1]) {
          const unsigned long long t = a[0];
          a[0] = a[1];
          a[1] = t;
        }
        continue;
      }
      unsigned long long b[SLOTS];
      if (stride >= 32) {
        __syncthreads();
#pragma unroll
        for (int u = 0; u < SLOTS; ++u)
          if (active && u * THREADS < P) s_sel[u * THREADS + threadIdx.x] = a[u];
        __syncthreads();
#pragma unroll
        for (int u = 0; u < SLOTS; ++u)
          if (active && u * THREADS < P) b[u] = s_sel[(u * THREADS + threadIdx.x) ^ stride];
      } else if (active) {
#pragma unroll
        for (int u = 0; u < SLOTS; ++u)
          if (u * THREADS < P) b[u] = __shfl_xor_sync(FULL, a[u], stride);
      }
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        const int e = u * THREADS + threadIdx.x;
        if (active && u * THREADS < P) {
          const bool ascending = ((e & ~stride) & size) == 0;
          const bool lower = (e & stride) == 0;
          a[u] = (lower == ascending) == (a[u] < b[u]) ? a[u] : b[u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    const int s = u * THREADS + threadIdx.x;
    if (s < m) {
      const unsigned idx = (unsigned)a[u];
      const int64_t o = (int64_t)frame * k + s;
      centers[2 * o] = (int)(idx / (unsigned)w);
      centers[2 * o + 1] = (int)(idx % (unsigned)w);
      valid[o] = 1;
    }
  }
}

// dynamic shared memory of a block: its strip's keys, and its peak list or (before
// it) the strip's rows with the halo rows and columns
long long strip_bytes(int h, int w, int pad) {
  const long long rows = (h + NB - 1) / NB;
  return 4LL * (rows * w + (rows + 2LL * pad) * (w + 2LL * pad));
}

}  // namespace

// The dynamic shared memory a block of fiery_instance_centers takes for (h, w)
// frames and a (2 pad + 1)^2 window, or 0 when that is more than it holds.
extern "C" int fiery_instance_centers_shared_bytes(int h, int w, int pad) {
  if (h < 1 || w < 1 || pad < 0) return 0;
  const long long bytes = strip_bytes(h, w, pad);
  return bytes <= MAX_DYNAMIC ? (int)bytes : 0;
}

// heat: (B, h, w) float32 contiguous; centers: (B, k, 2) int32 out; valid: (B, k)
// uint8 out, both written whole. k <= min(1024, h w); (h, w, pad) with
// fiery_instance_centers_shared_bytes(h, w, pad) > 0. Returns cudaErrorInvalidValue
// for arguments it does not take, else cudaGetLastError() after the launch.
extern "C" int fiery_instance_centers(const void* heat, void* centers, void* valid, int B,
                                      int h, int w, float thr, int pad, int k, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const int bytes = fiery_instance_centers_shared_bytes(h, w, pad);
  if (k < 1 || k > MAX_K || (long long)k > (long long)h * w || bytes == 0 ||
      (long long)B * NB > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        centers_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  centers_cluster_kernel<<<B * NB, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)heat, (int*)centers, (uint8_t*)valid, h, w, thr, pad, k,
      (h + NB - 1) / NB);
  return (int)cudaGetLastError();
}
