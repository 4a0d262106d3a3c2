// bev_pool: fused lift + voxel splat (depth (x) feature outer product, segment-summed
// into the BEV grid) for the Lift-Splat camera-to-BEV projection, and its backward.
//
// Replaces: fiery_tpu/ops/lift_splat.py `_sorted_splat` (forward, :104) and
// `_sorted_splat_bwd` (:123), reached through `lift_splat` (:132) and chained
// through `depth_feature_outer_product`: the XLA segment-sum over a materialised
// (P, C) lifted volume, P = N*h*w*D rows per sample, and its row gather.
//
// Forward computes, for every sample s and output cell (s, c) of the BEV grid,
//     out[s, c, :] = sum over z < Z of ( sum over rows r of voxel c*Z + z, in
//                    ascending row order, of depth[r] * feat[r / D, :] )      (f32)
// where a row r is a (pixel, depth bin) of sample s whose voxel id ids[r] is not
// the dump bin (id == num_bins). Each product is rounded once (__fmul_rn) and the
// sums run from 0 in that fixed order (__fadd_rn), which is the order of the plain
// version's index_add_ on the host: the result equals it bit for bit (Z = 1), and
// two calls give the same bits. The sum is written in the output dtype directly.
//
// Forward design: owner computes, no float atomics. One call runs four kernels on
// the current stream, after one cudaMemsetAsync of the counters, and reads nothing
// back to the host:
//   1. count: a block takes one image column of 32 image rows and stages its ids in
//      shared memory; a warp takes the 32 pixels (lane = image row) at one depth bin.
//      The rows of one column at one bin mostly fall in one voxel (the grid's cells
//      span all heights), so each run of neighbouring lanes with one key (s *
//      num_bins + voxel id) adds its length to the key's counter with one integer
//      atomic. Neighbouring voxels' counters lie an eighth of the array apart;
//   2. scan: the exclusive prefix of the counts, tile by tile (2048 keys a block);
//      the last block to finish (a ticket) scans the tile totals, so a key's offset
//      is base[key / 2048] + local[key] and no third pass is needed. It also puts
//      the cells with rows on the pool's list, those over kHeavy rows first;
//   3. fill: the same walk; each run takes consecutive slots of its bucket (lane
//      order is row order) with one atomic cursor (the counters count back down to
//      0) and writes its row indices;
//   4. pool: resident blocks take the heavy cells one a block (bitonic sort of the
//      bucket in shared memory; the products formed by every thread with 16-byte
//      accesses into shared memory; thread t adds channel t's in row order), then
//      write the zero rows of the empty cells, then take the other cells 32 / G a
//      warp: a group of G lanes a cell, its bucket ranked by the group in shared
//      memory (up to 32 rows) or by the warp (a rank sort up to 256, a stable LSD
//      radix sort of 8-bit digits beyond), its rows 8 at a time, each looked up by
//      one lane and broadcast by shuffles, their feature rows gathered (16 bytes a
//      lane) before any is summed. A bucket has no size limit: all rows of a call
//      may fall in one voxel.
// No tensor cores: the sums must run in one fixed f32 order to equal the plain
// version, and the work is a gather-bound sparse product (2 flops a row-channel).
// fiery_bev_pool_order runs stages 1-3 and writes the ordered buckets (one warp a
// key, the pool's warp sorts), for tests and measurements.
//
// Bound on an H100: bytes. At the baseline serve shapes (3 samples x 6 cameras x
// 28 x 60 pixels x 48 bins, C = 64, bf16) the inputs are ~12.6 MB and the output
// 15.4 MB, 8.3 us at 3.35 TB/s. The owner-computes pool gathers a 128-byte feature
// row for every in-grid row (~1.18 M rows, ~152 MB from L2), so the L2 gather rate,
// not DRAM, sets its floor; chip_smoke.py measures that floor with a gather probe
// (csrc/bev_pool_probes.cu), beside a probe of the atomic design it replaced.
//
// Backward (fiery_bev_pool_backward). For every frustum pixel p and bin d whose id
// is not the dump bin, with r = g[s, id[p, d] / Z]:
//     d_feat[p, c]  = sum_d depth[p, d] * r[c]
//     d_depth[p, d] = sum_c feat[p, c] * r[c]
// Each output is owned by one group of lanes, so there are no atomics and the sums
// run in a fixed order (two calls give the same bits); the gathered (P, C) gradient
// rows are never written to memory. Bound: bytes (at the training shapes, 9
// samples: depth 8.7 MB, feat 11.6 MB, ids 17.4 MB, g 46.1 MB read; d_depth and
// d_feat 20.3 MB written), but the 128-byte gradient row gathered for every
// in-grid (p, d) (~455 MB from L2) sets the floor here too.
// Design: a group of G >= 8 lanes a pixel (G = 8 for C = 64 bf16: 16-byte accesses
// of 8 channels), walking the bins 8 at a time: the next 8 bins' ids and weights
// are loaded (coalesced, then broadcast by shuffles) while the current 8 bins'
// gradient rows are in flight; d_depth's sums over channels take log2(G) shuffles
// and each 8 bins are one coalesced store; d_feat stays in the lanes' registers.
// C <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;   // keys a scan block
constexpr int kRankMax = 256;                       // rank sort in shared memory up to here
constexpr int kBins = 8;                            // bins a backward step
constexpr int kHeavy = 128;                         // over this many rows a cell is heavy
constexpr int kBlockRankMax = 2048;                 // a heavy bucket sorted by a block
constexpr int kProducts = 4096;                     // f32 products of a heavy chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n / d for 0 <= n < 2^31 by a multiply: m = ceil(2^64 / d), exact since n * (m -
// 2^64 / d) / 2^64 < 1 / d. d <= 1 returns n (d = 0 only where there is no n).
struct FastDiv {
  unsigned long long m;
  int d;
};
FastDiv make_div(long long d) {
  FastDiv f;
  f.d = (int)d;
  f.m = d <= 1 ? 0ull : ~0ull / (unsigned long long)d + 1ull;
  return f;
}
__device__ __forceinline__ int div_of(int n, FastDiv f) {
  return f.d <= 1 ? n : (int)__umul64hi((unsigned long long)n, f.m);
}

// V consecutive values of T, loaded with one access of V * sizeof(T) bytes and kept
// as raw bits until each value is read
template <int B> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned; };
template <> struct RawOf<16> { using type = uint4; };
__device__ __forceinline__ unsigned word_of(unsigned short u, int) { return u; }
__device__ __forceinline__ unsigned word_of(unsigned u, int) { return u; }
__device__ __forceinline__ unsigned word_of(uint4 u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

template <typename T, int V>
struct Chunk {
  using Raw = typename RawOf<V * sizeof(T)>::type;
  Raw u;
  __device__ __forceinline__ void load(const T* p) { u = __ldg(reinterpret_cast<const Raw*>(p)); }
  __device__ __forceinline__ void zero() { u = Raw{}; }
  // a bf16 value is the low (even i) or high half of a word; its f32 value is those
  // 16 bits over 16 zero bits
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 2) {
      const unsigned w = word_of(u, i >> 1);
      return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
    } else {
      return __uint_as_float(word_of(u, i));
    }
  }
};

__device__ __forceinline__ unsigned bf16_bits(float a) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a));
}

// word k of V values rounded to T
template <typename T, int V>
__device__ __forceinline__ unsigned word_out(const float (&x)[V], int k) {
  if constexpr (sizeof(T) == 2) {
    return 2 * k + 1 < V ? bf16_bits(x[2 * k]) | (bf16_bits(x[2 * k + 1]) << 16)
                         : bf16_bits(x[2 * k]);
  } else {
    return __float_as_uint(x[k]);
  }
}

// V values rounded to T and stored with one access
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[V]) {
  constexpr int B = V * sizeof(T);
  if constexpr (B == 2) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)word_out<T, V>(x, 0);
  } else if constexpr (B == 4) {
    *reinterpret_cast<unsigned*>(p) = word_out<T, V>(x, 0);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(word_out<T, V>(x, 0), word_out<T, V>(x, 1),
                                              word_out<T, V>(x, 2), word_out<T, V>(x, 3));
  }
}

// The rows of a call: ids (n_pix, D) int32 of images of h x w pixels, n_pix = S * P;
// a pixel's sample is p / P
struct Rows {
  const int32_t* ids;
  int n_pix;
  FastDiv per_sample;   // P
  int D;
  int num_bins;
  int h, w;
  int y_chunks;         // (h + 31) / 32
};

// The workspace, one int32 buffer (layout: fiery_bev_pool_layout)
struct Work {
  int32_t* counts;    // 8 * stride + 3: the counts of keys 0..keys (the last stays 0), at
                      // slot(key), then the scan's ticket and the numbers of heavy and
                      // light cells on the pool's list
  int32_t* local;     // keys + 1: exclusive prefix of the counts within a tile
  int32_t* base;      // tiles + 1: a tile's first offset; base[tiles] is the total
  int32_t* list;      // rows: row indices by key, in fill order
  int32_t* order;     // rows: scratch of the radix sort (and the ordered buckets of
                      // fiery_bev_pool_order)
  int32_t* cells;     // n_cells: the pool's list of cells, the heavy ones (over kHeavy
                      // rows) from the front, the others from the back
  int keys;           // S * num_bins
  int tiles;          // tiles of kScanTile over keys + 1
  int n_cells;        // S * num_bins / Z
  int Z;
  int heavy;          // rows over which a cell is heavy (Z = 1, C <= 256; else never)
  int stride;         // (keys + 8) / 8
  int ticket;         // 8 * stride
  // Neighbouring voxels take their counters an eighth of the array apart, so that the
  // atomics of neighbouring pixels do not queue on one 32-byte sector.
  __device__ __forceinline__ int* count(int key) const {
    return counts + (key & 7) * stride + (key >> 3);
  }
};

__device__ __forceinline__ int offset_of(const Work& w, int key) {
  return __ldg(w.base + key / kScanTile) + __ldg(w.local + key);
}

// Stages 1 and 3 walk a block's 32 pixels of one image column (lane = image row y:
// the rows of one column at one depth bin mostly fall in one voxel, as the grid's
// cells span all heights). The block stages the pixels' ids in shared memory,
// kTileBins bins at a time with coalesced loads; a warp then takes the bins d0 =
// warp, warp + 8, ..., kWalk of them at once: the rows p * D + d, their keys (s *
// num_bins + id, or a value no other lane holds when the row is not in the grid)
// and the runs of neighbouring lanes that share a key, each of which adds to
// (count) or takes from (fill) the key's counter with one atomic of its head lane.
// peers: the lanes of a lane's run.
constexpr int kWalk = 8;
constexpr int kTileBins = 64;
struct Walk {
  int img, y0, x, p, s;
  bool pix_ok;
  int key[kWalk];
  unsigned peers[kWalk];
  __device__ __forceinline__ Walk(const Rows& r) {
    x = blockIdx.x % r.w;
    const int rest = blockIdx.x / r.w;
    y0 = (rest % r.y_chunks) * 32;
    img = rest / r.y_chunks;
    const int y = y0 + (threadIdx.x & 31);
    p = (img * r.h + y) * r.w + x;
    pix_ok = y < r.h && p < r.n_pix;
    s = pix_ok ? div_of(p, r.per_sample) : 0;
  }
  // the block's ids of bins [b0, b0 + nb) into tile[y][d] (num_bins past the image)
  __device__ __forceinline__ void stage(const Rows& r, int (*tile)[kTileBins + 1], int b0,
                                        int nb) const {
    for (int i = threadIdx.x; i < 32 * nb; i += kThreads) {
      const int y = i / nb, d = i - y * nb;
      const int py = (img * r.h + y0 + y) * r.w + x;
      tile[y][d] = y0 + y < r.h && py < r.n_pix ? __ldg(r.ids + (long long)py * r.D + b0 + d)
                                                : r.num_bins;
    }
  }
  // staged bins d0 + kWarps * i, i < kWalk (d0 is the warp's)
  __device__ __forceinline__ void at(const Rows& r, const int (*tile)[kTileBins + 1], int d0,
                                     int nb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kWalk; ++i) {
      const int d = d0 + kWarps * i;
      const int id = d < nb ? tile[lane][d] : r.num_bins;
      // id == num_bins is the dump bin: out-of-bounds points are dropped
      key[i] = (unsigned)id < (unsigned)r.num_bins ? s * r.num_bins + id : -1 - lane;
      const int before = __shfl_up_sync(kFull, key[i], 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || before != key[i]);
      // this lane's run: from the last head at or below it to the next head
      const unsigned at_or_below = heads & (0xffffffffu >> (31 - lane));
      const int head = 31 - __clz(at_or_below);
      const unsigned above = heads & ~(0xffffffffu >> (31 - lane));
      const int end = above ? __ffs(above) - 1 : 32;
      peers[i] = (end == 32 ? 0xffffffffu : (1u << end) - 1u) & ~((1u << head) - 1u);
    }
  }
};

__global__ void __launch_bounds__(kThreads) splat_count_kernel(Rows r, Work w) {
  __shared__ int tile[32][kTileBins + 1];
  Walk walk(r);
  const int lane = threadIdx.x & 31;
  for (int b0 = 0; b0 < r.D; b0 += kTileBins) {
    const int nb = min(kTileBins, r.D - b0);
    __syncthreads();
    walk.stage(r, tile, b0, nb);
    __syncthreads();
    for (int d0 = threadIdx.x >> 5; d0 < nb; d0 += kWarps * kWalk) {
      walk.at(r, tile, d0, nb);
#pragma unroll
      for (int i = 0; i < kWalk; ++i)
        if (walk.key[i] >= 0 && lane == __ffs(walk.peers[i]) - 1)
          atomicAdd(w.count(walk.key[i]), __popc(walk.peers[i]));
    }
  }
}

// Inclusive scan of one int a thread over the block; *total gets the block's sum.
// Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int t = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += t;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = incl + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();   // warp_sums may be reused by the next call
  return out;
}

// Stage 2. Besides the offsets, it puts the tile's cells on the pool's list: with Z
// = 1 a key is a cell, and those with rows go on it, the heavy ones to the front;
// with Z > 1 every cell does.
__global__ void __launch_bounds__(kThreads) splat_scan_kernel(Work w) {
  __shared__ int warp_sums[kWarps];
  __shared__ bool last;
  __shared__ int start[2];
  const int n = w.keys + 1;
  const int first = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems], sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = first + i < n ? *w.count(first + i) : 0;
    sum += v[i];
  }
  int total;
  int excl = block_scan(sum, warp_sums, &total) - sum;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (first + i < n) w.local[first + i] = excl;
    excl += v[i];
  }
  if (threadIdx.x == 0) w.base[blockIdx.x] = total;
  // the pool's list: the block's share taken with one atomic a list
  int nh = 0, nl = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int k = first + i;
    if (k < w.keys) {
      if (w.Z > 1) nl += k % w.Z == 0;
      else if (v[i] > w.heavy) ++nh;
      else if (v[i] > 0) ++nl;
    }
  }
  int th, tl;
  int eh = block_scan(nh, warp_sums, &th) - nh;
  int el = block_scan(nl, warp_sums, &tl) - nl;
  if (threadIdx.x == 0) {
    start[0] = th ? atomicAdd(w.counts + w.ticket + 1, th) : 0;
    start[1] = tl ? atomicAdd(w.counts + w.ticket + 2, tl) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int k = first + i;
    if (k < w.keys) {
      if (w.Z > 1) {
        if (k % w.Z == 0) w.cells[w.n_cells - 1 - (start[1] + el++)] = k / w.Z;
      } else if (v[i] > w.heavy) {
        w.cells[start[0] + eh++] = k;
      } else if (v[i] > 0) {
        w.cells[w.n_cells - 1 - (start[1] + el++)] = k;
      }
    }
  }
  // the last block to finish scans the tile totals (threadFenceReduction's ticket)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(w.counts + w.ticket, 1) == w.tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int t0 = 0; t0 < w.tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int x = t < w.tiles ? __ldcg(w.base + t) : 0;
    const int incl = block_scan(x, warp_sums, &total);
    if (t < w.tiles) w.base[t] = carry + incl - x;
    carry += total;
  }
  if (threadIdx.x == 0) w.base[w.tiles] = carry;
}

__global__ void __launch_bounds__(kThreads) splat_fill_kernel(Rows r, Work w) {
  __shared__ int tile[32][kTileBins + 1];
  Walk walk(r);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int b0 = 0; b0 < r.D; b0 += kTileBins) {
    const int nb = min(kTileBins, r.D - b0);
    __syncthreads();
    walk.stage(r, tile, b0, nb);
    __syncthreads();
    for (int d0 = threadIdx.x >> 5; d0 < nb; d0 += kWarps * kWalk) {
      walk.at(r, tile, d0, nb);
      // counts[k] runs from the bucket's size down to 0: the lanes of a run take the
      // slots below its value, in lane order; all kWalk atomics in flight at once
      int top[kWalk], at[kWalk];
#pragma unroll
      for (int i = 0; i < kWalk; ++i) {
        const bool valid = walk.key[i] >= 0;
        top[i] = valid && lane == __ffs(walk.peers[i]) - 1
                     ? atomicSub(w.count(walk.key[i]), __popc(walk.peers[i])) : 0;
        at[i] = valid ? offset_of(w, walk.key[i]) : 0;
      }
#pragma unroll
      for (int i = 0; i < kWalk; ++i) {
        const unsigned peers = walk.peers[i];
        const int t = __shfl_sync(kFull, top[i], __ffs(peers) - 1);
        if (walk.key[i] >= 0)
          w.list[at[i] + t - __popc(peers) + __popc(peers & below)] =
              walk.p * r.D + b0 + d0 + kWarps * i;
      }
    }
  }
}

__device__ __forceinline__ int warp_sort32(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, j);
      const bool up = (lane & k) == 0, low = (lane & j) == 0;
      v = (low == up) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// rank sort of n (32 < n <= 32 * J) distinct values staged in s: each lane ranks
// its J values against all n
template <int J>
__device__ __forceinline__ void rank_sort(const int* s, int n, int lane, int* dst) {
  int e[J], rank[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    e[j] = i < n ? s[i] : INT32_MAX;
    rank[j] = 0;
  }
  for (int t = 0; t < n; ++t) {
    const int x = s[t];
#pragma unroll
    for (int j = 0; j < J; ++j) rank[j] += x < e[j];
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < n) dst[rank[j]] = e[j];
}

// Stable LSD radix sort of src[0, n) by (value - lo), 8 bits a pass, ping-ponging
// with dst; the result ends in dst. hist: 256 ints of the warp's shared memory.
// src and dst are written and read again by this warp: plain (coherent) accesses.
__device__ void radix_sort(int* src, int* dst, int n, int lo, int span, int* hist,
                           int lane) {
  int passes = 1;
  while (passes < 4 && (span >> (8 * passes)) != 0) ++passes;
  const unsigned lt = (1u << lane) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int i = lane; i < n; i += 32) atomicAdd(hist + (((src[i] - lo) >> shift) & 255), 1);
    __syncwarp();
    int h[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[i] = hist[lane * 8 + i];
      sum += h[i];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    int excl = incl - sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hist[lane * 8 + i] = excl;
      excl += h[i];
    }
    __syncwarp();
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < n;
      const int v = valid ? src[i] : 0;
      const int dig = valid ? ((v - lo) >> shift) & 255 : 256 + lane;
      const unsigned peers = __match_any_sync(kFull, dig);
      const int at = valid ? hist[dig] : 0;
      __syncwarp();
      if (valid) {
        dst[at + __popc(peers & lt)] = v;
        if (lane == 31 - __clz(peers)) hist[dig] = at + __popc(peers);
      }
      __syncwarp();
    }
    int* t = src;
    src = dst;
    dst = t;
  }
  // the sorted values are in src now; they must end in the caller's dst
  if (passes & 1) return;
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
  __syncwarp();
}


// list[0, n) (32 < n <= kRankMax) staged in stage and rank-sorted into dst. Kept out
// of line: the common buckets (n <= 32) should not pay its registers.
__device__ __noinline__ void sort_medium(const int* list, int n, int* stage, int lane,
                                         int* dst) {
  for (int i = lane; i < n; i += 32) stage[i] = list[i];
  __syncwarp();
  if (n <= 64) rank_sort<2>(stage, n, lane, dst);
  else if (n <= 128) rank_sort<4>(stage, n, lane, dst);
  else rank_sort<8>(stage, n, lane, dst);
  __syncwarp();
}

// list[0, n) (n > kRankMax) radix-sorted into order[0, n), list used as scratch
__device__ __noinline__ void sort_large(int* list, int* order, int n, int* hist, int lane) {
  int vmin = INT32_MAX, vmax = 0;
  for (int i = lane; i < n; i += 32) {
    const int v = list[i];
    vmin = min(vmin, v);
    vmax = max(vmax, v);
  }
  vmin = __reduce_min_sync(kFull, vmin);
  vmax = __reduce_max_sync(kFull, vmax);
  radix_sort(list, order, n, vmin, vmax - vmin, hist, lane);
  __syncwarp();
}

// The order kernel (fiery_bev_pool_order, for tests): one warp a key writes its
// bucket to order[] in the order the pool sums it, with the pool's sorts.
__global__ void __launch_bounds__(kThreads) splat_order_kernel(Work w) {
  __shared__ int stage[kWarps][kRankMax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key = blockIdx.x * kWarps + warp;
  if (key >= w.keys) return;
  const int lo = offset_of(w, key);
  const int n = offset_of(w, key + 1) - lo;
  if (n == 0) return;
  if (n <= 32) {
    const int v = warp_sort32(lane < n ? w.list[lo + lane] : INT32_MAX, lane);
    if (lane < n) w.order[lo + lane] = v;
  } else if (n <= kRankMax) {
    sort_medium(w.list + lo, n, stage[warp], lane, w.order + lo);
  } else {
    sort_large(w.list + lo, w.order + lo, n, stage[warp], lane);
  }
}

// The zero row of an empty cell, written by a warp
__device__ __forceinline__ void zero_row(char* row, int bytes, int lane) {
  if (bytes % 16 == 0 && ((uintptr_t)row & 15) == 0) {
    for (int b = 16 * lane; b < bytes; b += 512)
      *reinterpret_cast<uint4*>(row + b) = make_uint4(0u, 0u, 0u, 0u);
  } else if (bytes % 4 == 0) {
    for (int b = 4 * lane; b < bytes; b += 128) *reinterpret_cast<unsigned*>(row + b) = 0u;
  } else {
    for (int b = 2 * lane; b < bytes; b += 64) *reinterpret_cast<unsigned short*>(row + b) = 0;
  }
}

constexpr int kRows = 8;   // rows of a cell in flight

// A heavy cell by the whole block (Z = 1, so the cell is key `cell`; C <= 256): its
// bucket sorted in shared memory by a bitonic network of every thread (radix-sorted
// by warp 0 beyond kBlockRankMax rows), then its rows in chunks of kProducts / C:
// every thread forms some of a chunk's products (f32, __fmul_rn; V channels of a row
// with one access) in shared memory, and thread t < C adds channel t's in row order.
// Out of line, so that the light cells' loop keeps its registers. sorted:
// kBlockRankMax ints; prods: kProducts floats.
template <typename T, int V>
__device__ __noinline__ void heavy_cell(const T* __restrict__ depth, const T* __restrict__ feat,
                                        const Work& w, T* __restrict__ out, int cell,
                                        FastDiv per_pixel, int C, FastDiv by_cv, int* sorted,
                                        float* prods) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = offset_of(w, cell), n = offset_of(w, cell + 1) - lo;
  const int* order;
  if (n <= kBlockRankMax) {
    int span = 1;
    while (span < n) span <<= 1;
    for (int i = threadIdx.x; i < span; i += kThreads)
      sorted[i] = i < n ? w.list[lo + i] : INT32_MAX;
    __syncthreads();
    for (int k = 2; k <= span; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < span; i += kThreads) {
          const int o = i ^ j;
          if (o > i) {
            const int a = sorted[i], b = sorted[o];
            if ((a > b) == ((i & k) == 0)) {
              sorted[i] = b;
              sorted[o] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    order = sorted;
  } else {
    if (warp == 0) sort_large(w.list + lo, w.order + lo, n, sorted, lane);
    order = w.order + lo;
  }
  __syncthreads();
  const int rows = kProducts / C, per_row = C / V;
  constexpr int kPer = kProducts / V / kThreads;   // accesses a thread makes a chunk
  float acc = 0.0f;                                // channel threadIdx.x (C <= 256)
  for (int j0 = 0; j0 < n; j0 += rows) {
    const int m = min(rows, n - j0);
    float wt[kPer];
    Chunk<T, V> f[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int slot = threadIdx.x + kThreads * q;
      const int r = div_of(slot, by_cv), cv = slot - r * per_row;
      if (r < m) {
        const int row = order[j0 + r];
        wt[q] = to_float(__ldg(depth + row));
        f[q].load(feat + (long long)div_of(row, per_pixel) * C + cv * V);
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int slot = threadIdx.x + kThreads * q;
      if (slot < m * per_row) {
#pragma unroll
        for (int i = 0; i < V; ++i) prods[slot * V + i] = __fmul_rn(wt[q], f[q].at(i));
      }
    }
    __syncthreads();
    if (threadIdx.x < C) {
      for (int r = 0; r < m; ++r) acc = __fadd_rn(acc, prods[r * C + threadIdx.x]);
    }
    __syncthreads();
  }
  if (threadIdx.x < C) out[(long long)cell * C + threadIdx.x] = from_float<T>(acc);
}

// Stage 4. Resident blocks first take the heavy cells, a block a cell (heavy_cell),
// then write the zero rows of the empty cells (Z = 1; a warp 32 cells a step), then
// walk the other cells CPW = 32 / G at a time a warp. For each z the warp puts the
// CPW buckets in ascending row order (the shuffle network into shared memory up to
// 32 rows, else into the order buffer); then a group of G lanes sums each cell, lane
// l holding channels (k * G + l) * V + [0, V), k < K: kRows rows at a time, their
// depth weights and feature rows gathered before any is summed, the next rows'
// indices fetched meanwhile.
template <typename T, int V, int K, int G>
__global__ void __launch_bounds__(kThreads, 3)
    splat_pool_kernel(const T* __restrict__ depth, const T* __restrict__ feat, Work w,
                      T* __restrict__ out, int cells_per_sample, int num_bins, int Z,
                      FastDiv per_pixel, int C, FastDiv by_cv) {
  constexpr int CPW = 32 / G;
  __shared__ int stage[kWarps][kRankMax];
  __shared__ int small[kWarps][CPW][2][33];   // a group's rows, staged and ranked (padded)
  __shared__ float prods[kProducts];
  static_assert(kWarps * kRankMax >= kBlockRankMax, "heavy_cell sorts in stage");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  const int heavy = w.counts[w.ticket + 1];
  const int light = w.counts[w.ticket + 2];
  for (int t = blockIdx.x; t < heavy; t += gridDim.x)
    heavy_cell<T, V>(depth, feat, w, out, w.cells[t], per_pixel, C, by_cv, &stage[0][0], prods);
  if (Z == 1) {
    const int row_bytes = C * (int)sizeof(T);
    for (int c0 = gwarp * 32; c0 < w.n_cells; c0 += nwarps * 32) {
      const int c = c0 + lane;
      unsigned none =
          __ballot_sync(kFull, c < w.n_cells && offset_of(w, c) == offset_of(w, c + 1));
      while (none) {
        const int i = __ffs(none) - 1;
        none &= none - 1;
        zero_row((char*)out + (long long)(c0 + i) * row_bytes, row_bytes, lane);
      }
    }
  }
  for (int t0 = gwarp * CPW; t0 < light; t0 += nwarps * CPW) {
    const int t = t0 + grp;
    const bool live = t < light;
    const int cell = live ? w.cells[w.n_cells - 1 - t] : 0;
    const int s = cell / cells_per_sample;
    const int key0 = s * num_bins + (cell - s * cells_per_sample) * Z;
    // rows wider than G * K * V channels (G = 32) take several passes
    for (int c0 = 0; c0 < C; c0 += G * K * V) {
    float total[K][V];
    for (int z = 0; z < Z; ++z) {
      const int lo = live ? offset_of(w, key0 + z) : 0;
      const int n = live ? offset_of(w, key0 + z + 1) - lo : 0;
      // a bucket of up to 32 rows is ranked by its own group in shared memory: each
      // lane ranks its rows against all n; the larger ones are sorted by the warp
      const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << (grp * G);
      const int* mine = small[warp][grp][1];
      if (n <= 32) {
        int* in = small[warp][grp][0];
        for (int j = gl; j < n; j += G) in[j] = w.list[lo + j];
        __syncwarp(gmask);
        for (int j = gl; j < n; j += G) {
          const int e = in[j];
          int rank = 0;
          for (int k = 0; k < n; ++k) rank += in[k] < e;
          small[warp][grp][1][rank] = e;
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int ni = __shfl_sync(kFull, n, i * G), loi = __shfl_sync(kFull, lo, i * G);
        if (ni > 32) {
          if (ni <= kRankMax) sort_medium(w.list + loi, ni, stage[warp], lane, w.order + loi);
          else sort_large(w.list + loi, w.order + loi, ni, stage[warp], lane);
          if (grp == i) mine = w.order + lo;
        }
      }
      __syncwarp();
      float acc[K][V];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
      // a batch's rows are looked up by the group's lanes, row e by lane e % G (its
      // index, weight and pixel), then broadcast by shuffles
      constexpr int RPL = (kRows + G - 1) / G;   // rows a lane looks up
      int next[RPL];
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int e = gl + G * q;
        next[q] = e < kRows && e < n ? mine[e] : 0;
      }
      for (int j0 = 0; j0 < n; j0 += kRows) {
        float my_w[RPL];
        int my_pix[RPL];
#pragma unroll
        for (int q = 0; q < RPL; ++q) {
          const int e = gl + G * q, row = next[q];
          next[q] = e < kRows && j0 + kRows + e < n ? mine[j0 + kRows + e] : 0;
          const bool valid = e < kRows && j0 + e < n;
          my_w[q] = valid ? to_float(__ldg(depth + row)) : 0.0f;
          my_pix[q] = div_of(row, per_pixel);
        }
        float wt[kRows];
        Chunk<T, V> f[kRows][K];
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          const bool valid = j0 + e < n;
          wt[e] = __shfl_sync(gmask, my_w[e / G], e % G, G);
          const T* fr = feat + (long long)__shfl_sync(gmask, my_pix[e / G], e % G, G) * C;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int c = c0 + (k * G + gl) * V;
            if (valid && c < C) f[e][k].load(fr + c);
            else f[e][k].zero();
          }
        }
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          if (j0 + e < n) {
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int i = 0; i < V; ++i)
                acc[k][i] = __fadd_rn(acc[k][i], __fmul_rn(wt[e], f[e][k].at(i)));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) total[k][i] = z ? __fadd_rn(total[k][i], acc[k][i]) : acc[k][i];
      __syncwarp();   // small[] and stage[] are reused by the next z or cells
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = c0 + (k * G + gl) * V;
        if (c < C) store_vec<T, V>(out + (long long)cell * C + c, total[k]);
      }
    }
    }
  }
}

// Backward: a group of G (>= 8) lanes a pixel, 8 bins a step; lane l of the group
// holds channels (k * G + l) * V + [0, V) for k < K. Products are fused into the sums
// (one rounding each); the order of the sums is fixed.
template <typename T, int V, int K, int G>
__global__ void __launch_bounds__(kThreads)
    splat_backward_kernel(const T* __restrict__ depth, const T* __restrict__ feat,
                          const int32_t* __restrict__ ids, const T* __restrict__ g,
                          T* __restrict__ d_depth, T* __restrict__ d_feat, int n_pix,
                          FastDiv pix_per_sample, int D, int C, int num_bins, FastDiv Z) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int p = t / G;
  if (p >= n_pix) return;   // the whole group leaves together
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const unsigned mask = G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int s = div_of(p, pix_per_sample);
  const T* gs = g + (long long)s * (num_bins / Z.d) * C;
  const long long prow = (long long)p * D;
  float f[K][V], acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * G + gl) * V;
    Chunk<T, V> x;
    if (c < C) x.load(feat + (long long)p * C + c);
    else x.zero();
#pragma unroll
    for (int i = 0; i < V; ++i) {
      f[k][i] = x.at(i);
      acc[k][i] = 0.0f;
    }
  }
  // lane l < 8 of the group holds bin d0 + l's id and weight; the next step's are
  // loaded while this step's gradient rows are in flight
  int next_id = gl < kBins && gl < D ? __ldg(ids + prow + gl) : num_bins;
  float next_w = gl < kBins && gl < D ? to_float(__ldg(depth + prow + gl)) : 0.0f;
  for (int d0 = 0; d0 < D; d0 += kBins) {
    const int my_id = next_id;
    const float my_w = next_w;
    Chunk<T, V> r[kBins][K];
    bool valid[kBins];
#pragma unroll
    for (int e = 0; e < kBins; ++e) {
      const int id = __shfl_sync(mask, my_id, e, G);
      valid[e] = d0 + e < D && (unsigned)id < (unsigned)num_bins;
      const T* row = gs + (valid[e] ? div_of(id, Z) : 0) * C;   // < 2^31 (host check)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (k * G + gl) * V;
        if (valid[e] && c < C) r[e][k].load(row + c);
        else r[e][k].zero();
      }
    }
    const int d1 = d0 + kBins + gl;
    next_id = gl < kBins && d1 < D ? __ldg(ids + prow + d1) : num_bins;
    next_w = gl < kBins && d1 < D ? to_float(__ldg(depth + prow + d1)) : 0.0f;
    float mine = 0.0f;   // lane e < 8 ends with bin d0 + e's d_depth
#pragma unroll
    for (int e = 0; e < kBins; ++e) {
      const float wt = __shfl_sync(mask, my_w, e, G);
      float dd = 0.0f;
      if (valid[e]) {
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float rv = r[e][k].at(i);
            dd = __fmaf_rn(f[k][i], rv, dd);
            acc[k][i] = __fmaf_rn(wt, rv, acc[k][i]);
          }
      }
#pragma unroll
      for (int off = G >> 1; off > 0; off >>= 1) dd += __shfl_xor_sync(mask, dd, off, G);
      if (gl == e) mine = dd;
    }
    if (gl < kBins && d0 + gl < D) d_depth[prow + d0 + gl] = from_float<T>(mine);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * G + gl) * V;
    if (c < C) store_vec<T, V>(d_feat + (long long)p * C + c, acc[k]);
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

long long tiles_of(long long keys) { return (keys + 1 + kScanTile - 1) / kScanTile; }

Work work_of(void* ws, long long keys, long long rows, int z_bins, int C) {
  int32_t* p = (int32_t*)ws;
  Work w;
  w.heavy = z_bins == 1 && C <= 256 ? kHeavy : INT32_MAX;
  w.keys = (int)keys;
  w.tiles = (int)tiles_of(keys);
  w.n_cells = (int)(keys / z_bins);
  w.Z = z_bins;
  w.stride = (int)((keys + 8) / 8);
  w.ticket = 8 * w.stride;
  w.counts = p;
  w.local = w.counts + w.ticket + 3;
  w.base = w.local + keys + 1;
  w.list = w.base + w.tiles + 1;
  w.order = w.list + rows;
  w.cells = w.order + rows;
  return w;
}

// Blocks of kernel that the card holds at once
template <typename F>
int resident_blocks(F kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int V, int K, int G>
int launch_pool(const void* depth, const void* feat, const Work& w, void* out, int num_bins,
                int z_bins, int D, int C, cudaStream_t st) {
  static const int resident = resident_blocks(splat_pool_kernel<T, V, K, G>);
  const int per_block = kWarps * (32 / G);   // cells a block takes at a time
  const int blocks = (w.n_cells + per_block - 1) / per_block;
  splat_pool_kernel<T, V, K, G><<<blocks < resident ? blocks : resident, kThreads, 0, st>>>(
      (const T*)depth, (const T*)feat, w, (T*)out, num_bins / z_bins, num_bins, z_bins,
      make_div(D), C, make_div(C / V));
  return (int)cudaGetLastError();
}

// 16-byte accesses where the rows and pointers allow them, else one value; G lanes
// a cell (4 to 32), K accesses a lane
template <typename T>
int dispatch_pool(const void* depth, const void* feat, const Work& w, void* out,
                  int num_bins, int z_bins, int D, int C, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = C % VW == 0 && aligned(feat, 16) && aligned(out, 16);
  const int lanes = vec ? C / VW : C;
  const int K = lanes > 32 ? 2 : 1;
  int G = 4;
  while (G < 32 && G * K < lanes) G <<= 1;
#define FIERY_POOL(VV, KK, GG) \
  return launch_pool<T, VV, KK, GG>(depth, feat, w, out, num_bins, z_bins, D, C, st)
#define FIERY_POOL_G(VV)               \
  if (K == 2) FIERY_POOL(VV, 2, 32);   \
  if (G == 4) FIERY_POOL(VV, 1, 4);    \
  if (G == 8) FIERY_POOL(VV, 1, 8);    \
  if (G == 16) FIERY_POOL(VV, 1, 16);  \
  FIERY_POOL(VV, 1, 32)
  if (vec) {
    FIERY_POOL_G(VW);
  }
  FIERY_POOL_G(1);
#undef FIERY_POOL_G
#undef FIERY_POOL
}

template <typename T, int V, int K, int G>
int launch_backward(const void* depth, const void* feat, const void* ids, const void* g,
                    void* d_depth, void* d_feat, long long n_pix, long long pix_per_sample,
                    int D, int C, int num_bins, int z_bins, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n_pix * G + kThreads - 1) / kThreads);
  splat_backward_kernel<T, V, K, G><<<blocks, kThreads, 0, st>>>(
      (const T*)depth, (const T*)feat, (const int32_t*)ids, (const T*)g, (T*)d_depth,
      (T*)d_feat, (int)n_pix, make_div(pix_per_sample), D, C, num_bins, make_div(z_bins));
  return (int)cudaGetLastError();
}

// 16-byte accesses where the rows and pointers allow them, else one value; G lanes a
// pixel (8 to 32), K accesses a lane
template <typename T>
int dispatch_backward(const void* depth, const void* feat, const void* ids, const void* g,
                      void* d_depth, void* d_feat, long long n_pix, long long pix_per_sample,
                      int D, int C, int num_bins, int z_bins, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = C % VW == 0 && aligned(feat, 16) && aligned(g, 16) && aligned(d_feat, 16);
  const int lanes = vec ? C / VW : C;
  int K = 1;
  while (lanes > 32 * K) K <<= 1;
  int G = 8;
  while (G < 32 && G * K < lanes) G <<= 1;
#define FIERY_BWD(VV, KK, GG)                                                             \
  return launch_backward<T, VV, KK, GG>(depth, feat, ids, g, d_depth, d_feat, n_pix,      \
                                        pix_per_sample, D, C, num_bins, z_bins, st)
  if (K == 1) {
    if (vec) {
      if (G == 8) FIERY_BWD(VW, 1, 8);
      if (G == 16) FIERY_BWD(VW, 1, 16);
      FIERY_BWD(VW, 1, 32);
    }
    if (G == 8) FIERY_BWD(1, 1, 8);
    if (G == 16) FIERY_BWD(1, 1, 16);
    FIERY_BWD(1, 1, 32);
  }
  if (vec && K == 2) FIERY_BWD(VW, 2, 32);
  if (!vec && K == 2) FIERY_BWD(1, 2, 32);
  if (!vec && K == 4) FIERY_BWD(1, 4, 32);
  if (!vec && K == 8) FIERY_BWD(1, 8, 32);
#undef FIERY_BWD
  return (int)cudaErrorInvalidValue;   // more than 256 channels
}

}  // namespace

// The int32 workspace of a call with S samples of pix_per_sample pixels, D bins and
// num_bins voxels in cells of z_bins: starts of its six parts (counts, local, base,
// list, order, cells) and the total, in ints, into out[0..6]. Returns 0, or
// cudaErrorInvalidValue when a count would not fit in int32.
extern "C" int fiery_bev_pool_layout(long long S, long long pix_per_sample, int D,
                                     int num_bins, int z_bins, long long* out) {
  const long long keys = S * num_bins, rows = S * pix_per_sample * D;
  if (keys + 4 >= (1ll << 31) || rows >= (1ll << 31) || z_bins < 1 || num_bins % z_bins)
    return (int)cudaErrorInvalidValue;
  const long long tiles = tiles_of(keys);
  out[0] = 0;
  out[1] = 8 * ((keys + 8) / 8) + 3;
  out[2] = out[1] + keys + 1;
  out[3] = out[2] + tiles + 1;
  out[4] = out[3] + rows;
  out[5] = out[4] + rows;
  out[6] = out[5] + keys / z_bins;
  return 0;
}

namespace {

// Stages 1-3 (count, scan, fill) and the memset of the counters
int bucket_rows(const void* ids, const Work& w, long long S, long long pix_per_sample, int D,
                int num_bins, int h, int wd, cudaStream_t st) {
  int rc = (int)cudaMemsetAsync(w.counts, 0, (w.ticket + 3ll) * sizeof(int32_t), st);
  if (rc) return rc;
  const long long n_pix = S * pix_per_sample;
  if (h < 1 || wd < 1 || pix_per_sample % ((long long)h * wd)) return (int)cudaErrorInvalidValue;
  const int y_chunks = (h + 31) / 32;
  Rows r{(const int32_t*)ids, (int)n_pix, make_div(pix_per_sample), D, num_bins, h, wd, y_chunks};
  // a block per image column and 32 image rows
  const unsigned pix_blocks = (unsigned)(n_pix / ((long long)h * wd) * y_chunks * wd);
  if (n_pix && D) splat_count_kernel<<<pix_blocks, kThreads, 0, st>>>(r, w);
  if ((rc = (int)cudaGetLastError())) return rc;
  splat_scan_kernel<<<w.tiles, kThreads, 0, st>>>(w);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (n_pix && D) splat_fill_kernel<<<pix_blocks, kThreads, 0, st>>>(r, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Stages 1-3 and the order kernel on ids (S, pix_per_sample, D) int32 in [0,
// num_bins], pix_per_sample a whole number of h x wd images: afterwards the valid
// rows of key k (= s * num_bins + id) are, in ascending order, order[offset(k) ..
// offset(k + 1)), offset(k) = base[k / 2048] + local[k] (parts of the workspace ws,
// fiery_bev_pool_layout). Four kernels and one
// cudaMemsetAsync on the stream; returns the first CUDA error.
extern "C" int fiery_bev_pool_order(const void* ids, void* ws, long long S,
                                    long long pix_per_sample, int h, int wd, int D,
                                    int num_bins, void* stream) {
  long long layout[7];
  int rc = fiery_bev_pool_layout(S, pix_per_sample, D, num_bins, 1, layout);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const Work w = work_of(ws, S * num_bins, S * pix_per_sample * D, 1, 0);
  if ((rc = bucket_rows(ids, w, S, pix_per_sample, D, num_bins, h, wd, st))) return rc;
  if (w.keys) splat_order_kernel<<<(w.keys + kWarps - 1) / kWarps, kThreads, 0, st>>>(w);
  return (int)cudaGetLastError();
}

// depth, feat: (S, pix_per_sample, D) / (S, pix_per_sample, C) contiguous, float32 or
// bfloat16, pix_per_sample a whole number of h x wd images (N cameras); ids: (S,
// pix_per_sample, D) int32 in [0, num_bins]; out: (S, num_bins / z_bins, C) of
// depth's dtype, every value written; ws: the int32 workspace of
// fiery_bev_pool_layout. Four kernels and one cudaMemsetAsync on the stream;
// returns the first CUDA error.
extern "C" int fiery_bev_pool(const void* depth, const void* feat, const void* ids,
                              void* out, void* ws, long long S, long long pix_per_sample,
                              int h, int wd, int D, int C, int num_bins, int z_bins,
                              int is_bf16, void* stream) {
  long long layout[7];
  int rc = fiery_bev_pool_layout(S, pix_per_sample, D, num_bins, z_bins, layout);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const Work w = work_of(ws, S * num_bins, S * pix_per_sample * D, z_bins, C);
  if ((rc = bucket_rows(ids, w, S, pix_per_sample, D, num_bins, h, wd, st))) return rc;
  if (w.n_cells == 0 || C == 0) return 0;
  if (is_bf16)
    return dispatch_pool<__nv_bfloat16>(depth, feat, w, out, num_bins, z_bins, D, C, st);
  return dispatch_pool<float>(depth, feat, w, out, num_bins, z_bins, D, C, st);
}

// depth, feat, ids as for fiery_bev_pool (n_pix = S * pix_per_sample pixels); g: (S,
// num_bins / z_bins, C) contiguous, the dtype of depth; d_depth, d_feat: shaped and
// typed as depth and feat (every value is written). C <= 256. One launch; returns
// cudaGetLastError().
extern "C" int fiery_bev_pool_backward(const void* depth, const void* feat, const void* ids,
                                       const void* g, void* d_depth, void* d_feat,
                                       long long n_pix, long long pix_per_sample, int D,
                                       int C, int num_bins, int z_bins, int is_bf16,
                                       void* stream) {
  if (C > 256 || n_pix * D >= (1ll << 31) || n_pix * 32 >= (1ll << 31) ||
      (long long)num_bins * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_backward<__nv_bfloat16>(depth, feat, ids, g, d_depth, d_feat, n_pix,
                                            pix_per_sample, D, C, num_bins, z_bins, st);
  return dispatch_backward<float>(depth, feat, ids, g, d_depth, d_feat, n_pix, pix_per_sample,
                                  D, C, num_bins, z_bins, st);
}
