// group_pixels: per-pixel instance ids of decoded frames (nearest valid centre after
// the predicted offset, inside the vehicle foreground), then the consecutive relabel;
// one cluster of 16 blocks a frame, every frame of a request in one launch.
//
// Replaces: fiery_tpu/postprocess/instance.py `group_pixels` (a (K, h, w) distance
// tensor and an argmin), the foreground mask of `decode_instance_predictions` and
// `get_instance_segmentation_and_centers`, and `make_instance_seg_consecutive` (a
// (max_ids, h, w) broadcast compare).
//
// Computes, per pixel (i, j) of frame b:
//     fg = argmax_c seg[b, i, j, c] == vehicles_id (first maximum wins, a NaN is a
//     maximum as in torch.argmax); px = i + off[..., 0], py = j + off[..., 1];
//     d_k = dx * dx + dy * dy with dx = cx_k - px, dy = cy_k - py over the valid
//     centres k, each operation rounded on its own (no FMA);
//     id = 1 + first argmin_k d_k if fg and the frame has a valid centre, else 0
//     (the argmin of the plain version, where invalid centres are +inf: 0 when
//     every d_k is +inf, the first valid centre when they are NaN);
//     then mapping[id] = #{present ids <= id} - 1, id 0 always present, and
//     id = mapping[id].
//
// Bound on an H100: bytes. 5 frames of 200 x 200 pixels read 1.6 MB of offsets and
// 1.6 MB of 2-class logits and write 0.8 MB of ids (1.2 us at 3.35 TB/s). What costs
// is latency and the distances on the cluster's SMs: random weights give 100 valid
// centres a frame and half the pixels in the foreground, 10 M (pixel, centre) pairs.
//
// Design: a frame is spread over a cluster of NB = 16 blocks (a non-portable
// cluster size, 80 SMs for a request's 5 frames), block r taking rows r, r + 16,
// ... (interleaved, so that the foreground spreads evenly over the blocks; a
// pixel's row is a multiply-high, no division). Each block
//   1. lists its foreground pixels in shared memory (a warp's ballot, one shared
//      atomic a warp; the logits of 4 pixels a thread read together), id 0 for the
//      others; the frame's centres are read meanwhile;
//   2. compacts the valid centres in index order, takes their bounding box, and
//      orders them by (a, index), a the coordinate along the box's longer side,
//      the walk's axis (8 threads count the centres before each, while K <= 128);
//   3. gives each listed pixel its centre: a binary search for the first centre
//      with a >= the pixel's, then a walk each way along a, each stopped at the
//      first centre whose gap * gap + da * da exceeds the best distance so far, gap
//      being the pixel's distance to the box along the other axis. That bound is
//      below d also after rounding, and only grows along a walk, so no centre past
//      a stop can reach the best distance, and the least (distance, index) pair
//      found is the first argmin. (Random weights put the centres in a band of
//      rows along the frame's edge: a walk along the rows there would visit them
//      all.) The ids stay in shared memory (2 bytes a pixel); a warp's distinct ids
//      (`__match_any_sync`) mark a presence bitmap of K + 1 bits (one shared
//      atomicOr each);
//   4. pushes its bitmap into every block's inbox (distributed shared memory) and
//      waits at the one cluster barrier; every block then ORs the 16 bitmaps from
//      its own inbox, warp 0 takes the words' popcount prefix by shuffles, and each
//      id maps to the prefix of its word plus the popcount of its word's bits up to
//      it;
//   5. writes its relabelled ids once, a row at a time.
// A cluster arrive at the start, waited on before the first push, ensures every
// block of the cluster runs before another writes to its inbox. No block reads
// another's shared memory after the barrier, so blocks leave at once. No global
// scratch, no zeroed buffer; the output does not depend on the order of the blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NB = 16;                    // blocks a frame: one (non-portable) cluster
constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_K = 1024;               // centres a frame: at most one a thread
constexpr int MAX_WORDS = (MAX_K + 32) / 32;   // the bitmap of ids 0..K
// a block's pixels: K6's bound on its strips of ceil(h / 8) rows
// (`fiery_instance_centers_shared_bytes`: 8 bytes a pixel at least, in 200 KB), so
// every frame K6 decodes fits
constexpr int MAX_BLOCK_PIXELS = 25600;
constexpr int MAX_DYNAMIC = 4 * MAX_BLOCK_PIXELS;   // ids and foreground list, 2 B each

// The first argmin of the distances from a pixel to the n valid centres c, ordered
// by (a, index): each entry (a, b, index bits, 0), a the coordinate along the walk's
// axis and b the other; (pa, pb) the pixel's; g2 = gap * gap, the gap from pb to
// the centres' range [b_min, b_max]. Returns that index, 0 when every distance is
// +inf, or first_valid when they are NaN (argmin's rules). The distance is
// da * da + db * db, each operation rounded on its own (the sum is commutative, so
// it is the plain version's dx * dx + dy * dy to the bit).
__device__ __forceinline__ int nearest(const float4* c, int n, float pa, float pb, float g2,
                                       int first_valid) {
  if (pa != pa || pb != pb) return first_valid;
  int lo = 0, hi = n;   // the first centre with a >= pa
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid].x < pa) lo = mid + 1;
    else hi = mid;
  }
  float dmin = INFINITY;
  int kmin = MAX_K;
  // d >= g2 + da * da, rounded alike; it only grows along a walk: stop there
  auto visit = [&](int u) {
    const float4 e = c[u];
    const float da = __fsub_rn(e.x, pa);
    const float daa = __fmul_rn(da, da);
    if (__fadd_rn(g2, daa) > dmin) return false;
    const float db = __fsub_rn(e.y, pb);
    const float d = __fadd_rn(daa, __fmul_rn(db, db));
    const int k = __float_as_int(e.z);
    if (d < dmin || (d == dmin && k < kmin)) {
      dmin = d;
      kmin = k;
    }
    return true;
  };
  for (int u = lo; u < n && visit(u); ++u) {
  }
  for (int u = lo - 1; u >= 0 && visit(u); --u) {
  }
  return dmin < INFINITY ? kmin : 0;
}

// NB blocks a frame, one cluster (launched with a runtime cluster size, so that NB
// may exceed the portable 8).
__global__ void __launch_bounds__(THREADS, 1)
group_cluster_kernel(const int* __restrict__ centers, const uint8_t* __restrict__ valid,
                     const float* __restrict__ offset, const float* __restrict__ seg,
                     int* __restrict__ ids, int h, int w, int K, int C, int vehicles_id,
                     int block_rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int frame = blockIdx.x / NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  extern __shared__ __align__(16) uint16_t smem[];
  __shared__ float4 s_sorted[MAX_K];           // valid centres by (a, index)
  __shared__ float2 s_xy[MAX_K];               // valid centres (a, b) in index order
  __shared__ int s_index[MAX_K];               // and their indices
  __shared__ unsigned s_bits[MAX_WORDS];       // the ids of this block's pixels
  __shared__ unsigned s_inbox[NB][MAX_WORDS];  // every block's, pushed by it
  __shared__ unsigned s_or[MAX_WORDS], s_before[MAX_WORDS];
  __shared__ int s_warp[NWARPS];
  __shared__ int s_box[4];                     // the valid centres' row and column ranges
  __shared__ int s_nfg;

  // every block of the cluster runs before another writes to its inbox: arrive
  // now, wait before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  // this block's rows: rank, rank + NB, ...; its pixel p is row rank + NB (p / w),
  // column p % w, p / w taken as a multiply-high by ceil(2^32 / w) (exact: p w < 2^32)
  const int npx = (rank < h ? (h - 1 - rank) / NB + 1 : 0) * w;
  const unsigned w_inv = w > 1 ? 0xffffffffu / (unsigned)w + 1u : 0u;
  auto row_of = [&](int p) { return w > 1 ? (int)__umulhi((unsigned)p, w_inv) : p; };
  uint16_t* s_id = smem;                       // [block_rows w] ids before the relabel
  uint16_t* s_fg = smem + block_rows * w;      // [block_rows w] the foreground pixels
  const int64_t frame_px = (int64_t)frame * h * w;

  // the frame's centres are read first, used after step 1
  const int64_t cbase = (int64_t)frame * K;
  const bool live = (int)threadIdx.x < K && valid[cbase + threadIdx.x];
  int cx = 0, cy = 0;
  if (live) {
    cx = centers[2 * (cbase + threadIdx.x)];
    cy = centers[2 * (cbase + threadIdx.x) + 1];
  }
  if (threadIdx.x < 4) s_box[threadIdx.x] = threadIdx.x & 1 ? INT_MIN : INT_MAX;
  if (threadIdx.x < MAX_WORDS) s_bits[threadIdx.x] = threadIdx.x == 0;   // id 0 is present
  if (threadIdx.x == 0) s_nfg = 0;
  __syncthreads();

  // 1. the block's foreground pixels, listed (4 a thread at a time, their logits
  //    read together); id 0 for the others
  for (int b0 = 0; b0 < npx; b0 += 4 * THREADS) {
    bool fg[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = b0 + u * THREADS + threadIdx.x;
      fg[u] = false;
      if (p < npx) {
        const int t = row_of(p);
        const float* l = seg + (frame_px + (int64_t)(rank + NB * t) * w + (p - t * w)) * C;
        float best = l[0];
        int cls = 0;
        for (int c = 1; c < C; ++c) {
          const float x = l[c];
          if (x > best || (x != x && best == best)) {
            best = x;
            cls = c;
          }
        }
        fg[u] = cls == vehicles_id;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = b0 + u * THREADS + threadIdx.x;
      if (p < npx && !fg[u]) s_id[p] = 0;
      const unsigned f = __ballot_sync(FULL, fg[u]);
      if (f) {
        const int leader = __ffs(f) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_nfg, __popc(f));
        at = __shfl_sync(FULL, at, leader);
        if (fg[u]) s_fg[at + __popc(f & below)] = (uint16_t)p;
      }
    }
  }

  // 2. the valid centres, compacted in index order, with their bounding box; then
  //    ordered along the box's longer side (rows on a tie) by (coordinate, index)
  const unsigned m = __ballot_sync(FULL, live);
  if (m) {
    const int x0 = __reduce_min_sync(FULL, live ? cx : INT_MAX);
    const int x1 = __reduce_max_sync(FULL, live ? cx : INT_MIN);
    const int y0 = __reduce_min_sync(FULL, live ? cy : INT_MAX);
    const int y1 = __reduce_max_sync(FULL, live ? cy : INT_MIN);
    if (lane == 0) {
      atomicMin(&s_box[0], x0);
      atomicMax(&s_box[1], x1);
      atomicMin(&s_box[2], y0);
      atomicMax(&s_box[3], y1);
    }
  }
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int before = 0, nv = 0;
  for (int v = 0; v < NWARPS; ++v) {
    const int c = s_warp[v];
    before += v < warp ? c : 0;
    nv += c;
  }
  const bool by_rows = (long long)s_box[1] - s_box[0] >= (long long)s_box[3] - s_box[2];
  if (live) {
    const int slot = before + __popc(m & below);
    s_xy[slot] = by_rows ? make_float2((float)cx, (float)cy) : make_float2((float)cy, (float)cx);
    s_index[slot] = threadIdx.x;
  }
  __syncthreads();
  {
    // centre v's rank counted by `share` threads (8 while nv <= 128, one above), each
    // over every share-th centre, summed by shuffles
    const int share = nv <= THREADS / 8 ? 8 : 1;
    const int v = threadIdx.x / share, part = threadIdx.x % share;
    int r = 0;
    float2 c = make_float2(0.0f, 0.0f);
    if (v < nv) {
      c = s_xy[v];
      for (int u = part; u < nv; u += share) {
        const float a = s_xy[u].x;
        r += a < c.x || (a == c.x && u < v);
      }
    }
    for (int o = 1; o < share; o <<= 1) r += __shfl_xor_sync(FULL, r, o);
    if (v < nv && part == 0)
      s_sorted[r] = make_float4(c.x, c.y, __int_as_float(s_index[v]), 0.0f);
  }
  __syncthreads();
  // the gap's ends along the other axis (unused without a valid centre)
  const float b_min = (float)s_box[by_rows ? 2 : 0], b_max = (float)s_box[by_rows ? 3 : 1];

  // 3. each foreground pixel's nearest valid centre, or 0 without one (2 a thread at
  //    a time, their offsets read together); the block's ids marked
  const int nfg = s_nfg;
  const int first_valid = nv > 0 ? s_index[0] : 0;
  for (int b0 = 0; b0 < nfg; b0 += 2 * THREADS) {
    float pa[2], pb[2];
    int pix[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = b0 + u * THREADS + threadIdx.x;
      pix[u] = e < nfg ? s_fg[e] : 0;
      const int t = row_of(pix[u]), j = pix[u] - t * w, i = rank + NB * t;
      const int64_t o = 2 * (frame_px + (int64_t)i * w + j);
      const float px = e < nfg && nv > 0 ? __fadd_rn((float)i, offset[o]) : 0.0f;
      const float py = e < nfg && nv > 0 ? __fadd_rn((float)j, offset[o + 1]) : 0.0f;
      pa[u] = by_rows ? px : py;
      pb[u] = by_rows ? py : px;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = b0 + u * THREADS + threadIdx.x;
      int id = 0;
      if (e < nfg) {
        if (nv > 0) {
          const float gap = pb[u] < b_min ? __fsub_rn(b_min, pb[u])
                            : pb[u] > b_max ? __fsub_rn(pb[u], b_max) : 0.0f;
          id = nearest(s_sorted, nv, pa[u], pb[u], __fmul_rn(gap, gap), first_valid) + 1;
        }
        s_id[pix[u]] = (uint16_t)id;
      }
      const unsigned peers = __match_any_sync(FULL, id);
      if (id != 0 && lane == __ffs(peers) - 1) atomicOr(&s_bits[id >> 5], 1u << (id & 31));
    }
  }
  __syncthreads();

  // 4. every block's bitmap into every inbox; one cluster barrier; the ranks
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  const int words = (K + 32) / 32;
  if ((int)threadIdx.x < NB * words) {
    const int r = threadIdx.x / words, wd = threadIdx.x - r * words;
    *cluster.map_shared_rank(&s_inbox[rank][wd], r) = s_bits[wd];
  }
  cluster.sync();   // every block's bitmap is in every inbox
  if (warp == 0) {
    // lane l: words l and l + 32; their popcounts' exclusive prefix by shuffles
    unsigned o0 = 0, o1 = 0;
    for (int r = 0; r < NB; ++r) {
      if (lane < words) o0 |= s_inbox[r][lane];
      if (lane + 32 < words) o1 |= s_inbox[r][lane + 32];
    }
    const int c0 = __popc(o0), c1 = __popc(o1);
    int i0 = c0, i1 = c1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y0 = __shfl_up_sync(FULL, i0, off), y1 = __shfl_up_sync(FULL, i1, off);
      if (lane >= off) i0 += y0, i1 += y1;
    }
    const int total0 = __shfl_sync(FULL, i0, 31);
    s_or[lane] = o0;
    s_before[lane] = i0 - c0;
    if (lane + 32 < MAX_WORDS) {
      s_or[lane + 32] = o1;
      s_before[lane + 32] = total0 + i1 - c1;
    }
  }
  __syncthreads();

  // 5. the block's relabelled ids, a row at a time
  for (int p = threadIdx.x; p < npx; p += THREADS) {
    const int id = s_id[p];
    const int wd = id >> 5;
    const int t = row_of(p);
    ids[frame_px + (int64_t)(rank + NB * t) * w + (p - t * w)] =
        (int)s_before[wd] + __popc(s_or[wd] & ((2u << (id & 31)) - 1u)) - 1;
  }
}

}  // namespace

// The dynamic shared memory a block of fiery_group_pixels takes for (h, w) frames
// (the ids and foreground list of its ceil(h / NB) rows), or 0 when those rows hold
// more than MAX_BLOCK_PIXELS pixels.
extern "C" int fiery_group_pixels_shared_bytes(int h, int w) {
  if (h < 1 || w < 1) return 0;
  const long long pixels = (long long)((h + NB - 1) / NB) * w;
  return pixels <= MAX_BLOCK_PIXELS ? (int)(4 * pixels) : 0;
}

// centers: (B, K, 2) int32; valid: (B, K) uint8; offset: (B, h, w, 2) float32;
// seg: (B, h, w, C) float32 logits; ids: (B, h, w) int32 out, written whole. All
// contiguous; 1 <= K <= 1024, C >= 1, fiery_group_pixels_shared_bytes(h, w) > 0.
// Returns cudaErrorInvalidValue for arguments it does not take, else the error of
// the launch.
extern "C" int fiery_group_pixels(const void* centers, const void* valid, const void* offset,
                                  const void* seg, void* ids, int B, int h, int w, int K, int C,
                                  int vehicles_id, void* stream) {
  if (B < 0 || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const int bytes = fiery_group_pixels_shared_bytes(h, w);
  if (K < 1 || K > MAX_K || C < 1 || bytes == 0 || (long long)B * NB > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        group_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC);
    if (e == cudaSuccess && NB > 8)
      e = cudaFuncSetAttribute(group_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * NB);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, group_cluster_kernel, (const int*)centers, (const uint8_t*)valid,
      (const float*)offset, (const float*)seg, (int*)ids, h, w, K, C, vehicles_id,
      (h + NB - 1) / NB);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
