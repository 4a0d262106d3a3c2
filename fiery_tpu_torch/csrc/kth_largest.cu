// kth_largest: the exact k-th largest value of each row of a float32 matrix, by radix
// select on the values' bits.
//
// Replaces: fiery_tpu/training/losses.py `_kth_largest` (8 levels of 4-bit dense
// histograms over order-preserving uint32 keys), which feeds `_top_k_mean`, the
// top-k hardest-pixel mean of the segmentation loss (SEMANTIC_SEG.USE_TOP_K).
//
// Computes, for each row r of x (rows, n): out[r] = the k-th largest x[r, :], ties
// counted with multiplicity. Floats map to uint32 keys whose unsigned order is the
// float order (non-negative: set the sign bit; negative: flip every bit), so -0.0
// ranks below +0.0 as in `_kth_largest`; four passes each fix 8 more bits of the
// k-th key: a 256-bin histogram of the keys that share the bits fixed so far, then
// the bin in which the remaining rank falls. out[r] is the float of the k-th key.
//
// Bound on an H100: bytes. At the training shape (15 rows of 40,000 f32, k =
// 10,000) the input is 2.4 MB and the output 60 bytes: 0.72 us at 3.35 TB/s; the
// ~6 integer operations per element and pass are ~14 M operations.
//
// Design. The first design ran one block a row, re-read the row from L2 in each pass
// and added every key to one shared 256-bin histogram, so that the keys of one bin
// (a loss spans a few binades; ignored pixels are all 0.0) serialised on one address.
// Here a row is split over a cluster of C = 4 blocks of 1024 threads (8 for rows of
// more than 65,536), each of which owns a contiguous chunk of the row. On the H100
// one block a row, or two, took longer: a 40,000-key row on one SM waits on that
// SM's shared-memory atomics.
//   1. A thread reads its chunk's elements once from HBM (coalesced) and keeps 16
//      keys in registers; a chunk of more than 16,384 keys reads the rest again from
//      global memory in each pass.
//   2. Each pass counts the keys that share the prefix by digit, into 16 copies of
//      the block's histogram (lane l adds to copy l % 16); a thread adds each run of
//      equal digits in its keys with one atomic, so that the adds to a hot bin (ties;
//      the first pass over a few binades) stay few. Each thread then sums four
//      copies of a bin and zeroes them, and a quarter-warp's shuffles give the bin's
//      count, which it stores into every block's inbox (distributed shared memory).
//   3. One cluster barrier; warp 0 of every block sums the C histograms in its inbox
//      and finds the bin in which the rank falls (the same in every block: integer
//      counts), and a block barrier hands it to the other warps. A cluster barrier
//      costs many times a block barrier (`fiery_kth_largest_barrier_chain` times the
//      chain alone), so a call takes one a pass and no other: the first push waits on
//      an arrival made at the start, and no block writes to another after the last
//      pass's barrier.
//   4. When the bin holds a single key, that key is the k-th: the block that holds it
//      writes it, and every block stops there (a continuous loss row ends after two
//      or three passes).
// Shared memory is static (32 KB at C = 8), so no launch sets an attribute or
// allocates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 16;   // keys a thread holds in registers
constexpr int kBins = 256;       // 8-bit digits
constexpr int kCopies = 16;      // copies of the histogram: lane l adds to copy l % 16
constexpr int kPasses = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) == 0 ? (bits | 0x80000000u) : ~bits;
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key >> 31) == 1 ? (key ^ 0x80000000u) : ~key);
}

// Counts a thread's keys that share the prefix by digit: each run of equal digits in
// the thread's keys is added to its copy of the histogram with one atomic.
struct RunCounter {
  unsigned* hist;
  unsigned high, prefix;
  int shift, copy;
  unsigned bin = 0, run = 0;
  __device__ __forceinline__ void add(unsigned key) {
    if ((key & high) != prefix) return;
    const unsigned b = (key >> shift) & 0xFFu;
    if (b != bin && run) {
      atomicAdd(&hist[bin * kCopies + copy], run);
      run = 0;
    }
    bin = b;
    ++run;
  }
  __device__ __forceinline__ void flush() {
    if (run) atomicAdd(&hist[bin * kCopies + copy], run);
  }
};

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads, 1)
kth_largest_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n,
                   unsigned k, int64_t chunk) {
  __shared__ alignas(16) unsigned hist[kBins * kCopies];
  // every block's histogram of a pass, pushed by it; by pass parity, because a block
  // writes a pass's only after the barrier that ends every reader's use of the pass
  // before last
  __shared__ alignas(16) unsigned inbox[2][C][kBins];
  __shared__ unsigned s_prefix, s_rank;
  __shared__ bool s_alone;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank_c = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = x + (int64_t)(blockIdx.x / C) * n;
  float* result = out + blockIdx.x / C;
  const int64_t begin = rank_c * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const int64_t rest = begin + (int64_t)kPerThread * kThreads;   // read again each pass

  unsigned key[kPerThread];
  int valid = 0;   // keys 0 .. valid - 1 are this thread's
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int64_t e = begin + threadIdx.x + (int64_t)i * kThreads;
    key[i] = e < end ? order_key(row[e]) : 0u;
    valid += e < end;
  }
  for (int i = threadIdx.x; i < kBins * kCopies; i += kThreads) hist[i] = 0;
  // every block runs before another writes to its inbox: arrive now, wait before the
  // first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();

  unsigned prefix = 0, rank = k;
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 24 - 8 * pass;
    RunCounter counter{hist, pass == 0 ? 0u : (FULL << (shift + 8)), prefix, shift,
                       lane % kCopies};
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (i < valid) counter.add(key[i]);
    for (int64_t e = rest + threadIdx.x; e < end; e += kThreads) counter.add(order_key(row[e]));
    counter.flush();
    __syncthreads();
    // thread t sums the copies 4q .. 4q + 3 (q = t % 4) of bin t / 4 and zeroes them;
    // a quarter-warp's shuffles add the four parts, which go to every block's inbox
    {
      uint4* h = reinterpret_cast<uint4*>(hist) + threadIdx.x;
      const uint4 a = *h;
      *h = make_uint4(0, 0, 0, 0);
      unsigned v = a.x + a.y + a.z + a.w;
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      if (pass == 0) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      if ((threadIdx.x & 3) == 0) {
        unsigned* slot = &inbox[pass & 1][rank_c][threadIdx.x >> 2];
#pragma unroll
        for (int r = 0; r < C; ++r) *cluster.map_shared_rank(slot, r) = v;
      }
    }
    cluster.sync();   // every block's histogram of this pass is in every inbox
    if (warp == 0) {
      // lane l holds the cluster's bins 255 - 8l .. 248 - 8l (t[j]: bin 255 - 8l - j);
      // a prefix sum over the lanes gives the count above each lane's bins, and the
      // lane whose range holds the rank walks them
      unsigned t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const uint4* src = reinterpret_cast<const uint4*>(&inbox[pass & 1][r][248 - 8 * lane]);
        const uint4 lo = src[0], hi = src[1];
        t[7] += lo.x, t[6] += lo.y, t[5] += lo.z, t[4] += lo.w;
        t[3] += hi.x, t[2] += hi.y, t[1] += hi.z, t[0] += hi.w;
      }
      unsigned local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) local += t[j];
      unsigned incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned above = incl - local;   // keys in the bins above this lane's
      if (above < rank && rank <= incl) {
        unsigned cum = above, before = above, j_sel = 7, in_bin = 0;
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {   // the first bin at which the count reaches the rank
          if (!found && cum + t[j] >= rank) found = true, j_sel = j, before = cum, in_bin = t[j];
          cum += t[j];
        }
        s_prefix = prefix | ((255u - 8u * lane - j_sel) << shift);
        s_rank = rank - before;
        s_alone = in_bin == 1;
      }
    }
    __syncthreads();
    // every thread reads these before the next pass's first barrier, and warp 0
    // writes them again only after that barrier
    prefix = s_prefix;
    rank = s_rank;
    if (s_alone && pass < kPasses - 1) {
      // one key of the row has these top bits: the k-th; the block that holds it
      // writes it, and every block stops here (each read the same histograms)
      const unsigned mask = FULL << shift;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        if (i < valid && (key[i] & mask) == prefix) *result = key_value(key[i]);
      for (int64_t e = rest + threadIdx.x; e < end; e += kThreads) {
        const unsigned u = order_key(row[e]);
        if ((u & mask) == prefix) *result = key_value(u);
      }
      return;
    }
  }
  // no block writes to another's inbox after the last pass's barrier, so a block may
  // leave at once
  if (rank_c == 0 && threadIdx.x == 0) *result = key_value(prefix);
}

// The barriers a pass of kth_largest_kernel<C> waits on (block, cluster, block),
// `passes` times, and no other work: the kernel's latency floor.
template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads, 1)
barrier_chain_kernel(int passes) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int p = 0; p < passes; ++p) {
    __syncthreads();
    cluster.sync();
    __syncthreads();
  }
}

template <int C>
int launch(const float* x, float* out, int rows, long long n, int k, cudaStream_t st) {
  const long long chunk = (n + C - 1) / C;
  kth_largest_kernel<C><<<rows * C, kThreads, 0, st>>>(x, out, (int64_t)n, (unsigned)k,
                                                       (int64_t)chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, n) contiguous float32; out: (rows,) float32; 1 <= k <= n; cluster: the
// blocks a row, 4 or 8 (training/losses.py `kth_largest_plan`); rows * cluster < 2^31.
// Returns cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError() after the launch.
extern "C" int fiery_kth_largest(const void* x, void* out, int rows, long long n, int k,
                                 int cluster, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (k < 1 || (long long)k > n || rows < 0 || (long long)rows * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* xs = (const float*)x;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cluster) {
    case 4: return launch<4>(xs, o, rows, n, k, st);
    case 8: return launch<8>(xs, o, rows, n, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The latency floor of a call: barrier_chain_kernel<cluster> on rows clusters,
// `passes` passes (4 for a call that runs them all; 0 for the launch alone).
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_kth_largest_barrier_chain(int rows, int cluster, int passes,
                                               void* stream) {
  if (rows <= 0 || passes < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cluster) {
    case 4: barrier_chain_kernel<4><<<rows * 4, kThreads, 0, st>>>(passes); break;
    case 8: barrier_chain_kernel<8><<<rows * 8, kThreads, 0, st>>>(passes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
