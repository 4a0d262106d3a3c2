// lap: exact linear sum assignment of a batch of dense (n, n) f32 cost matrices,
// by Jonker-Volgenant shortest augmenting paths (scipy's algorithm, Crouse 2016).
//
// Replaces: fiery_tpu/ops/lap.py `linear_sum_assignment` (a lax.while_loop of
// Dijkstra steps inside a scan over rows), as the instance tracker calls it
// (fiery_tpu/postprocess/instance.py `make_instance_id_temporally_consistent_device`).
//
// Computes, for problem b, rows cur = 0 .. n_rows[b]-1 in order: a Dijkstra search
// over reduced costs r = ((minval + cost[i][j]) - u[i]) - v[j] from row cur until
// it reaches an unassigned column; among tied minima an unassigned column wins,
// then the lowest index; then the duals over the visited rows (SR) and columns
// (SC), with col4row read before the augmentation:
//     u[k] += minval (k == cur),  u[k] = (u[k] + minval) - spc[col4row[k]] (k != cur)
//     v[c] = v[c] - (minval - spc[c])
// and the augmentation along the predecessor path. A search whose least reduced
// cost is not finite (only non-finite costs lead there) finds no augmenting path:
// it stops and leaves row cur unassigned and the duals as they were. Rows >=
// n_rows[b] get -1. n_rows is read from device memory, so the caller never
// synchronises with the host.
//
// Bound on an H100: neither bytes nor operations. At the tracker's shape (101 x 101,
// up to 101 rows) the kernel reads 41 KB and does a few hundred thousand f32
// operations: both bounds are far below one launch. The algorithm is serial by
// nature: each row's search depends on the previous rows' duals and assignment, and
// each Dijkstra step on the previous step's column; only the O(n) work inside a step
// is parallel. Its latency bound is the number of Dijkstra steps times one
// dependent warp-wide minimum (`fiery_lap_min_chain` measures one).
//
// Design (for the H100): one warp per problem, no block barrier in a Dijkstra step.
// - Column j belongs to lane j / CPL, slot j % CPL (CPL consecutive columns a
//   lane, a template constant: n <= 32 CPL); row k to lane k % 32, slot k / 32. A
//   lane keeps its columns' v in registers and their SC and assigned flags as bit
//   masks, and its rows' SR likewise.
// - The cost matrix is staged once per solve into shared memory by the block's
//   256 threads (cp.async, every copy in flight at once) when it fits (n <= 237:
//   42 KB at n = 101), its rows padded to a multiple of CPL floats, so that a step
//   reads a lane's columns with CPL / 4 16-byte loads; then all but the first warp
//   leave. Larger matrices are read from global memory (L2).
// - A step's minimum: two `redux.sync` minima give every lane the warp's least
//   key: first over the values (the f32 value as order-preserving bits, -0 as +0),
//   then over the tags of the columns that hold the least value (assigned << 21 |
//   column << 10 | the column's row, so that ties go to an unassigned column, then
//   the lowest index, and the next row needs no look-up). Each lane first reduces
//   its own columns as a tree.
// - u, row4col and col4row live in shared memory. spc, its key and the
//   predecessors stay in registers during a search; a step updates them with
//   selects, not branches (a branch let the compiler sink each column's load and
//   arithmetic into it, and the columns then waited one after another). They are
//   written to shared memory when the search ends, for the rows' dual update and
//   for lane 0, which walks the augmenting path.
// What holds it above its latency bound (chip_smoke.py `lap_breakdown` splits the
// time into a launch, rows and steps): a step's two dependent redux.sync are a
// quarter of it; the rest is the step's ~90 instructions, issued in order by one
// warp, and each row's dual update and path walk.
// Every f32 operation is an explicitly rounded intrinsic in lap.py's order, so the
// result equals the JAX solver and the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageThreads = 256;
constexpr int kMaxSmem = 232448;     // the dynamic shared memory a block may have (H100)

// the f32 value's bits in an order that unsigned comparison keeps; -0 as +0 (the
// sum -0 + 0 is +0)
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.0f));
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}
__device__ __forceinline__ float from_order_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
constexpr unsigned kInfKey = 0xff800000u;      // order_bits(+inf)
constexpr unsigned kNegInfKey = 0x007fffffu;   // order_bits(-inf)

// the least of a lane's CPL values, as a tree
template <int CPL>
__device__ __forceinline__ unsigned tree_min(const unsigned (&v)[CPL]) {
  unsigned a[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) a[k] = v[k];
#pragma unroll
  for (int s = 1; s < CPL; s *= 2) {
#pragma unroll
    for (int k = 0; k + s < CPL; k += 2 * s) a[k] = min(a[k], a[k + s]);
  }
  return a[0];
}

// The staged matrix's row pitch in floats: a multiple of CPL (>= 4) so that a lane's
// CPL columns of a row are one aligned run of 16-byte loads; n when not staged.
template <int CPL, bool STAGED>
__host__ __device__ constexpr int pitch_of(int n) {
  return STAGED && CPL >= 4 ? (n + CPL - 1) / CPL * CPL : n;
}

template <int CPL, bool STAGED>
__global__ void __launch_bounds__(kStageThreads)
lap_kernel(const float* __restrict__ cost, const int* __restrict__ n_rows,
           int* __restrict__ col4row_out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = pitch_of<CPL, STAGED>(n);
  float* cs = reinterpret_cast<float*>(smem);
  float* u = cs + (STAGED ? n * P : 0);
  float* spc_s = u + n;
  int* path = reinterpret_cast<int*>(spc_s + n);
  int* row4col = path + n;
  int* col4row = row4col + n;

  const int b = blockIdx.x;
  const float* C = cost + (int64_t)b * n * n;
  if (STAGED) {               // warp w copies rows w, w + 8, ..., all copies in flight
    for (int i = threadIdx.x / 32; i < n; i += kStageThreads / 32) {
      for (int j = threadIdx.x % 32; j < n; j += 32) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(cs + i * P + j);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                     "l"(C + (int64_t)i * n + j));
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int nr = min(max(n_rows[b], 0), n);
  // column j = lane * CPL + k is the lane's slot k (rows are dealt as k * 32 + lane)
  const int j0 = lane * CPL;
  // where the lane reads its columns of a staged row: j0, or for a lane without
  // columns any place inside the row
  const int base = min(j0, P - CPL);

  for (int k = lane; k < n; k += 32) {
    u[k] = 0.0f;
    row4col[k] = -1;
    col4row[k] = -1;
  }
  float v[CPL];
  unsigned columns = 0;        // bit k: column j0 + k exists
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    v[k] = 0.0f;
    columns |= (j0 + k < n ? 1u : 0u) << k;
  }
  unsigned assigned = 0;       // bit k: column j0 + k has a row
  __syncwarp();

  for (int cur = 0; cur < nr; ++cur) {
    // the lane's columns: spc, its order bits, the predecessor row and the tag, in
    // registers; the tag orders tied columns (unassigned first, then by index) and
    // carries the column's row, so that a step needs no look-up of row4col
    float spc[CPL];
    unsigned key[CPL], tag[CPL];
    int pred[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = min(j0 + k, n - 1);
      spc[k] = INFINITY;
      key[k] = kInfKey;
      pred[k] = -1;
      tag[k] = (((assigned >> k) & 1u) << 21) | ((unsigned)j << 10) | (row4col[j] & 1023u);
    }
    unsigned open = columns;                                     // bit k: not in SC
    unsigned sr = lane == (cur & 31) ? 1u << (cur >> 5) : 0u;    // bit k: row in SR
    int i = cur, sink = -1;
    float minval = 0.0f;
    for (int step = 0; step < n; ++step) {   // each step takes one column
      const float ui = u[i];
      float c[CPL];
      if constexpr (STAGED && CPL >= 4) {
        const float4* row = reinterpret_cast<const float4*>(cs + i * P + base);
#pragma unroll
        for (int q = 0; q < CPL / 4; ++q) {
          const float4 t = row[q];
          c[4 * q] = t.x;
          c[4 * q + 1] = t.y;
          c[4 * q + 2] = t.z;
          c[4 * q + 3] = t.w;
        }
      } else {
        const float* row = (STAGED ? cs : C) + (int64_t)i * P;
#pragma unroll
        for (int k = 0; k < CPL; ++k) c[k] = row[min(j0 + k, n - 1)];
      }
      unsigned kv[CPL];
      // selects, not branches: a branch lets the compiler sink each column's work
      // into it, and the columns then wait one after another
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const bool in = (open >> k) & 1u;
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(minval, c[k]), ui), v[k]);
        const bool better = in & (r < spc[k]);
        spc[k] = better ? r : spc[k];
        key[k] = better ? order_bits(r) : key[k];
        pred[k] = better ? i : pred[k];
        kv[k] = in ? key[k] : kFull;
      }
      const unsigned v_min = __reduce_min_sync(kFull, tree_min<CPL>(kv));
#pragma unroll
      for (int k = 0; k < CPL; ++k) kv[k] = kv[k] == v_min ? tag[k] : kFull;
      const unsigned t_min = __reduce_min_sync(kFull, tree_min<CPL>(kv));
      // no finite path (the least value +inf or -inf): the row stays unassigned
      if (v_min >= kInfKey || v_min <= kNegInfKey) break;
      minval = from_order_bits(v_min);
      const int j = (int)((t_min >> 10) & 1023u);
      if (lane == j / CPL) open &= ~(1u << (j % CPL));
      if (!(t_min >> 21)) {
        sink = j;
        break;
      }
      i = (int)(t_min & 1023u);
      if (lane == (i & 31)) sr |= 1u << (i >> 5);
    }
    if (sink < 0) continue;
    const unsigned sc = columns & ~open;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if ((columns >> k) & 1u) {
        spc_s[j0 + k] = spc[k];
        path[j0 + k] = pred[k];
      }
    }
    __syncwarp();
    float uk[CPL], sk[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int row = min(k * 32 + lane, n - 1);
      uk[k] = u[row];
      sk[k] = spc_s[min(max(col4row[row], 0), n - 1)];
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int row = k * 32 + lane;
      if ((sr >> k) & 1u) {
        u[row] = row == cur ? __fadd_rn(uk[k], minval)
                            : __fsub_rn(__fadd_rn(uk[k], minval), sk[k]);
      }
      if ((sc >> k) & 1u) v[k] = __fsub_rn(v[k], __fsub_rn(minval, spc[k]));
    }
    __syncwarp();
    if (lane == 0) {
      int j = sink;
      for (int hop = 0; hop < n; ++hop) {
        const int r = path[j];
        row4col[j] = r;
        const int nxt = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = nxt;
      }
    }
    if (lane == sink / CPL) assigned |= 1u << (sink % CPL);
    __syncwarp();
  }
  for (int k = lane; k < n; k += 32) col4row_out[(int64_t)b * n + k] = col4row[k];
}

template <int CPL, bool STAGED>
size_t shared_bytes(int n) {
  return (size_t)5 * n * sizeof(float) + (STAGED ? (size_t)n * pitch_of<CPL, true>(n) * 4 : 0);
}

template <int CPL, bool STAGED>
cudaError_t launch_as(const float* cost, const int* n_rows, int* col4row, int B, int n,
                      cudaStream_t st) {
  const size_t shared = shared_bytes<CPL, STAGED>(n);
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lap_kernel<CPL, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return e;
  }
  lap_kernel<CPL, STAGED><<<B, STAGED ? kStageThreads : 32, shared, st>>>(cost, n_rows,
                                                                          col4row, n);
  return cudaGetLastError();
}

// the matrix is staged into shared memory when it fits beside the per-column state
template <int CPL>
cudaError_t launch(const float* cost, const int* n_rows, int* col4row, int B, int n,
                   cudaStream_t st) {
  if constexpr (CPL <= 8) {
    if (shared_bytes<CPL, true>(n) <= (size_t)kMaxSmem) {
      return launch_as<CPL, true>(cost, n_rows, col4row, B, n, st);
    }
  }
  return launch_as<CPL, false>(cost, n_rows, col4row, B, n, st);
}

// A chain of dependent warp-wide minima: each lane's next value depends on the
// last minimum, so the loop takes iters times the latency of one redux.sync.
__global__ void min_chain_kernel(int iters, unsigned* out) {
  unsigned x = threadIdx.x * 2654435761u;
  for (int k = 0; k < iters; ++k) x = __reduce_min_sync(kFull, x) + threadIdx.x + 1u;
  if (threadIdx.x == 0) *out = x;
}

}  // namespace

// cost: (B, n, n) float32 contiguous; n_rows: (B,) int32 on the device;
// col4row: (B, n) int32 out. 1 <= n <= 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_lap(const void* cost, const void* n_rows, void* col4row, int B, int n,
                         void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  const float* c = (const float*)cost;
  const int* r = (const int*)n_rows;
  int* out = (int*)col4row;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (n <= 32) e = launch<1>(c, r, out, B, n, st);
  else if (n <= 64) e = launch<2>(c, r, out, B, n, st);
  else if (n <= 128) e = launch<4>(c, r, out, B, n, st);
  else if (n <= 256) e = launch<8>(c, r, out, B, n, st);
  else if (n <= 512) e = launch<16>(c, r, out, B, n, st);
  else e = launch<32>(c, r, out, B, n, st);
  return (int)e;
}

// One warp runs `iters` dependent warp-wide minima (redux.sync) and writes the
// last into out (one unsigned int on the device). For timing only.
extern "C" int fiery_lap_min_chain(int iters, void* out, void* stream) {
  min_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(iters, (unsigned*)out);
  return (int)cudaGetLastError();
}
