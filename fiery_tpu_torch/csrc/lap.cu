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
// and the augmentation along the predecessor path. Rows >= n_rows[b] get -1.
// n_rows is read from device memory, so the caller never synchronises with the host.
//
// Bound on an H100: neither bytes nor operations. At the tracker's shape (101 x 101,
// up to 101 rows) the kernel reads 41 KB and does a few hundred thousand f32
// operations: both bounds are far below one launch. The algorithm is serial by
// nature: each row's search depends on the previous rows' duals and assignment, and
// each Dijkstra step on the previous step's column; only the O(n) work inside a step
// is parallel. The latency is the number of steps times one block-wide argmin.
//
// Design: one block per problem, one thread per column (n <= 1024). u, v, spc, path,
// row4col, col4row, SR and SC live in shared memory; the cost rows are read from
// global memory (L1/L2 resident). Each step is a block-wide argmin of the key
// (value, column taken, index) by warp shuffles; thread 0 walks the augmenting path.
// Every f32 operation is an explicitly rounded intrinsic in lap.py's order, so the
// result equals the JAX solver and the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// lexicographic (val, tag) minimum; tag = taken * 2048 + column
__device__ __forceinline__ bool key_less(float va, int ta, float vb, int tb) {
  return va < vb || (va == vb && ta < tb);
}

__global__ void lap_kernel(const float* __restrict__ cost, const int* __restrict__ n_rows,
                           int* __restrict__ col4row_out, int n) {
  extern __shared__ unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);
  float* v = u + n;
  float* spc = v + n;
  int* path = reinterpret_cast<int*>(spc + n);
  int* row4col = path + n;
  int* col4row = row4col + n;
  unsigned char* SR = reinterpret_cast<unsigned char*>(col4row + n);
  unsigned char* SC = SR + n;
  __shared__ float red_val[32];
  __shared__ int red_tag[32];
  __shared__ int s_i, s_sink;
  __shared__ float s_minval;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;
  const float* C = cost + (int64_t)b * n * n;
  const int nr = min(max(n_rows[b], 0), n);

  for (int k = t; k < n; k += blockDim.x) {
    u[k] = 0.0f;
    v[k] = 0.0f;
    row4col[k] = -1;
    col4row[k] = -1;
  }
  for (int cur = 0; cur < nr; ++cur) {
    for (int k = t; k < n; k += blockDim.x) {
      SR[k] = 0;
      SC[k] = 0;
      spc[k] = INFINITY;
      path[k] = -1;
    }
    if (t == 0) {
      s_i = cur;
      s_sink = -1;
      s_minval = 0.0f;
    }
    __syncthreads();
    for (int step = 0; step < n; ++step) {   // each step takes one column
      const int i = s_i;
      const float minval = s_minval;
      const float ui = u[i];
      const float* Ci = C + (int64_t)i * n;
      float best_v = INFINITY;
      int best_t = 0x7fffffff;
      for (int j = t; j < n; j += blockDim.x) {
        if (SC[j]) continue;
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(minval, Ci[j]), ui), v[j]);
        float s = spc[j];
        if (r < s) {
          s = r;
          spc[j] = r;
          path[j] = i;
        }
        const int tag = (row4col[j] >= 0 ? 2048 : 0) + j;
        if (key_less(s, tag, best_v, best_t)) {
          best_v = s;
          best_t = tag;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best_v, o);
        const int ot = __shfl_down_sync(0xffffffffu, best_t, o);
        if (key_less(ov, ot, best_v, best_t)) {
          best_v = ov;
          best_t = ot;
        }
      }
      if (lane == 0) {
        red_val[warp] = best_v;
        red_tag[warp] = best_t;
      }
      __syncthreads();
      if (t == 0) {
        for (int w = 1; w < n_warps; ++w) {
          if (key_less(red_val[w], red_tag[w], best_v, best_t)) {
            best_v = red_val[w];
            best_t = red_tag[w];
          }
        }
        const int j = best_t & 2047;
        SR[i] = 1;
        SC[j] = 1;
        s_minval = best_v;
        if (row4col[j] < 0) {
          s_sink = j;
        } else {
          s_i = row4col[j];
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }
    const int sink = s_sink;
    if (sink < 0) continue;   // only with non-finite costs: the row stays unassigned
    const float minval = s_minval;
    for (int k = t; k < n; k += blockDim.x) {
      if (SR[k]) {
        u[k] = k == cur ? __fadd_rn(u[k], minval)
                        : __fsub_rn(__fadd_rn(u[k], minval), spc[min(max(col4row[k], 0), n - 1)]);
      }
      if (SC[k]) v[k] = __fsub_rn(v[k], __fsub_rn(minval, spc[k]));
    }
    __syncthreads();
    if (t == 0) {
      int j = sink;
      for (int hop = 0; hop < n; ++hop) {
        const int i = path[j];
        row4col[j] = i;
        const int nxt = col4row[i];
        col4row[i] = j;
        if (i == cur) break;
        j = nxt;
      }
    }
    __syncthreads();
  }
  for (int k = t; k < n; k += blockDim.x) col4row_out[(int64_t)b * n + k] = col4row[k];
}

}  // namespace

// cost: (B, n, n) float32 contiguous; n_rows: (B,) int32 on the device;
// col4row: (B, n) int32 out. 1 <= n <= 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_lap(const void* cost, const void* n_rows, void* col4row, int B, int n,
                         void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  const size_t shared = (size_t)n * (3 * sizeof(float) + 3 * sizeof(int) + 2);
  lap_kernel<<<B, threads, shared, (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)n_rows, (int*)col4row, n);
  return (int)cudaGetLastError();
}
