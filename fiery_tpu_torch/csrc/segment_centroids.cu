// segment_centroids: per-frame pixel count and mean coordinate of every id of a label
// map, over the pixel grid or over the grid advected by a flow field.
//
// Replaces: the centroid sums of fiery_tpu/postprocess/instance.py
// `make_instance_id_temporally_consistent_device` (`centers_of`, three f32
// segment_sums) and of the host tracker's `_segment_centroids` (f64 bincounts).
//
// Computes, for frame b and id s in [0, S) (ids outside are dropped):
//     (x, y) = (i, j) or (i + flow[b, i, j, 0], j + flow[b, i, j, 1])  (f32 add)
//     count_s = #{pixels with label s};  sx_s, sy_s = sums of x, y in f64
//     centre_s = f32(sx_s / max(count_s, 1)), f32(sy_s / max(count_s, 1));
//     valid_s = count_s > 0.
//
// Bound on an H100: bytes. At the tracker's shapes (one 200 x 200 frame, 101 or 501
// slots) the kernel reads 160 KB of labels (+320 KB of flow) and writes under 5 KB:
// 0.05-0.15 us at 3.35 TB/s, far below one launch; the 3 f64 adds per pixel are
// negligible too.
//
// Design: one thread sums a run of 8 consecutive pixels while their label stays the
// same (instances are runs along a row), then adds the run to the block's
// shared-memory f64 sums; each block adds its non-empty slots to global f64 sums
// with atomics, and the last block of the frame to finish (a counter in global
// memory) divides. The sums are f64, so their order (atomics) changes them by about
// 1e-16 relative and the f32 centroid by at most one f32 ulp, against a plain
// version that sums in f64 in index order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 8;

__global__ void __launch_bounds__(THREADS)
centroid_kernel(const int* __restrict__ labels, const float* __restrict__ flow, int hw,
                int w, int S, double* __restrict__ acc, unsigned* __restrict__ done,
                float* __restrict__ centers, uint8_t* __restrict__ valid) {
  extern __shared__ double smem[];
  double* s_x = smem;
  double* s_y = smem + S;
  unsigned* s_n = reinterpret_cast<unsigned*>(smem + 2 * S);
  __shared__ bool s_last;
  const int b = blockIdx.y;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    s_x[s] = 0.0;
    s_y[s] = 0.0;
    s_n[s] = 0u;
  }
  __syncthreads();

  const int start = (blockIdx.x * THREADS + threadIdx.x) * RUN;
  const int* L = labels + (int64_t)b * hw;
  const float* F = flow ? flow + (int64_t)b * hw * 2 : nullptr;
  int run_id = -1;
  unsigned run_n = 0u;
  double run_x = 0.0, run_y = 0.0;
  for (int p = start; p < min(start + RUN, hw); ++p) {
    const int id = L[p];
    if (id < 0 || id >= S) continue;
    if (id != run_id) {
      if (run_id >= 0) {
        atomicAdd(&s_n[run_id], run_n);
        atomicAdd(&s_x[run_id], run_x);
        atomicAdd(&s_y[run_id], run_y);
      }
      run_id = id;
      run_n = 0u;
      run_x = 0.0;
      run_y = 0.0;
    }
    const int i = p / w, j = p - (p / w) * w;
    const float x = F ? __fadd_rn((float)i, F[2 * p]) : (float)i;
    const float y = F ? __fadd_rn((float)j, F[2 * p + 1]) : (float)j;
    run_n += 1u;
    run_x += (double)x;
    run_y += (double)y;
  }
  if (run_id >= 0) {
    atomicAdd(&s_n[run_id], run_n);
    atomicAdd(&s_x[run_id], run_x);
    atomicAdd(&s_y[run_id], run_y);
  }
  __syncthreads();

  double* A = acc + (int64_t)b * S * 3;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    if (s_n[s] == 0u) continue;
    atomicAdd(&A[3 * s], (double)s_n[s]);
    atomicAdd(&A[3 * s + 1], s_x[s]);
    atomicAdd(&A[3 * s + 2], s_y[s]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&done[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const double n = __ldcg(&A[3 * s]);
    const double d = n > 1.0 ? n : 1.0;
    const int64_t o = (int64_t)b * S + s;
    centers[2 * o] = (float)(__ldcg(&A[3 * s + 1]) / d);
    centers[2 * o + 1] = (float)(__ldcg(&A[3 * s + 2]) / d);
    valid[o] = n > 0.0 ? 1 : 0;
  }
}

}  // namespace

// labels: (B, h, w) int32; flow: (B, h, w, 2) float32 or null (pixel grid only);
// acc: (B, S, 3) float64 and done: (B,) uint32, both zeroed scratch;
// centers: (B, S, 2) float32 out; valid: (B, S) uint8 out. All contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int fiery_segment_centroids(const void* labels, const void* flow, void* acc,
                                       void* done, void* centers, void* valid, int B, int h,
                                       int w, int S, void* stream) {
  const int hw = h * w;
  if (B == 0) return (int)cudaSuccess;
  const size_t shared = (size_t)S * (2 * sizeof(double) + sizeof(unsigned));
  if (S < 1 || shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int per_block = THREADS * RUN;
  const dim3 grid(hw > 0 ? (hw + per_block - 1) / per_block : 1, B);
  centroid_kernel<<<grid, THREADS, shared, (cudaStream_t)stream>>>(
      (const int*)labels, (const float*)flow, hw, w, S, (double*)acc, (unsigned*)done,
      (float*)centers, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
