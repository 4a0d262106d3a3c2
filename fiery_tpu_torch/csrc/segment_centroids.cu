// segment_centroids: per-frame pixel count and mean coordinate of every id of a stack
// of label maps, over the pixel grid and over the grid advected by a flow field, for
// all frames in one launch.
//
// Replaces: the centroid sums of fiery_tpu/postprocess/instance.py
// `make_instance_id_temporally_consistent_device` (`centers_of`, three f32
// segment_sums, twice a tracking step) and of the host tracker's
// `_segment_centroids` (f64 bincounts).
//
// Computes, for frame f and id s in [0, S) (ids outside are dropped):
//     count_s = #{pixels (i, j) with label s}
//     grid:   centre_s = f32(sum i / max(count_s, 1)), f32(sum j / max(count_s, 1))
//     flow:   centre_s = the same means of x = f32(i + flow[f, i, j, 0]),
//                                         y = f32(j + flow[f, i, j, 1]), summed in f64
//     valid_s = count_s > 0.
// The grid sums are integers, exact in any order, so the grid centres equal the plain
// version (f64 index_add_, then one division and one rounding) bit for bit. The flow
// sums are f64 in a fixed order (below), within one f32 ulp of the plain version.
//
// Bound on an H100: bytes. The tracker's clip (5 frames of 200 x 200, 101 slots)
// reads 0.8 MB of labels and 1.6 MB of flow and writes 10 KB: 0.7 us at 3.35 TB/s,
// below one launch.
//
// Design: a cluster of CLUSTER blocks a frame (blockIdx.y), each block a contiguous
// run of 256-pixel windows. A window is 32 lanes x 8 consecutive pixels; a lane sums
// each run of equal labels in registers (counts and grid sums as integers, flow sums
// in f64) and adds the run to its warp's slot sums in shared memory when the run
// ends. Runs that end together are added in a fixed order: at the end of a window
// the runs with lane 0's label are summed across the warp by a butterfly (a fixed
// tree over lane positions); every other run goes in lane order among the lanes
// with its label (rounds of an integer atomicMax on a stamped tag per label; runs of
// different labels in the same round). The warps' sums are then added in warp order, and one
// block of the cluster sums each slot over the blocks' shared memory (distributed
// shared memory) in block order and divides. Nothing is zeroed outside the launch,
// there are no global atomics and no float atomics: two calls give the same bits,
// and since the order depends only on which pixels share a label, never on the label
// values, relabelling the ids injectively relabels the results and nothing else.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;       // blocks a frame
constexpr int MAX_WARPS = 16;    // warps a block (fewer when the slots need the room)
constexpr int PX = 8;            // consecutive pixels a lane a window
constexpr int WINDOW = 32 * PX;  // pixels a window
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SHARED = 227 * 1024;

// One run of equal labels in a lane: count, integer grid sums, f64 flow sums.
struct Run {
  int label;
  unsigned n, si, sj;
  double sx, sy;
};

// part: the warp's slot sums, NV arrays of S doubles (count, sum i, sum j[, sum x,
// sum y]). Only this lane writes these slots now.
template <bool FLOW>
__device__ __forceinline__ void add_run(double* part, int S, int label, unsigned n,
                                        unsigned si, unsigned sj, double sx, double sy) {
  part[label] += (double)n;
  part[S + label] += (double)si;
  part[2 * S + label] += (double)sj;
  if (FLOW) {
    part[3 * S + label] += sx;
    part[4 * S + label] += sy;
  }
}

// Add the runs of the lanes where `pred` holds: in rounds, the lowest remaining lane
// of each label adds its run, so the runs of one label go in lane order and runs of
// different labels at once. A round stamps the warp's tag of each label with an
// integer atomicMax of (round << 5 | 31 - lane): the round counter only grows, so
// no tag needs resetting. Called by the whole warp.
template <bool FLOW>
__device__ __forceinline__ void add_runs_in_order(bool pred, const Run& r, double* part,
                                                  int* tag, int S, int lane, int& round) {
  bool todo = pred;
  while (__any_sync(FULL, todo)) {
    const int stamp = (round << 5) | (31 - lane);
    if (todo) atomicMax(&tag[r.label], stamp);
    __syncwarp();
    if (todo && tag[r.label] == stamp) {
      add_run<FLOW>(part, S, r.label, r.n, r.si, r.sj, r.sx, r.sy);
      todo = false;
    }
    ++round;
    __syncwarp();
  }
}

template <bool FLOW, bool VEC>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_WARPS * 32)
centroid_clip_kernel(const int* __restrict__ labels, const float* __restrict__ flow, int hw,
                     int w, int S, float* __restrict__ grid_out,
                     float* __restrict__ flow_out, uint8_t* __restrict__ valid_out) {
  constexpr int NV = FLOW ? 5 : 3;
  extern __shared__ double part_all[];  // [warps][NV][S] sums, then [warps][S] tags
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int frame = blockIdx.y;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tags = reinterpret_cast<int*>(part_all + (size_t)warps * NV * S);
  for (int k = threadIdx.x; k < warps * NV * S; k += blockDim.x) part_all[k] = 0.0;
  for (int k = threadIdx.x; k < warps * S; k += blockDim.x) tags[k] = 0;
  __syncthreads();

  double* part = part_all + (size_t)warp * NV * S;
  int* tag = tags + (size_t)warp * S;
  const int n_win = (hw + WINDOW - 1) / WINDOW;
  const int w0 = (int)((int64_t)n_win * rank / CLUSTER);
  const int w1 = (int)((int64_t)n_win * (rank + 1) / CLUSTER);
  const int* L = labels + (int64_t)frame * hw;
  const float* F = FLOW ? flow + (int64_t)frame * hw * 2 : nullptr;
  int round = 1;

  for (int win = w0 + warp; win < w1; win += warps) {  // uniform across the warp
    const int p0 = win * WINDOW + lane * PX;
    int lab[PX];
    float fx[PX], fy[PX];
    if (VEC && p0 < hw) {  // hw % PX == 0 and 16-byte rows: the lane's 8 pixels are in
      const int4* lp = reinterpret_cast<const int4*>(L + p0);
      const int4 a = lp[0], b = lp[1];
      lab[0] = a.x; lab[1] = a.y; lab[2] = a.z; lab[3] = a.w;
      lab[4] = b.x; lab[5] = b.y; lab[6] = b.z; lab[7] = b.w;
      if (FLOW) {
        const float4* fp = reinterpret_cast<const float4*>(F + 2 * (int64_t)p0);
#pragma unroll
        for (int q = 0; q < PX / 2; ++q) {
          const float4 v = fp[q];
          fx[2 * q] = v.x; fy[2 * q] = v.y; fx[2 * q + 1] = v.z; fy[2 * q + 1] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int p = p0 + k;
        lab[k] = p < hw ? L[p] : -1;
        if (FLOW) {
          fx[k] = p < hw ? F[2 * (int64_t)p] : 0.0f;
          fy[k] = p < hw ? F[2 * (int64_t)p + 1] : 0.0f;
        }
      }
    }
    int i = p0 / w, j = p0 - (p0 / w) * w;
    Run r{-1, 0u, 0u, 0u, 0.0, 0.0};
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      int id = p0 + k < hw ? lab[k] : -1;
      if (id < 0 || id >= S) id = -1;
      add_runs_in_order<FLOW>(r.label >= 0 && id != r.label, r, part, tag, S, lane, round);
      if (id != r.label) r = Run{id, 0u, 0u, 0u, 0.0, 0.0};
      if (id >= 0) {
        r.n += 1u;
        r.si += (unsigned)i;
        r.sj += (unsigned)j;
        if (FLOW) {
          r.sx += (double)__fadd_rn((float)i, fx[k]);
          r.sy += (double)__fadd_rn((float)j, fy[k]);
        }
      }
      if (++j == w) {
        j = 0;
        ++i;
      }
    }
    // the window's last runs: lane 0's label by a butterfly, then the rest in order
    const int pivot = __shfl_sync(FULL, r.label, 0);
    const bool member = pivot >= 0 && r.label == pivot;
    if (pivot >= 0) {
      const unsigned n = __reduce_add_sync(FULL, member ? r.n : 0u);
      const unsigned si = __reduce_add_sync(FULL, member ? r.si : 0u);
      const unsigned sj = __reduce_add_sync(FULL, member ? r.sj : 0u);
      double sx = member ? r.sx : 0.0, sy = member ? r.sy : 0.0;
      if (FLOW) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sx += __shfl_xor_sync(FULL, sx, o);
          sy += __shfl_xor_sync(FULL, sy, o);
        }
      }
      if (lane == 0) add_run<FLOW>(part, S, pivot, n, si, sj, sx, sy);
      __syncwarp();
    }
    add_runs_in_order<FLOW>(r.label >= 0 && !member, r, part, tag, S, lane, round);
  }
  __syncthreads();

  // the warps' sums in warp order, into warp 0's slots
  for (int k = threadIdx.x; k < NV * S; k += blockDim.x) {
    double acc = part_all[k];
    for (int q = 1; q < warps; ++q) acc += part_all[(size_t)q * NV * S + k];
    part_all[k] = acc;
  }
  cluster.sync();

  // each block of the cluster finishes a slice of the slots, summing the blocks in
  // block order
  const int s0 = (int)((int64_t)S * rank / CLUSTER), s1 = (int)((int64_t)S * (rank + 1) / CLUSTER);
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    double v[NV];
    const double* p = cluster.map_shared_rank(part_all, 0);
#pragma unroll
    for (int c = 0; c < NV; ++c) v[c] = p[c * S + s];
    for (int q = 1; q < CLUSTER; ++q) {
      p = cluster.map_shared_rank(part_all, q);
#pragma unroll
      for (int c = 0; c < NV; ++c) v[c] += p[c * S + s];
    }
    const double d = v[0] > 1.0 ? v[0] : 1.0;
    const int64_t o = (int64_t)frame * S + s;
    if (grid_out) {
      grid_out[2 * o] = (float)(v[1] / d);
      grid_out[2 * o + 1] = (float)(v[2] / d);
    }
    if (FLOW) {
      flow_out[2 * o] = (float)(v[3] / d);
      flow_out[2 * o + 1] = (float)(v[4] / d);
    }
    valid_out[o] = v[0] > 0.0 ? 1 : 0;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <bool FLOW, bool VEC>
int launch(const int* labels, const float* flow, int N, int hw, int w, int S, float* grid_out,
           float* flow_out, uint8_t* valid_out, cudaStream_t st) {
  constexpr int NV = FLOW ? 5 : 3;
  const size_t per_warp = (size_t)S * (NV * sizeof(double) + sizeof(int));
  const int warps = (int)(MAX_SHARED / per_warp < MAX_WARPS ? MAX_SHARED / per_warp : MAX_WARPS);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(centroid_clip_kernel<FLOW, VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)MAX_SHARED);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(CLUSTER, N);
  centroid_clip_kernel<FLOW, VEC><<<grid, warps * 32, warps * per_warp, st>>>(
      labels, flow, hw, w, S, grid_out, flow_out, valid_out);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// labels: (N, h, w) int32; flow: (N, h, w, 2) float32 or null; S slots (ids 0..S-1).
// grid_out: (N, S, 2) float32 or null; flow_out: (N, S, 2) float32 (ignored without
// flow); valid_out: (N, S) uint8. All contiguous; nothing needs zeroing. vec: 1 when
// h * w is a multiple of 8 and labels and flow are 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when the slots do not
// fit in shared memory).
extern "C" int fiery_segment_centroids_clip(const void* labels, const void* flow,
                                            void* grid_out, void* flow_out, void* valid_out,
                                            int N, int h, int w, int S, int vec,
                                            void* stream) {
  if (N == 0 || S == 0) return (int)cudaSuccess;
  if (S < 0 || N > 65535 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int hw = h * w;
  cudaStream_t st = (cudaStream_t)stream;
  const int* L = (const int*)labels;
  const float* F = (const float*)flow;
  float* G = (float*)grid_out;
  float* A = (float*)flow_out;
  uint8_t* V = (uint8_t*)valid_out;
  if (F) {
    return vec ? launch<true, true>(L, F, N, hw, w, S, G, A, V, st)
               : launch<true, false>(L, F, N, hw, w, S, G, A, V, st);
  }
  return vec ? launch<false, true>(L, F, N, hw, w, S, G, A, V, st)
             : launch<false, false>(L, F, N, hw, w, S, G, A, V, st);
}

// The most slots a call takes, with and without flow (the slot sums of one warp fill
// the shared memory a block may use).
extern "C" int fiery_segment_centroids_max_slots(int with_flow) {
  return (int)(MAX_SHARED / ((with_flow ? 5 : 3) * sizeof(double) + sizeof(int)));
}

// An empty kernel: its device time is the launch floor that K8's bound sits below.
extern "C" int fiery_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
