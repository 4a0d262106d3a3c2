// group_pixels: per-pixel instance ids of a decoded frame (nearest valid centre after
// the predicted offset, inside the vehicle foreground), then the consecutive relabel.
//
// Replaces: fiery_tpu/postprocess/instance.py `group_pixels` (a (K, h, w) distance
// tensor and an argmin), the foreground mask of `decode_instance_predictions` and
// `get_instance_segmentation_and_centers`, and `make_instance_seg_consecutive` (a
// (max_ids, h, w) broadcast compare).
//
// Computes, per pixel (i, j) of frame b, in two launches:
//   (a) fg = argmax_c seg[b, i, j, c] == vehicles_id (first maximum wins);
//       px = i + off[..., 0], py = j + off[..., 1];
//       d_k = dx * dx + dy * dy with dx = cx_k - px, dy = cy_k - py (+inf if centre k
//       is invalid); id = 1 + first argmin_k d_k if fg and any centre is valid, else 0;
//       present[b][id] = 1.
//   (b) mapping[id] = (number of present ids <= id) - 1, id 0 always present;
//       id = mapping[id].
//
// Bound on an H100: bytes, closely followed by operations. 5 frames of 200 x 200
// pixels read 1.6 MB of offsets and 1.6 MB of 2-class logits and write 0.8 MB of
// ids (1.2 us at 3.35 TB/s); the distances take 5 f32 operations per foreground
// pixel and valid centre (100 centres and half the pixels in the foreground:
// 50 MFLOP, 0.75 us at 67 TFLOP/s).
//
// Design: one thread per pixel; the frame's centres and valid flags sit in shared
// memory, so each distance is 4 shared loads away. The distance is computed with
// explicitly rounded intrinsics in the plain version's order: nvcc would otherwise
// contract dx * dx + dy * dy into an FMA, which flips the argmin on near-ties.
// The relabel is a second launch so that every pixel of the frame has marked its id
// before any pixel is remapped; it remaps in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 1024;

__global__ void __launch_bounds__(THREADS)
assign_kernel(const int* __restrict__ centers, const uint8_t* __restrict__ valid,
              const float* __restrict__ offset, const float* __restrict__ seg,
              int* __restrict__ ids, int* __restrict__ present, int hw, int w, int K, int C,
              int vehicles_id) {
  __shared__ float s_cx[MAX_K], s_cy[MAX_K];
  __shared__ uint8_t s_valid[MAX_K];
  const int b = blockIdx.y;
  int mine = 0;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const int64_t o = (int64_t)b * K + k;
    s_cx[k] = (float)centers[2 * o];
    s_cy[k] = (float)centers[2 * o + 1];
    s_valid[k] = valid[o];
    mine |= valid[o];
  }
  const int any_valid = __syncthreads_or(mine);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int64_t q = (int64_t)b * hw + p;

  const float* logits = seg + q * C;
  float best = logits[0];
  int cls = 0;
  for (int c = 1; c < C; ++c) {
    const float l = logits[c];
    if (l > best) {
      best = l;
      cls = c;
    }
  }
  int id = 0;
  if (any_valid && cls == vehicles_id) {
    const int i = p / w, j = p - (p / w) * w;
    const float px = __fadd_rn((float)i, offset[2 * q]);
    const float py = __fadd_rn((float)j, offset[2 * q + 1]);
    float dmin = INFINITY;
    int kmin = 0;
    for (int k = 0; k < K; ++k) {
      if (!s_valid[k]) continue;
      const float dx = __fsub_rn(s_cx[k], px);
      const float dy = __fsub_rn(s_cy[k], py);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (d < dmin) {
        dmin = d;
        kmin = k;
      }
    }
    id = kmin + 1;
  }
  ids[q] = id;
  present[(int64_t)b * (K + 1) + id] = 1;
}

__global__ void __launch_bounds__(THREADS)
relabel_kernel(int* __restrict__ ids, const int* __restrict__ present, int hw, int K) {
  __shared__ int mapping[MAX_K + 1];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) {
    const int* pr = present + (int64_t)b * (K + 1);
    int rank = 0;   // id 0 always counts, so it maps to 0
    mapping[0] = 0;
    for (int id = 1; id <= K; ++id) {
      rank += pr[id] ? 1 : 0;
      mapping[id] = rank;
    }
  }
  __syncthreads();
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int64_t q = (int64_t)b * hw + p;
  ids[q] = mapping[ids[q]];
}

}  // namespace

// centers: (B, K, 2) int32; valid: (B, K) uint8; offset: (B, h, w, 2) float32;
// seg: (B, h, w, C) float32 logits; ids: (B, h, w) int32 out; present: (B, K + 1)
// int32 zeroed scratch. All contiguous, K <= 1024.
// Returns cudaGetLastError() after the launch (`relabel` 0: pass (a), 1: pass (b)).
extern "C" int fiery_group_pixels(const void* centers, const void* valid, const void* offset,
                                  const void* seg, void* ids, void* present, int B, int h,
                                  int w, int K, int C, int vehicles_id, int relabel,
                                  void* stream) {
  const int hw = h * w;
  if (B == 0 || hw == 0) return (int)cudaSuccess;
  if (K < 1 || K > MAX_K || C < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((hw + THREADS - 1) / THREADS, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (!relabel) {
    assign_kernel<<<grid, THREADS, 0, st>>>(
        (const int*)centers, (const uint8_t*)valid, (const float*)offset, (const float*)seg,
        (int*)ids, (int*)present, hw, w, K, C, vehicles_id);
  } else {
    relabel_kernel<<<grid, THREADS, 0, st>>>((int*)ids, (const int*)present, hw, K);
  }
  return (int)cudaGetLastError();
}
