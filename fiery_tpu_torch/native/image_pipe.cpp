// Host image pipe of the data loader: JPEG decode (libjpeg) -> antialiased
// bilinear resize (Pillow's triangle filter) -> crop -> normalisation, on a pool
// of threads across a batch of images. A copy of fiery_tpu/native/image_pipe.cpp.
//
// It stands in for the per-image PIL loop (Image.open -> resize(BILINEAR) ->
// crop): 7 frames x 6 cameras of JPEG decode a sample. The resize follows
// Pillow's antialiased BILINEAR (a triangle filter whose support grows with the
// downscale ratio, fixed-point weights, uint8 rounding after each pass), so its
// pixels stay within 1 LSB of Pillow's.
//
// Build: g++ -O3 -shared -fPIC image_pipe.cpp -o libimage_pipe.so -ljpeg -lpthread
// (fiery_tpu_torch/native/__init__.py builds it into fiery_tpu_torch/build/ at
// first use; a plain C interface, called through ctypes).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG to tightly packed RGB8. Returns 0 on success.
// min_w/min_h > 0 enable DCT-domain scaled decoding (the FAST_DECODE path):
// libjpeg decodes at the smallest M/8 ratio whose output still covers
// (min_w, min_h), so the IDCT and pixel traffic shrink up to 64x before the
// (unchanged) antialiased resize finishes the job. Approximate relative to
// the full-resolution decode+resize reference; selected per call.
int decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                int* width, int* height, int min_w = 0, int min_h = 0) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (min_w > 0 && min_h > 0) {
    for (int num = 1; num <= 8; ++num) {
      cinfo.scale_num = num;
      cinfo.scale_denom = 8;
      jpeg_calc_output_dimensions(&cinfo);
      if (static_cast<int>(cinfo.output_width) >= min_w &&
          static_cast<int>(cinfo.output_height) >= min_h)
        break;
    }
  }
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  out->resize(static_cast<size_t>(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Pillow-convention resample weights for one axis: triangle filter, support
// widened by the downscale ratio (antialias), weights normalised to 1.
struct AxisWeights {
  std::vector<int> xmin, count;
  // per output index: count[i] fixed-point taps starting at xmin[i]
  std::vector<int32_t> weights;
  int max_count = 0;
};

// Fixed-point weight precision: Pillow's own 8bpc resample quantizes its
// normalised double coefficients to int32 at this scale and accumulates in
// int32 (src/libImaging/Resample.c); the same integer arithmetic gives
// Pillow's rounding.
constexpr int kPrecisionBits = 15;

AxisWeights build_weights(int in_size, int out_size) {
  AxisWeights w;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear filter support
  w.xmin.resize(out_size);
  w.count.resize(out_size);
  int kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  w.weights.assign(static_cast<size_t>(out_size) * kmax, 0);
  w.max_count = kmax;
  std::vector<double> tmp(kmax);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    double total = 0.0;
    for (int k = lo; k < hi; ++k) {
      double t = (k - center + 0.5) / filterscale;
      double v = t < 0 ? 1.0 + t : 1.0 - t;  // triangle
      if (v < 0) v = 0;
      tmp[k - lo] = v;
      total += v;
    }
    for (int k = 0; k < hi - lo; ++k) {
      double v = total > 0 ? tmp[k] / total : 0.0;
      w.weights[static_cast<size_t>(i) * kmax + k] =
          static_cast<int32_t>(std::lround(v * (1 << kPrecisionBits)));
    }
    w.xmin[i] = lo;
    w.count[i] = hi - lo;
  }
  return w;
}

inline uint8_t clip8(int32_t acc) {
  // round-to-nearest of the fixed-point accumulator, clamped to u8
  int32_t r = (acc + (1 << (kPrecisionBits - 1))) >> kPrecisionBits;
  if (r < 0) return 0;
  if (r > 255) return 255;
  return static_cast<uint8_t>(r);
}

// Separable resize with per-pass uint8 rounding (matches Pillow's 8bpc pipeline
// within fixed-point rounding noise). Horizontal first, then vertical.
void resize_rgb8(const uint8_t* src, int in_w, int in_h, uint8_t* dst, int out_w,
                 int out_h) {
  AxisWeights wx = build_weights(in_w, out_w);
  AxisWeights wy = build_weights(in_h, out_h);
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int32_t* ws = &wx.weights[static_cast<size_t>(x) * wx.max_count];
      int lo = wx.xmin[x], n = wx.count[x];
      int32_t acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + static_cast<size_t>(lo + k) * 3;
        acc[0] += ws[k] * px[0];
        acc[1] += ws[k] * px[1];
        acc[2] += ws[k] * px[2];
      }
      trow[x * 3 + 0] = clip8(acc[0]);
      trow[x * 3 + 1] = clip8(acc[1]);
      trow[x * 3 + 2] = clip8(acc[2]);
    }
  }
  for (int y = 0; y < out_h; ++y) {
    const int32_t* ws = &wy.weights[static_cast<size_t>(y) * wy.max_count];
    int lo = wy.xmin[y], n = wy.count[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      int32_t acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = tmp.data() + (static_cast<size_t>(lo + k) * out_w + x) * 3;
        acc[0] += ws[k] * px[0];
        acc[1] += ws[k] * px[1];
        acc[2] += ws[k] * px[2];
      }
      drow[x * 3 + 0] = clip8(acc[0]);
      drow[x * 3 + 1] = clip8(acc[1]);
      drow[x * 3 + 2] = clip8(acc[2]);
    }
  }
}

// One image end-to-end into a preallocated (crop_h, crop_w, 3) float32 buffer.
int process_one(const uint8_t* jpeg, size_t len, int resize_w, int resize_h,
                int crop_left, int crop_top, int crop_w, int crop_h,
                const float* mean, const float* stddev, float* out,
                int fast_scale = 0) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (decode_jpeg(jpeg, len, &rgb, &w, &h,
                  fast_scale ? resize_w : 0, fast_scale ? resize_h : 0))
    return 1;
  std::vector<uint8_t> resized;
  const uint8_t* base = rgb.data();
  int base_w = w, base_h = h;
  if (resize_w != w || resize_h != h) {
    resized.resize(static_cast<size_t>(resize_w) * resize_h * 3);
    resize_rgb8(rgb.data(), w, h, resized.data(), resize_w, resize_h);
    base = resized.data();
    base_w = resize_w;
    base_h = resize_h;
  }
  if (crop_left < 0 || crop_top < 0 || crop_left + crop_w > base_w ||
      crop_top + crop_h > base_h)
    return 2;
  for (int y = 0; y < crop_h; ++y) {
    const uint8_t* row =
        base + (static_cast<size_t>(crop_top + y) * base_w + crop_left) * 3;
    float* orow = out + static_cast<size_t>(y) * crop_w * 3;
    for (int x = 0; x < crop_w; ++x) {
      for (int c = 0; c < 3; ++c) {
        orow[x * 3 + c] = (row[x * 3 + c] / 255.0f - mean[c]) / stddev[c];
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Batch API: n JPEGs -> (n, crop_h, crop_w, 3) float32, normalised. Returns the
// number of failures (out rows for failures are zero-filled).
int fp_decode_batch(int n, const uint8_t** jpegs, const size_t* lens, int resize_w,
                    int resize_h, int crop_left, int crop_top, int crop_w,
                    int crop_h, const float* mean, const float* stddev, float* out,
                    int n_threads, int fast_scale) {
  std::atomic<int> next(0), failures(0);
  size_t stride = static_cast<size_t>(crop_h) * crop_w * 3;
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      float* dst = out + stride * i;
      if (process_one(jpegs[i], lens[i], resize_w, resize_h, crop_left, crop_top,
                      crop_w, crop_h, mean, stddev, dst, fast_scale)) {
        std::memset(dst, 0, stride * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    int nt = n_threads < n ? n_threads : n;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Single-image convenience wrapper (same contract as fp_decode_batch with n=1).
int fp_decode_one(const uint8_t* jpeg, size_t len, int resize_w, int resize_h,
                  int crop_left, int crop_top, int crop_w, int crop_h,
                  const float* mean, const float* stddev, float* out) {
  return process_one(jpeg, len, resize_w, resize_h, crop_left, crop_top, crop_w,
                     crop_h, mean, stddev, out);
}

}  // extern "C"
