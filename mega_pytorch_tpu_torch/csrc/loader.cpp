// Native data-loading core: JPEG decode → antialiased resize → BGR255
// normalization → fixed canvas, with a thread-pool batch API.
//
// A copy of the JAX package's mega_pytorch_tpu/csrc/loader.cpp (the code is
// the same, so the two libraries give the same bytes): host code, built
// with g++ and libjpeg by data/native_loader.py and bound with ctypes. It
// decodes with libjpeg and resizes with a PIL-style triangle filter whose
// support scales with the downscale factor, so its output tracks the
// PIL-exact path (data/transforms.py) closely but not bit for bit.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct DecodedImage {
  std::vector<unsigned char> rgb;  // h * w * 3
  int h = 0;
  int w = 0;
};

bool decode_jpeg(const char* path, DecodedImage* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// PIL-style separable triangle resampling coefficients for one axis.
struct AxisCoeffs {
  std::vector<int> first;       // per output pixel: first source index
  std::vector<int> count;       // taps per output pixel
  std::vector<float> weights;   // max_count-strided weights
  int max_count = 0;
};

AxisCoeffs triangle_coeffs(int in_size, int out_size) {
  AxisCoeffs c;
  double scale = double(in_size) / out_size;
  double support = std::max(1.0, scale);  // triangle filter support * scale
  int max_taps = int(std::ceil(support)) * 2 + 1;
  c.first.resize(out_size);
  c.count.resize(out_size);
  c.weights.assign(size_t(out_size) * max_taps, 0.0f);
  c.max_count = max_taps;
  for (int x = 0; x < out_size; ++x) {
    double center = (x + 0.5) * scale;
    int lo = std::max(0, int(std::floor(center - support)));
    int hi = std::min(in_size, int(std::ceil(center + support)));
    double sum = 0.0;
    int n = 0;
    for (int s = lo; s < hi; ++s) {
      double d = std::abs((s + 0.5 - center) / std::max(1.0, scale));
      double wgt = d < 1.0 ? 1.0 - d : 0.0;
      if (wgt <= 0.0 && n == 0 && s + 1 < hi) {
        ++lo;
        continue;
      }
      c.weights[size_t(x) * max_taps + n] = float(wgt);
      sum += wgt;
      ++n;
    }
    if (sum > 0) {
      for (int k = 0; k < n; ++k) c.weights[size_t(x) * max_taps + k] /= float(sum);
    }
    c.first[x] = lo;
    c.count[x] = n;
  }
  return c;
}

void resize_triangle(const DecodedImage& img, int oh, int ow, std::vector<float>* out) {
  AxisCoeffs cx = triangle_coeffs(img.w, ow);
  AxisCoeffs cy = triangle_coeffs(img.h, oh);
  // horizontal pass: (h, ow, 3)
  std::vector<float> tmp(size_t(img.h) * ow * 3);
  for (int y = 0; y < img.h; ++y) {
    const unsigned char* row = img.rgb.data() + size_t(y) * img.w * 3;
    float* trow = tmp.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      float acc[3] = {0, 0, 0};
      int f = cx.first[x], n = cx.count[x];
      const float* wts = cx.weights.data() + size_t(x) * cx.max_count;
      for (int k = 0; k < n; ++k) {
        const unsigned char* px = row + size_t(f + k) * 3;
        acc[0] += wts[k] * px[0];
        acc[1] += wts[k] * px[1];
        acc[2] += wts[k] * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass: (oh, ow, 3)
  out->assign(size_t(oh) * ow * 3, 0.0f);
  for (int y = 0; y < oh; ++y) {
    float* orow = out->data() + size_t(y) * ow * 3;
    int f = cy.first[y], n = cy.count[y];
    const float* wts = cy.weights.data() + size_t(y) * cy.max_count;
    for (int k = 0; k < n; ++k) {
      const float* trow = tmp.data() + size_t(f + k) * ow * 3;
      float wgt = wts[k];
      for (int i = 0; i < ow * 3; ++i) orow[i] += wgt * trow[i];
    }
  }
}

void resize_hw_rule(int h, int w, int min_size, int max_size, int* oh, int* ow) {
  // transforms.py resize_hw: shortest side → min_size, capped at max_size
  double size = min_size;
  int mn = std::min(h, w), mx = std::max(h, w);
  // nearbyint = round-half-to-even, matching python's round()
  if (double(mx) / mn * size > max_size) size = std::nearbyint(double(max_size) * mn / mx);
  if (h < w) {
    *oh = int(size);
    *ow = int(size * w / double(h));
  } else {
    *ow = int(size);
    *oh = int(size * h / double(w));
  }
}

const float kMeanBGR[3] = {102.9801f, 115.9465f, 122.7717f};

int process_one(const char* path, int min_size, int max_size, int flip,
                int canvas_h, int canvas_w, float* out, int* out_hw) {
  DecodedImage img;
  if (!decode_jpeg(path, &img)) return -1;
  int oh, ow;
  resize_hw_rule(img.h, img.w, min_size, max_size, &oh, &ow);
  if (oh > canvas_h || ow > canvas_w) return -2;

  std::vector<float> resized;
  resize_triangle(img, oh, ow, &resized);

  std::memset(out, 0, size_t(canvas_h) * canvas_w * 3 * sizeof(float));
  for (int y = 0; y < oh; ++y) {
    const float* src = resized.data() + size_t(y) * ow * 3;
    float* dst = out + size_t(y) * canvas_w * 3;
    for (int x = 0; x < ow; ++x) {
      int sx = flip ? (ow - 1 - x) : x;
      // RGB → BGR255, mean-subtracted
      dst[x * 3 + 0] = src[sx * 3 + 2] - kMeanBGR[0];
      dst[x * 3 + 1] = src[sx * 3 + 1] - kMeanBGR[1];
      dst[x * 3 + 2] = src[sx * 3 + 0] - kMeanBGR[2];
    }
  }
  out_hw[0] = oh;
  out_hw[1] = ow;
  return 0;
}

}  // namespace

extern "C" {

int decode_resize_normalize(const char* path, int min_size, int max_size,
                            int flip, int canvas_h, int canvas_w, float* out,
                            int* out_hw) {
  return process_one(path, min_size, max_size, flip, canvas_h, canvas_w, out, out_hw);
}

// Batch API with a transient thread pool. outs is one contiguous buffer of
// n * canvas_h * canvas_w * 3 floats; out_hws holds n (h, w) pairs.
// Returns the number of failures (0 = all good).
int decode_batch(const char** paths, int n, int min_size, int max_size,
                 const int* flips, int canvas_h, int canvas_w, float* outs,
                 int* out_hws, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  size_t stride = size_t(canvas_h) * canvas_w * 3;
  int workers = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        int rc = process_one(paths[i], min_size, max_size, flips[i], canvas_h,
                             canvas_w, outs + stride * i, out_hws + 2 * i);
        if (rc != 0) failures.fetch_add(1);
      }
    });
  }
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
