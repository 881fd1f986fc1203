// hostops: host-side image ops of the port, as a plain C interface bound
// with ctypes by keras_ocr_tpu_torch/native.py.
//
// Bilinear resize, perspective warp, 4-connected labelling and square
// dilation: the operations the reference hands to OpenCV's C++ kernels. The
// device path runs its own versions on the card (keras_ocr_tpu_torch/ops);
// these serve the host oracle of Detector.detect (getBoxes), whose numpy
// paths stay as the fallback. Host code: built with the host C++ compiler,
// not nvcc.
//
// Build: c++ -O3 -shared -fPIC -o libhostops.so hostops.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Bilinear resize, float32, HWC layout. Matches cv2.INTER_LINEAR /
// half-pixel-centers sampling with edge clamping.
void resize_bilinear_f32(const float* src, int src_h, int src_w, int channels,
                         float* dst, int dst_h, int dst_w) {
  const float scale_y = static_cast<float>(src_h) / dst_h;
  const float scale_x = static_cast<float>(src_w) / dst_w;
  for (int y = 0; y < dst_h; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(src_h - 1)));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, src_h - 1);
    const float fy = sy - y0;
    for (int x = 0; x < dst_w; ++x) {
      float sx = (x + 0.5f) * scale_x - 0.5f;
      sx = std::max(0.0f, std::min(sx, static_cast<float>(src_w - 1)));
      const int x0 = static_cast<int>(sx);
      const int x1 = std::min(x0 + 1, src_w - 1);
      const float fx = sx - x0;
      const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
      const float w10 = (1 - fx) * fy, w11 = fx * fy;
      const float* p00 = src + (y0 * src_w + x0) * channels;
      const float* p01 = src + (y0 * src_w + x1) * channels;
      const float* p10 = src + (y1 * src_w + x0) * channels;
      const float* p11 = src + (y1 * src_w + x1) * channels;
      float* out = dst + (y * dst_w + x) * channels;
      for (int c = 0; c < channels; ++c) {
        out[c] = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
      }
    }
  }
}

// Perspective warp, float32 HWC. minv is the inverse (dst -> src) 3x3
// row-major homography; constant border cval, bilinear sampling with
// zero outside (cv2.warpPerspective semantics).
void warp_perspective_f32(const float* src, int src_h, int src_w, int channels,
                          const double* minv, float* dst, int dst_h, int dst_w,
                          float cval) {
  for (int y = 0; y < dst_h; ++y) {
    for (int x = 0; x < dst_w; ++x) {
      const double denom = minv[6] * x + minv[7] * y + minv[8];
      const double sx = (minv[0] * x + minv[1] * y + minv[2]) / denom;
      const double sy = (minv[3] * x + minv[4] * y + minv[5]) / denom;
      float* out = dst + (y * dst_w + x) * channels;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const double fx = sx - x0, fy = sy - y0;
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0;
        const double weights[4] = {(1 - fx) * (1 - fy), fx * (1 - fy),
                                   (1 - fx) * fy, fx * fy};
        const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
        const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
        bool any_inside = false;
        for (int k = 0; k < 4; ++k) {
          if (xs[k] >= 0 && xs[k] < src_w && ys[k] >= 0 && ys[k] < src_h) {
            acc += weights[k] * src[(ys[k] * src_w + xs[k]) * channels + c];
            any_inside = true;
          }
        }
        out[c] = any_inside ? static_cast<float>(acc) : cval;
      }
    }
  }
}

// 4-connected components with union-find; labels are 1..n in raster order
// of first appearance (matching scipy.ndimage.label / the cv2 contract the
// reference relies on). Returns the number of components.
int label_components_u8(const uint8_t* mask, int height, int width,
                        int32_t* labels) {
  const int n = height * width;
  std::vector<int32_t> parent(n);
  for (int i = 0; i < n; ++i) parent[i] = i;
  auto find = [&](int32_t i) {
    while (parent[i] != i) {
      parent[i] = parent[parent[i]];
      i = parent[i];
    }
    return i;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  };
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      const int i = y * width + x;
      if (!mask[i]) continue;
      if (x > 0 && mask[i - 1]) unite(i, i - 1);
      if (y > 0 && mask[i - width]) unite(i, i - width);
    }
  }
  std::vector<int32_t> compact(n, 0);
  int32_t next_id = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) {
      labels[i] = 0;
      continue;
    }
    const int32_t root = find(i);
    if (compact[root] == 0) compact[root] = ++next_id;
    labels[i] = compact[root];
  }
  return next_id;
}

// Square dilation with cv2 anchor semantics: the set grows by k//2 to the
// right/down and k-1-k//2 to the left/up (k = 1 + niter). Done as two
// 1-D sliding-max passes.
void dilate_square_u8(const uint8_t* src, int height, int width, int niter,
                      uint8_t* dst) {
  const int k = 1 + niter;
  const int a = k / 2;          // growth right/down
  const int b = k - 1 - a;      // growth left/up
  std::vector<uint8_t> tmp(static_cast<size_t>(height) * width, 0);
  // Horizontal pass: tmp(x) = any src in [x - a, x + b].
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = src + y * width;
    uint8_t* out = tmp.data() + y * width;
    for (int x = 0; x < width; ++x) {
      const int lo = std::max(0, x - a);
      const int hi = std::min(width - 1, x + b);
      uint8_t v = 0;
      for (int i = lo; i <= hi && !v; ++i) v = row[i];
      out[x] = v;
    }
  }
  // Vertical pass.
  for (int y = 0; y < height; ++y) {
    const int lo = std::max(0, y - a);
    const int hi = std::min(height - 1, y + b);
    uint8_t* out = dst + y * width;
    for (int x = 0; x < width; ++x) {
      uint8_t v = 0;
      for (int i = lo; i <= hi && !v; ++i) v = tmp[i * width + x];
      out[x] = v;
    }
  }
}

}  // extern "C"
