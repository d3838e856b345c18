// Host ops of the segmentation eval harnesses: nearest-neighbour resize,
// histogram intersection / union, pixel accuracy, 3x3 gaussian blur.
//
// Plain C ABI, built with g++ into a shared library and bound through ctypes
// by conceptattention_torch/native.py, which checks shapes and contiguity
// before it passes a pointer. The numpy versions beside the bindings are
// the plain versions the tests hold these to.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// dst[oh, ow] = src[i * h / oh, j * w / ow].
void nearest_resize_f32(const float* src, int64_t h, int64_t w,
                        float* dst, int64_t oh, int64_t ow) {
  for (int64_t i = 0; i < oh; ++i) {
    const float* row = src + std::min<int64_t>(i * h / oh, h - 1) * w;
    float* out = dst + i * ow;
    for (int64_t j = 0; j < ow; ++j) out[j] = row[std::min<int64_t>(j * w / ow, w - 1)];
  }
}

// Intersection and union per class bin 1..nclass after a +1 shift of both
// maps; predictions on unlabelled pixels (target < 0) are dropped. inter
// and uni hold nclass zeros on entry.
void hist_iou_i64(const int64_t* pred, const int64_t* target, int64_t n,
                  int64_t nclass, int64_t* inter, int64_t* uni) {
  std::vector<int64_t> area_pred(nclass, 0), area_lab(nclass, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t t = target[i] + 1;
    const int64_t p = t <= 0 ? 0 : pred[i] + 1;
    if (p >= 1 && p <= nclass) {
      area_pred[p - 1]++;
      if (p == t) inter[p - 1]++;
    }
    if (t >= 1 && t <= nclass) area_lab[t - 1]++;
  }
  for (int64_t c = 0; c < nclass; ++c) uni[c] = area_pred[c] + area_lab[c] - inter[c];
}

// out2 = {correct, labelled} pixel counts over target >= 0.
void pix_acc_i64(const int64_t* pred, const int64_t* target, int64_t n, int64_t* out2) {
  int64_t correct = 0, labelled = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (target[i] + 1 > 0) {
      labelled++;
      correct += pred[i] == target[i];
    }
  }
  out2[0] = correct;
  out2[1] = labelled;
}

// Separable 3x3 gaussian blur of one [h, w] map, reflect padding (clamped,
// so a map one pixel wide stays in bounds).
void gaussian_blur3_f32(const float* src, int64_t h, int64_t w, float sigma, float* dst) {
  const float k1 = 1.0f;
  const float k0 = std::exp(-1.0f / (2.0f * sigma * sigma));
  const float norm = k0 + k1 + k0;
  std::vector<float> tmp(h * w);
  for (int64_t i = 0; i < h; ++i) {
    const float* row = src + i * w;
    float* out = tmp.data() + i * w;
    for (int64_t j = 0; j < w; ++j) {
      const int64_t jl = j == 0 ? (w > 1 ? 1 : 0) : j - 1;
      const int64_t jr = j == w - 1 ? (w > 1 ? w - 2 : 0) : j + 1;
      out[j] = (k0 * row[jl] + k1 * row[j] + k0 * row[jr]) / norm;
    }
  }
  for (int64_t i = 0; i < h; ++i) {
    const int64_t iu = i == 0 ? (h > 1 ? 1 : 0) : i - 1;
    const int64_t id = i == h - 1 ? (h > 1 ? h - 2 : 0) : i + 1;
    for (int64_t j = 0; j < w; ++j) {
      dst[i * w + j] = (k0 * tmp[iu * w + j] + k1 * tmp[i * w + j] + k0 * tmp[id * w + j]) / norm;
    }
  }
}

}  // extern "C"
