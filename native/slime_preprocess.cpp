// SliME-JAX native host preprocessing: anyres slice + resize + CLIP normalize.
//
// Replaces the reference's per-sample PIL pipeline (llava/mm_utils.py:177-210 +
// HF CLIPImageProcessor), which is the CPU hot path inside DataLoader workers
// (SURVEY.md §3.1). One call takes a raw HWC uint8 image and emits the full
// fixed-shape crop stack [max_crops, 3, tile, tile] float32 (CLIP-normalized,
// CHW) plus the crop mask — ready for device upload with zero Python-side image
// work.
//
// Resize: separable bicubic with PIL's exact coefficient scheme (Keys a=-0.5,
// filter support scaled by the downscale ratio = antialiasing, normalized taps)
// so outputs match the PIL reference path closely.
//
// Build: g++ -O3 -shared -fPIC (see Makefile). Exposed via ctypes — no pybind11.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

struct Taps {
  // PIL-style variable-support taps: per output pixel, [bound_lo, bound_hi) with
  // normalized weights stored contiguously.
  std::vector<int> lo;
  std::vector<int> n;
  std::vector<float> w;
  int max_n = 0;
};

float cubic(float d, float a = -0.5f) {
  d = std::fabs(d);
  if (d <= 1.f) return ((a + 2.f) * d - (a + 3.f)) * d * d + 1.f;
  if (d < 2.f) return (((d - 5.f) * d + 8.f) * d - 4.f) * a;
  return 0.f;
}

// PIL ImagingResampleHorizontal coefficient computation: the filter support is
// scaled by the downscale ratio (antialiasing), weights normalized to sum 1.
Taps make_taps(int src, int dst) {
  Taps t;
  const double scale = static_cast<double>(src) / dst;
  const double fscale = std::max(scale, 1.0);
  const double support = 2.0 * fscale;   // bicubic support = 2
  t.lo.resize(dst);
  t.n.resize(dst);
  t.max_n = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.w.assign(static_cast<size_t>(dst) * t.max_n, 0.f);
  for (int i = 0; i < dst; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > src) xmax = src;
    int n = xmax - xmin;
    double total = 0.0;
    float* wrow = &t.w[static_cast<size_t>(i) * t.max_n];
    for (int j = 0; j < n; ++j) {
      double wv = cubic(static_cast<float>((xmin + j - center + 0.5) / fscale));
      wrow[j] = static_cast<float>(wv);
      total += wv;
    }
    if (total != 0.0) {
      for (int j = 0; j < n; ++j) wrow[j] = static_cast<float>(wrow[j] / total);
    }
    t.lo[i] = xmin;
    t.n[i] = n;
  }
  return t;
}

// HWC uint8 -> separable PIL-style bicubic resize to (dh, dw).
// Output is HWC float in [0, 255].
void resize_bicubic(const uint8_t* src, int sh, int sw, float* dst, int dh,
                    int dw) {
  Taps ytaps = make_taps(sh, dh);
  Taps xtaps = make_taps(sw, dw);

  // vertical pass into tmp [dh, sw, 3]
  std::vector<float> tmp(static_cast<size_t>(dh) * sw * 3);
  for (int y = 0; y < dh; ++y) {
    const float* wy = &ytaps.w[static_cast<size_t>(y) * ytaps.max_n];
    int ylo = ytaps.lo[y];
    int yn = ytaps.n[y];
    for (int x = 0; x < sw; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < yn; ++k) {
        const uint8_t* p = src + (static_cast<size_t>(ylo + k) * sw + x) * 3;
        float w = wy[k];
        acc[0] += w * p[0];
        acc[1] += w * p[1];
        acc[2] += w * p[2];
      }
      float* o = &tmp[(static_cast<size_t>(y) * sw + x) * 3];
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }
  // horizontal pass into dst [dh, dw, 3]
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      const float* wx = &xtaps.w[static_cast<size_t>(x) * xtaps.max_n];
      int xlo = xtaps.lo[x];
      int xn = xtaps.n[x];
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < xn; ++k) {
        const float* p = &tmp[(static_cast<size_t>(y) * sw + xlo + k) * 3];
        acc[0] += wx[k] * p[0];
        acc[1] += wx[k] * p[1];
        acc[2] += wx[k] * p[2];
      }
      float* o = &dst[(static_cast<size_t>(y) * dw + x) * 3];
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }
}

// Write an HWC float region into CHW normalized output tile.
void normalize_into(const float* hwc, int h, int w, float* chw_out, int tile,
                    int oy, int ox) {
  for (int c = 0; c < 3; ++c) {
    float* plane = chw_out + static_cast<size_t>(c) * tile * tile;
    for (int y = 0; y < h; ++y) {
      const float* row = hwc + (static_cast<size_t>(y) * w) * 3 + c;
      float* orow = plane + static_cast<size_t>(oy + y) * tile + ox;
      for (int x = 0; x < w; ++x) {
        float v = row[static_cast<size_t>(x) * 3] * (1.f / 255.f);
        v = std::min(std::max(v, 0.f), 1.f);
        orow[x] = (v - kMean[c]) / kStd[c];
      }
    }
  }
}

// Write an HWC float [0,255] region into a CHW uint8 tile (round-to-nearest,
// PIL's own quantization of resize output). Normalization then happens ON
// DEVICE (slime.encode_images uint8 path) — the crop batch ships host->device
// at 1/4 the float32 bytes, which is what the transfer can't hide behind the
// running train step on tunnel/DCN-attached hosts.
void quantize_into(const float* hwc, int h, int w, uint8_t* chw_out, int tile,
                   int oy, int ox) {
  for (int c = 0; c < 3; ++c) {
    uint8_t* plane = chw_out + static_cast<size_t>(c) * tile * tile;
    for (int y = 0; y < h; ++y) {
      const float* row = hwc + (static_cast<size_t>(y) * w) * 3 + c;
      uint8_t* orow = plane + static_cast<size_t>(oy + y) * tile + ox;
      for (int x = 0; x < w; ++x) {
        float v = row[static_cast<size_t>(x) * 3];
        v = std::min(std::max(v, 0.f), 255.f);
        orow[x] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// --- anyres grid selection (mirrors slime_jax/data/anyres.py) -------------------

void candidate_grids(int scale, std::vector<std::pair<int, int>>& out) {
  int lo = scale <= 2 ? scale : scale - 1;
  int hi = scale + 1;
  for (int n = lo; n <= hi; ++n) {
    if (scale <= 2 && n == scale - 1) continue;
    for (int i = 1; i <= n; ++i) {
      if (n % i == 0) out.emplace_back(i, n / i);
    }
  }
}

void select_best_uhd(int ow, int oh, int tile, int* bw, int* bh) {
  long long area = static_cast<long long>(ow) * oh;
  int scale = static_cast<int>(std::ceil(static_cast<double>(area) / (tile * tile)));
  if (scale > 6) scale = 6;
  if (scale == 1) scale = 2;
  std::vector<std::pair<int, int>> cands;
  candidate_grids(scale, cands);
  long long max_eff = 0;
  double min_waste = 1e30;
  int best_w = tile, best_h = tile;
  for (auto& [cols, rows] : cands) {
    long long w = static_cast<long long>(cols) * tile;
    long long h = static_cast<long long>(rows) * tile;
    double s = std::min(static_cast<double>(w) / ow, static_cast<double>(h) / oh);
    long long dw = static_cast<long long>(ow * s);
    long long dh = static_cast<long long>(oh * s);
    long long eff = std::min(dw * dh, area);
    double waste = static_cast<double>(w * h - eff);
    if (eff > max_eff || (eff == max_eff && waste < min_waste)) {
      max_eff = eff;
      min_waste = waste;
      best_w = static_cast<int>(w);
      best_h = static_cast<int>(h);
    }
  }
  *bw = best_w;
  *bh = best_h;
}

// Shared anyres pipeline: emits either normalized float32 crops (out_f32) or
// raw uint8 crops for on-device normalization (out_u8). Exactly one of the
// out pointers is non-null.
int anyres_core(const uint8_t* img, int h, int w, int tile, int max_crops,
                float* out_f32, uint8_t* out_u8, uint8_t* mask,
                int* grid_cols, int* grid_rows) {
  int bw = 0, bh = 0;
  select_best_uhd(w, h, tile, &bw, &bh);
  int cols = bw / tile, rows = bh / tile;
  if (1 + cols * rows > max_crops) return -1;

  size_t crop_sz = static_cast<size_t>(3) * tile * tile;
  if (out_f32) std::memset(out_f32, 0, sizeof(float) * crop_sz * max_crops);
  if (out_u8) std::memset(out_u8, 0, crop_sz * max_crops);
  std::memset(mask, 0, max_crops);

  // Global view: square resize to tile x tile.
  std::vector<float> g(crop_sz);
  resize_bicubic(img, h, w, g.data(), tile, tile);
  if (out_f32) normalize_into(g.data(), tile, tile, out_f32, tile, 0, 0);
  else quantize_into(g.data(), tile, tile, out_u8, tile, 0, 0);
  mask[0] = 1;

  // Fit-resize into the best-resolution canvas (aspect preserved, centered).
  double sw = static_cast<double>(bw) / w, sh = static_cast<double>(bh) / h;
  int nw, nh;
  if (sw < sh) {
    nw = bw;
    nh = std::min(static_cast<int>(std::ceil(h * sw)), bh);
  } else {
    nh = bh;
    nw = std::min(static_cast<int>(std::ceil(w * sh)), bw);
  }
  int px = (bw - nw) / 2, py = (bh - nh) / 2;

  std::vector<float> canvas(static_cast<size_t>(bh) * bw * 3, 0.f);
  std::vector<float> resized(static_cast<size_t>(nh) * nw * 3);
  resize_bicubic(img, h, w, resized.data(), nh, nw);
  for (int y = 0; y < nh; ++y) {
    std::memcpy(&canvas[((static_cast<size_t>(py + y) * bw) + px) * 3],
                &resized[static_cast<size_t>(y) * nw * 3],
                sizeof(float) * nw * 3);
  }
  // Tile the canvas row-major into local crops.
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < cols; ++c) {
      int k = 1 + r * cols + c;
      std::vector<float> tilebuf(static_cast<size_t>(tile) * tile * 3);
      for (int y = 0; y < tile; ++y) {
        std::memcpy(&tilebuf[static_cast<size_t>(y) * tile * 3],
                    &canvas[((static_cast<size_t>(r * tile + y) * bw) + c * tile) * 3],
                    sizeof(float) * tile * 3);
      }
      // tilebuf holds [0,255]-scale floats
      if (out_f32)
        normalize_into(tilebuf.data(), tile, tile, out_f32 + crop_sz * k,
                       tile, 0, 0);
      else
        quantize_into(tilebuf.data(), tile, tile, out_u8 + crop_sz * k,
                      tile, 0, 0);
      mask[k] = 1;
    }
  }
  *grid_cols = cols;
  *grid_rows = rows;
  return 1 + cols * rows;
}

}  // namespace

extern "C" {

// img: HWC uint8 [h, w, 3]. out: [max_crops, 3, tile, tile] float32 (zeroed by
// callee). mask: [max_crops] uint8. Returns number of valid crops (1 + cols*rows)
// or -1 if the grid exceeds max_crops.
int slime_anyres_preprocess(const uint8_t* img, int h, int w, int tile,
                            int max_crops, float* out, uint8_t* mask,
                            int* grid_cols, int* grid_rows) {
  return anyres_core(img, h, w, tile, max_crops, out, nullptr, mask,
                     grid_cols, grid_rows);
}

// uint8-output variant: crops stay [0,255] uint8 (PIL's own rounding of the
// resize output) and CLIP normalization happens on device — 1/4 the
// host->device bytes of the float32 stack.
int slime_anyres_preprocess_u8(const uint8_t* img, int h, int w, int tile,
                               int max_crops, uint8_t* out, uint8_t* mask,
                               int* grid_cols, int* grid_rows) {
  return anyres_core(img, h, w, tile, max_crops, nullptr, out, mask,
                     grid_cols, grid_rows);
}

// Plain resize+normalize (pad mode / video frames): one tile out.
void slime_square_preprocess(const uint8_t* img, int h, int w, int tile,
                             float* out) {
  std::vector<float> g(static_cast<size_t>(3) * tile * tile);
  resize_bicubic(img, h, w, g.data(), tile, tile);
  normalize_into(g.data(), tile, tile, out, tile, 0, 0);
}

}  // extern "C"
