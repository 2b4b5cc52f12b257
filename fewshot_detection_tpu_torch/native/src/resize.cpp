// PIL's default resize, bit for bit: what `Image.resize((w, h))` gives an
// RGB image when no filter is named (BICUBIC). This is the JAX package's
// `utils/imaging.py:load_image_resized`, which decodes with PIL and resizes
// this way; the port reaches it under FSD_NATIVE=1 without PIL. The
// datasets' triangle filter (imagepipe.cpp) is a different function and
// stays as it is.
//
// Pillow's separable resample (libImaging/Resample.c), step by step:
//   - the filter is the bicubic convolution kernel with a = -0.5, support 2;
//   - scale = in / out, filterscale = max(scale, 1), support *= filterscale;
//   - output pixel x takes the taps from
//       xmin = max(int(center - support + 0.5), 0)
//     up to min(int(center + support + 0.5), in), center = (x + 0.5) * scale,
//     tap i weighing filter((i + xmin - center + 0.5) * (1 / filterscale)) in
//     double, the weights divided by their sum;
//   - each weight is made fixed point with 22 fraction bits, rounded half
//     away from zero; a sum starts at 1 << 21 and the result is sum >> 22,
//     clipped to 0..255;
//   - the horizontal pass runs first, on uint8, and the vertical pass on its
//     uint8 output; a pass runs only when its dimension changes, and an
//     unchanged size returns the image as it is.
// The arithmetic is double and int32 as in Pillow's C; the library's flags
// (native/loader.py) allow no fused multiply-add, as Pillow's generic x86-64
// build has none.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr double kSupport = 2.0;

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// The taps of one axis: for each output index its first input index, its
// number of taps and `ksize` fixed-point weights.
struct Taps {
  int ksize = 0;
  std::vector<int> first, count;
  std::vector<int32_t> weights;
};

Taps precompute(int in_size, int out_size) {
  Taps t;
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = kSupport * filterscale;
  t.ksize = int(std::ceil(support)) * 2 + 1;
  t.first.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(size_t(out_size) * t.ksize, 0);
  std::vector<double> k(t.ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = bicubic((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    int32_t* kk = &t.weights[size_t(xx) * t.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double w = ww != 0.0 ? k[x] / ww : k[x];
      kk[x] = w < 0 ? int32_t(-0.5 + w * (1 << kPrecisionBits))
                    : int32_t(0.5 + w * (1 << kPrecisionBits));
    }
    t.first[xx] = xmin;
    t.count[xx] = xmax;
  }
  return t;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return uint8_t(in >> kPrecisionBits);
}

// (h, w_in, 3) -> (h, w_out, 3)
std::vector<uint8_t> horizontal(const uint8_t* in, int w_in, int h, int w_out) {
  const Taps t = precompute(w_in, w_out);
  std::vector<uint8_t> out(size_t(w_out) * h * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + size_t(y) * w_in * 3;
    uint8_t* dst = &out[size_t(y) * w_out * 3];
    for (int xx = 0; xx < w_out; ++xx) {
      const int32_t* k = &t.weights[size_t(xx) * t.ksize];
      const uint8_t* src = row + size_t(t.first[xx]) * 3;
      int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
      for (int x = 0; x < t.count[xx]; ++x) {
        s0 += src[x * 3 + 0] * k[x];
        s1 += src[x * 3 + 1] * k[x];
        s2 += src[x * 3 + 2] * k[x];
      }
      dst[xx * 3 + 0] = clip8(s0);
      dst[xx * 3 + 1] = clip8(s1);
      dst[xx * 3 + 2] = clip8(s2);
    }
  }
  return out;
}

// (h_in, w, 3) -> (h_out, w, 3)
std::vector<uint8_t> vertical(const uint8_t* in, int w, int h_in, int h_out) {
  const Taps t = precompute(h_in, h_out);
  const size_t stride = size_t(w) * 3;
  std::vector<uint8_t> out(stride * h_out);
  for (int yy = 0; yy < h_out; ++yy) {
    const int32_t* k = &t.weights[size_t(yy) * t.ksize];
    const uint8_t* src = in + size_t(t.first[yy]) * stride;
    uint8_t* dst = &out[size_t(yy) * stride];
    for (size_t c = 0; c < stride; ++c) {
      int32_t s = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < t.count[yy]; ++y) s += src[size_t(y) * stride + c] * k[y];
      dst[c] = clip8(s);
    }
  }
  return out;
}

}  // namespace

extern "C" {

int fsd_image_size(const char* path, int* w, int* h);
int fsd_decode(const char* path, uint8_t* out, int max_bytes, int* w, int* h);

// (h, w, 3) uint8 -> (out_h, out_w, 3) uint8 as PIL's Image.resize default.
int fsd_resize_pil(const uint8_t* rgb, int w, int h, int out_w, int out_h, uint8_t* out) {
  if (w <= 0 || h <= 0 || out_w <= 0 || out_h <= 0) return -1;
  std::vector<uint8_t> tmp;
  const uint8_t* cur = rgb;
  int cur_w = w;
  if (out_w != w) {
    tmp = horizontal(cur, w, h, out_w);
    cur = tmp.data();
    cur_w = out_w;
  }
  if (out_h != h) {
    std::vector<uint8_t> v = vertical(cur, cur_w, h, out_h);
    std::memcpy(out, v.data(), v.size());
  } else {
    std::memcpy(out, cur, size_t(cur_w) * h * 3);
  }
  return 0;
}

// Decode `path` with the port's decoders to RGB (what PIL's convert("RGB")
// gives: a palette looked up, alpha dropped, gray replicated) and resize it
// as fsd_resize_pil does.
int fsd_load_resized_pil(const char* path, int out_w, int out_h, uint8_t* out) {
  int w = 0, h = 0;
  if (fsd_image_size(path, &w, &h) != 0) return -1;
  std::vector<uint8_t> rgb(size_t(w) * h * 3);
  if (fsd_decode(path, rgb.data(), int(rgb.size()), &w, &h) != 0) return -1;
  return fsd_resize_pil(rgb.data(), w, h, out_w, out_h, out);
}

}  // extern "C"
