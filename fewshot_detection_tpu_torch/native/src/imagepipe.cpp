// Native image-loading pipeline of fewshot_detection_tpu_torch: host C++,
// no device code. Everything after the decoders is the JAX package's
// native/src/imagepipe.cpp, byte for byte, so the two libraries, built with
// the same compiler and flags, give the same bytes for the same pixels. The
// decoders differ: the JAX package's library calls libjpeg and libpng, this
// one calls the port's own (pngdec.cpp on zlib, jpegdec.cpp), which give
// the same pixels and need no system image library.
//
// It implements JPEG/PNG decode, crop-jitter, filtered resize, horizontal
// flip, PIL-point-table HSV distortion, binary mask synthesis, and a
// pthread batch assembler, exported with a plain C ABI for ctypes.
//
// Augmentation semantics follow data/augment.py (itself matching the
// original image.py): the crop uses the (swidth-1) quirk, hue shifts wrap
// once, and saturation/exposure are 256-entry uint8 lookup tables identical
// to PIL Image.point. Resize is a PIL-style separable triangle (bilinear)
// filter; interpolation may differ from PIL's default bicubic by a few uint8
// counts, so the native path is an opt-in fast path, not the bit-parity
// path with PIL.
//
// Build: see native/loader.py (g++ -O3 -shared, at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "decoders.h"

namespace {

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
};

// ---------------------------------------------------------------- decode

enum class Format { kUnknown, kJpeg, kPng };

constexpr uint8_t kPngSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

Format sniff_format(const std::vector<uint8_t>& d) {
  if (d.size() >= 2 && d[0] == 0xFF && d[1] == 0xD8) return Format::kJpeg;
  if (d.size() >= 8 && !std::memcmp(d.data(), kPngSignature, 8)) return Format::kPng;
  return Format::kUnknown;
}

bool read_file(const char* path, std::vector<uint8_t>* d, std::string* err) {
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    *err = "cannot open the file";
    return false;
  }
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof buf, fp)) > 0) d->insert(d->end(), buf, buf + n);
  bool ok = !ferror(fp);
  fclose(fp);
  if (!ok) *err = "read error";
  return ok;
}

bool decode_file(const char* path, ImageU8* out, std::string* err) {
  std::vector<uint8_t> d;
  if (!read_file(path, &d, err)) return false;
  fsd::Rgb8 img;
  bool ok;
  switch (sniff_format(d)) {
    case Format::kJpeg: ok = fsd::jpeg_decode(d.data(), d.size(), &img, err); break;
    case Format::kPng: ok = fsd::png_decode(d.data(), d.size(), &img, err); break;
    default: *err = "neither a JPEG nor a PNG file"; return false;
  }
  if (!ok) return false;
  out->w = img.w;
  out->h = img.h;
  out->rgb = std::move(img.rgb);
  return true;
}

bool decode_file(const char* path, ImageU8* out) {
  std::string err;
  return decode_file(path, out, &err);
}

// Header-only dimension probe: no pixel decode. The file is read in
// growing pieces until its header gives the size (libjpeg and libpng stop
// at SOF and IHDR too); the size parsers read forward only, so a failure
// on a piece that is not the whole file is retried on a longer one, and
// the answer is the whole file's.
bool probe_size(const char* path, int* w, int* h, std::string* err) {
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    *err = "cannot open the file";
    return false;
  }
  std::vector<uint8_t> d;
  bool ok = false;
  for (size_t want = size_t(1) << 14;; want *= 4) {
    const size_t have = d.size();
    d.resize(want);
    d.resize(have + fread(d.data() + have, 1, want - have, fp));
    if (ferror(fp)) {
      *err = "read error";
      break;
    }
    const Format format = sniff_format(d);
    if (format == Format::kJpeg) ok = fsd::jpeg_size(d.data(), d.size(), w, h, err);
    if (format == Format::kPng) ok = fsd::png_size(d.data(), d.size(), w, h, err);
    if (format == Format::kUnknown) *err = "neither a JPEG nor a PNG file";
    if (ok || format == Format::kUnknown || d.size() < want) break;  // or the file ended
  }
  fclose(fp);
  return ok;
}

bool probe_size(const char* path, int* w, int* h) {
  std::string err;
  return probe_size(path, w, h, &err);
}

void copy_reason(const std::string& why, char* msg, int cap) {
  if (cap <= 0) return;
  size_t n = std::min(why.size(), size_t(cap - 1));
  std::memcpy(msg, why.data(), n);
  msg[n] = 0;
}

}  // namespace

extern "C" {

// Why `path` does not decode (or, with size_only, why its size cannot be
// read): 0 and an empty `msg` when it does.
int fsd_decode_error(const char* path, int size_only, char* msg, int cap) {
  std::string err;
  bool ok;
  if (size_only) {
    int w, h;
    ok = probe_size(path, &w, &h, &err);
  } else {
    ImageU8 img;
    ok = decode_file(path, &img, &err);
  }
  copy_reason(ok ? std::string() : err, msg, cap);
  return ok ? 0 : -1;
}

}  // extern "C"

namespace {

// ----------------------------------------------------------- crop / flip

// Crop with virtual zero padding outside the source (PIL crop semantics).
ImageU8 crop(const ImageU8& src, int left, int top, int right, int bottom) {
  ImageU8 out;
  out.w = std::max(right - left, 0);
  out.h = std::max(bottom - top, 0);
  out.rgb.assign(size_t(out.w) * out.h * 3, 0);
  int y0 = std::max(top, 0), y1 = std::min(bottom, src.h);
  int x0 = std::max(left, 0), x1 = std::min(right, src.w);
  for (int y = y0; y < y1; ++y) {
    const uint8_t* srow = src.rgb.data() + (size_t(y) * src.w + x0) * 3;
    uint8_t* drow = out.rgb.data() + (size_t(y - top) * out.w + (x0 - left)) * 3;
    std::memcpy(drow, srow, size_t(x1 - x0) * 3);
  }
  return out;
}

void flip_horizontal(ImageU8* img) {
  for (int y = 0; y < img->h; ++y) {
    uint8_t* row = img->rgb.data() + size_t(y) * img->w * 3;
    for (int x = 0; x < img->w / 2; ++x) {
      for (int c = 0; c < 3; ++c)
        std::swap(row[x * 3 + c], row[(img->w - 1 - x) * 3 + c]);
    }
  }
}

// ------------------------------------------------------------------ resize

// PIL-style separable filtered resize with the triangle (bilinear) kernel:
// for downscale the kernel widens to cover the source footprint, giving
// area-style averaging rather than naive sampling.
struct FilterTaps {
  std::vector<int> bounds;      // (xmin, size) per output pixel
  std::vector<float> coeffs;    // ksize per output pixel
  int ksize = 0;
};

FilterTaps make_taps(int in_size, int out_size) {
  FilterTaps t;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle support = 1
  t.ksize = int(std::ceil(support)) * 2 + 1;
  t.bounds.resize(size_t(out_size) * 2);
  t.coeffs.assign(size_t(out_size) * t.ksize, 0.0f);
  std::vector<double> k(t.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(int(center - support + 0.5), 0);
    int xmax = std::min(int(center + support + 0.5), in_size);
    double ww = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double arg = std::abs((x + 0.5 - center) / filterscale);
      double w = arg < 1.0 ? 1.0 - arg : 0.0;
      k[x - xmin] = w;
      ww += w;
    }
    float* kf = &t.coeffs[size_t(xx) * t.ksize];
    for (int x = 0; x < xmax - xmin; ++x)
      kf[x] = float(ww != 0.0 ? k[x] / ww : k[x]);
    t.bounds[xx * 2] = xmin;
    t.bounds[xx * 2 + 1] = xmax - xmin;
  }
  return t;
}

ImageU8 resize_bilinear(const ImageU8& src, int ow, int oh) {
  if (src.w == ow && src.h == oh) return src;
  FilterTaps hx = make_taps(std::max(src.w, 1), ow);
  FilterTaps vy = make_taps(std::max(src.h, 1), oh);

  // horizontal pass into float (accumulators are float: the triangle
  // kernel has <= ~2*scale+1 taps of values <= 255, well inside float's
  // 24-bit mantissa; only exact-.5 rounding ties could shift by one count,
  // and the native path is documented tolerance-parity, not bit-parity)
  std::vector<float> tmp(size_t(src.h) * ow * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* srow = src.rgb.data() + size_t(y) * src.w * 3;
    float* drow = tmp.data() + size_t(y) * ow * 3;
    for (int xx = 0; xx < ow; ++xx) {
      int xmin = hx.bounds[xx * 2], sz = hx.bounds[xx * 2 + 1];
      const float* k = &hx.coeffs[size_t(xx) * hx.ksize];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < sz; ++i) {
        const uint8_t* p = srow + size_t(xmin + i) * 3;
        acc0 += k[i] * p[0];
        acc1 += k[i] * p[1];
        acc2 += k[i] * p[2];
      }
      drow[xx * 3] = acc0;
      drow[xx * 3 + 1] = acc1;
      drow[xx * 3 + 2] = acc2;
    }
  }
  // vertical pass with rounding back to uint8
  ImageU8 out;
  out.w = ow;
  out.h = oh;
  out.rgb.resize(size_t(ow) * oh * 3);
  std::vector<float> vacc(size_t(ow) * 3);
  for (int yy = 0; yy < oh; ++yy) {
    int ymin = vy.bounds[yy * 2], sz = vy.bounds[yy * 2 + 1];
    const float* k = &vy.coeffs[size_t(yy) * vy.ksize];
    uint8_t* drow = out.rgb.data() + size_t(yy) * ow * 3;
    // row-major accumulation: stream each tmp row once (stride-1,
    // vectorizable) instead of striding down the column per output pixel
    std::fill(vacc.begin(), vacc.end(), 0.0f);
    for (int i = 0; i < sz; ++i) {
      const float* trow = tmp.data() + size_t(ymin + i) * ow * 3;
      float kv = k[i];
      for (int xx = 0; xx < ow * 3; ++xx) vacc[xx] += kv * trow[xx];
    }
    for (int xx = 0; xx < ow * 3; ++xx)
      drow[xx] = uint8_t(std::clamp(int(std::lround(vacc[xx])), 0, 255));
  }
  return out;
}

// ----------------------------------------------------------- HSV distort

// PIL Image.point semantics on an L band: the lambda is evaluated on
// 0..255 and the (float) results are cast to uint8 via C truncation after
// clamping into [0, 255].
inline uint8_t lut_clamp(double v) {
  if (v < 0) v = 0;
  if (v > 255) v = 255;
  return uint8_t(v);
}

void rgb2hsv_u8(uint8_t r, uint8_t g, uint8_t b, uint8_t* h, uint8_t* s,
                uint8_t* v) {
  // PIL's convert("HSV") math (libImaging ImagingConvert rgb2hsv). float
  // arithmetic: exact quotients are >= 1/(6*255) away from uint8 rounding
  // boundaries, far outside float's error at this scale, so results match
  // the double version (native path is tolerance-parity with PIL anyway).
  uint8_t maxc = std::max({r, g, b});
  uint8_t minc = std::min({r, g, b});
  *v = maxc;
  if (minc == maxc) {
    *h = 0;
    *s = 0;
    return;
  }
  float delta = float(maxc - minc);
  float inv_delta = 1.0f / delta;
  *s = uint8_t(255.0f * delta / maxc);
  float hh;
  if (r == maxc)
    hh = (float(g) - b) * inv_delta;
  else if (g == maxc)
    hh = 2.0f + (float(b) - r) * inv_delta;
  else
    hh = 4.0f + (float(r) - g) * inv_delta;
  hh = hh * (1.0f / 6.0f);
  if (hh < 0) hh += 1.0f;
  *h = uint8_t(hh * 255.0f);
}

void hsv2rgb_u8(uint8_t h, uint8_t s, uint8_t v, uint8_t* r, uint8_t* g,
                uint8_t* b) {
  if (s == 0) {
    *r = *g = *b = v;
    return;
  }
  float hh = float(h) * (6.0f / 255.0f);
  int i = int(hh) % 6;
  float f = hh - int(hh);
  float sf = float(s) * (1.0f / 255.0f);
  uint8_t p = uint8_t(v * (1.0f - sf));
  uint8_t q = uint8_t(v * (1.0f - sf * f));
  uint8_t t = uint8_t(v * (1.0f - sf * (1.0f - f)));
  switch (i) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
}

void distort_hsv(ImageU8* img, float dhue, float dsat, float dexp) {
  uint8_t sat_lut[256], val_lut[256], hue_lut[256];
  double dh = double(dhue) * 255.0;
  for (int i = 0; i < 256; ++i) {
    sat_lut[i] = lut_clamp(i * double(dsat));
    val_lut[i] = lut_clamp(i * double(dexp));
    double x = i + dh;  // single wraparound, like the reference change_hue
    if (x > 255) x -= 255;
    if (x < 0) x += 255;
    hue_lut[i] = lut_clamp(x);
  }
  size_t n = size_t(img->w) * img->h;
  for (size_t i = 0; i < n; ++i) {
    uint8_t* p = img->rgb.data() + i * 3;
    uint8_t h, s, v;
    rgb2hsv_u8(p[0], p[1], p[2], &h, &s, &v);
    hsv2rgb_u8(hue_lut[h], sat_lut[s], val_lut[v], p, p + 1, p + 2);
  }
}

void to_float(const ImageU8& img, float* out) {
  size_t n = size_t(img.w) * img.h * 3;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < n; ++i) out[i] = img.rgb[i] * inv;
}

// Shared augment tail: crop-jitter + resize + flip + HSV on an already
// decoded image (the decode may come from disk or a caller-held RAM cache).
void process_image(const ImageU8& img, int out_w, int out_h, int pleft,
                   int pright, int ptop, int pbot, int flip, float dhue,
                   float dsat, float dexp, int augment, float* out) {
  if (augment) {
    int swidth = img.w - pleft - pright;
    int sheight = img.h - ptop - pbot;
    // (swidth-1) crop quirk preserved from the reference pipeline
    ImageU8 c = crop(img, pleft, ptop, pleft + swidth - 1, ptop + sheight - 1);
    ImageU8 r = resize_bilinear(c, out_w, out_h);
    if (flip) flip_horizontal(&r);
    distort_hsv(&r, dhue, dsat, dexp);
    to_float(r, out);
  } else {
    ImageU8 r = resize_bilinear(img, out_w, out_h);
    to_float(r, out);
  }
}

int load_one(const char* path, int out_w, int out_h, int pleft, int pright,
             int ptop, int pbot, int flip, float dhue, float dsat, float dexp,
             int augment, float* out) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  process_image(img, out_w, out_h, pleft, pright, ptop, pbot, flip, dhue,
                dsat, dexp, augment, out);
  return 0;
}

// Borrow a caller-owned HWC uint8 RGB buffer as an ImageU8 (copies — the
// crop/resize passes want an owned vector; ~0.05 ms at 256px, negligible
// next to the decode this path skips).
ImageU8 borrow_rgb(const uint8_t* rgb, int w, int h) {
  ImageU8 img;
  img.w = w;
  img.h = h;
  img.rgb.assign(rgb, rgb + size_t(w) * h * 3);
  return img;
}

}  // namespace

extern "C" {

int fsd_image_size(const char* path, int* w, int* h) {
  return probe_size(path, w, h) ? 0 : -1;
}

int fsd_decode(const char* path, uint8_t* out, int max_bytes, int* w, int* h) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  if (int(img.rgb.size()) > max_bytes) return -2;
  std::memcpy(out, img.rgb.data(), img.rgb.size());
  *w = img.w;
  *h = img.h;
  return 0;
}

// One augmented image -> float32 HWC [0,1] buffer of out_h*out_w*3.
int fsd_load_augment(const char* path, int out_w, int out_h, int pleft,
                     int pright, int ptop, int pbot, int flip, float dhue,
                     float dsat, float dexp, float* out) {
  return load_one(path, out_w, out_h, pleft, pright, ptop, pbot, flip, dhue,
                  dsat, dexp, 1, out);
}

int fsd_load_plain(const char* path, int out_w, int out_h, float* out) {
  return load_one(path, out_w, out_h, 0, 0, 0, 0, 0, 0, 0, 0, 0, out);
}

// Threaded batch assembly. paths: n C strings; params: n*8 floats laid out
// [pleft,pright,ptop,pbot,flip,dhue,dsat,dexp]; out: (n, out_h, out_w, 3).
// augment=0 ignores params. Returns the number of failed images.
int fsd_load_batch(const char** paths, int n, int out_w, int out_h,
                   const float* params, int augment, float* out,
                   int n_threads) {
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min(n_threads, n);
  std::vector<int> fails(n_threads, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      float* dst = out + size_t(i) * out_w * out_h * 3;
      int rc;
      if (augment) {
        const float* p = params + size_t(i) * 8;
        rc = load_one(paths[i], out_w, out_h, int(p[0]), int(p[1]), int(p[2]),
                      int(p[3]), int(p[4]), p[5], p[6], p[7], 1, dst);
      } else {
        rc = load_one(paths[i], out_w, out_h, 0, 0, 0, 0, 0, 0, 0, 0, 0, dst);
      }
      if (rc != 0) {
        std::memset(dst, 0, size_t(out_w) * out_h * 3 * sizeof(float));
        fails[tid]++;
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

// Augment tail on an already decoded HWC uint8 RGB buffer (the caller's
// decoded-image RAM cache): crop/resize/flip/HSV only, no disk IO.
int fsd_augment_raw(const uint8_t* rgb, int w, int h, int out_w, int out_h,
                    int pleft, int pright, int ptop, int pbot, int flip,
                    float dhue, float dsat, float dexp, int augment,
                    float* out) {
  if (w <= 0 || h <= 0) return -1;
  ImageU8 img = borrow_rgb(rgb, w, h);
  process_image(img, out_w, out_h, pleft, pright, ptop, pbot, flip, dhue,
                dsat, dexp, augment, out);
  return 0;
}

// Threaded batch over decoded buffers. bufs: n HWC uint8 pointers; whs:
// n*2 ints [w,h]; params/augment/out as fsd_load_batch. Returns failures.
int fsd_load_batch_raw(const uint8_t** bufs, const int* whs, int n,
                       int out_w, int out_h, const float* params, int augment,
                       float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min(n_threads, n);
  std::vector<int> fails(n_threads, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      float* dst = out + size_t(i) * out_w * out_h * 3;
      const float* p = params + size_t(i) * 8;
      int rc;
      if (augment) {
        rc = fsd_augment_raw(bufs[i], whs[i * 2], whs[i * 2 + 1], out_w,
                             out_h, int(p[0]), int(p[1]), int(p[2]),
                             int(p[3]), int(p[4]), p[5], p[6], p[7], 1, dst);
      } else {
        rc = fsd_augment_raw(bufs[i], whs[i * 2], whs[i * 2 + 1], out_w,
                             out_h, 0, 0, 0, 0, 0, 0, 0, 0, 0, dst);
      }
      if (rc != 0) {
        std::memset(dst, 0, size_t(out_w) * out_h * 3 * sizeof(float));
        fails[tid]++;
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

}  // extern "C"
