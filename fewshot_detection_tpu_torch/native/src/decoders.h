// The port's own image decoders: PNG on zlib's inflate and 8-bit JPEG
// (sequential and progressive, Huffman and arithmetic coding). They need no
// system image library, only zlib, and give what the JAX package's native
// library gets from libpng (expand, strip_16, strip_alpha, gray_to_rgb) and
// from libjpeg-turbo's default decode to RGB (ISLOW IDCT as its x86 SIMD
// code computes it, block smoothing, fancy upsampling).
//
// Every function is reentrant: all state lives in the caller's objects, so
// the batch assembler may decode on many threads at once.

#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace fsd {

// Decoded RGB, HWC, 3 bytes a pixel.
struct Rgb8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;
};

// Each returns false and sets *err to the reason when the data cannot be
// decoded (or, for JPEG, uses a coding this decoder does not implement).
bool png_decode(const uint8_t* data, size_t n, Rgb8* out, std::string* err);
bool png_size(const uint8_t* data, size_t n, int* w, int* h, std::string* err);
bool jpeg_decode(const uint8_t* data, size_t n, Rgb8* out, std::string* err);
// The header's dimensions, read as libjpeg's jpeg_read_header reads them:
// a lossless or 12-bit file has none, a CMYK file has a size although it is
// not decoded.
bool jpeg_size(const uint8_t* data, size_t n, int* w, int* h, std::string* err);

}  // namespace fsd
