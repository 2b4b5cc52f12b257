// JPEG decoder of the port's native image pipeline: 8-bit sequential
// (SOF0, SOF1) and progressive (SOF2) Huffman coding, sequential (SOF9) and
// progressive (SOF10) arithmetic coding, interleaved or not, any sampling
// factors up to 4, restart intervals.
//
// Its output is bit-equal to libjpeg-turbo's default decode to RGB, which is
// what the JAX package's native library gets (jpeg_read_header, then
// out_color_space = JCS_RGB, on a stdio source, on an x86-64 CPU):
// - the integer "islow" IDCT as libjpeg-turbo's x86 SIMD code computes it
//   (jsimd_idct_islow_avx2, and its SSE2 twin): 16-bit lanes where
//   jidctint.c's C code keeps ints, so the dequantising product keeps its
//   low 16 bits, a few sums wrap at 16 bits, pass 1 packs to int16 with
//   saturation and the output saturates to [0, 255]. On coefficients an
//   encoder writes this equals the C code; on others (crafted or corrupt
//   data) the C code's range-limit table wraps where this saturates;
// - progressive files: jdphuff.c's and jdarith.c's scans into a whole-image
//   coefficient buffer, then jdcoefct.c's block smoothing (libjpeg-turbo
//   2.1's 5x5 window) where the coefficients are incomplete at output;
// - arithmetic decoding per ITU-T T.81 Annex D and F.2.4/G.1.3 (jdarith.c):
//   the Qe table, DAC conditioning, statistics reset at each scan and
//   restart, zeros fed once a marker is met, and a bad code leaving the
//   rest of the scan (up to the next restart) at zero;
// - fancy upsampling (jdsample.c): h2v1 and h2v2 with their alternating
//   biases, h1v2, box upsampling where libjpeg uses it (other integral
//   ratios, or a downsampled width <= 2), the image's first and last rows
//   replicated as context;
// - jdcolor.c's YCbCr->RGB tables (SCALEBITS 16); gray replicated; a
//   three-component image taken as RGB under an Adobe transform of 0 or
//   component IDs 'R','G','B' (with no JFIF marker), as
//   default_decompress_parms decides.
// The input is read as libjpeg reads a stdio source: past the end of the
// file come fake EOI markers, the entropy decoder then reads zero bits and
// leaves the rest of the scan at zero coefficients, restart markers are
// resynchronised as jpeg_resync_to_restart does, and a missing Huffman
// table 0 or 1 is the standard one (libjpeg-turbo's Motion-JPEG rule). It
// fails where libjpeg's error_exit would, and goes on where libjpeg only
// warns (an inconsistent progression, a bad Huffman or arithmetic code).
//
// It refuses, with the reason, what libjpeg-turbo's default build also
// fails on: lossless and hierarchical JPEG, precision other than 8 bits, and
// four-component (CMYK/YCCK) images, which libjpeg cannot convert to RGB.
// jpeg_size still reads the dimensions of a file that jpeg_read_header
// accepts.

#include <algorithm>
#include <cstring>
#include <exception>

#include "decoders.h"

namespace fsd {
namespace {

constexpr int kMaxComps = 10, kMaxInScan = 4, kMaxBlocksInMcu = 10;
constexpr int kMaxDim = 65500;

// jpeg_natural_order with 16 extra entries: a corrupt run past 63 lands
// on 63, as in libjpeg.
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of the JPEG spec's Annex K (jstdhuff.c).
constexpr uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// T.81 Table D.2, packed as jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the fixed
// probability 0.5 (T.851) of the sign and refinement bits.
constexpr uint32_t qe(uint32_t q, uint32_t lps, uint32_t mps, uint32_t sw) {
  return q << 16 | mps << 8 | sw << 7 | lps;
}
constexpr uint32_t kAritab[114] = {
    qe(0x5a1d, 1, 1, 1),     qe(0x2586, 14, 2, 0),    qe(0x1114, 16, 3, 0),
    qe(0x080b, 18, 4, 0),    qe(0x03d8, 20, 5, 0),    qe(0x01da, 23, 6, 0),
    qe(0x00e5, 25, 7, 0),    qe(0x006f, 28, 8, 0),    qe(0x0036, 30, 9, 0),
    qe(0x001a, 33, 10, 0),   qe(0x000d, 35, 11, 0),   qe(0x0006, 9, 12, 0),
    qe(0x0003, 10, 13, 0),   qe(0x0001, 12, 13, 0),   qe(0x5a7f, 15, 15, 1),
    qe(0x3f25, 36, 16, 0),   qe(0x2cf2, 38, 17, 0),   qe(0x207c, 39, 18, 0),
    qe(0x17b9, 40, 19, 0),   qe(0x1182, 42, 20, 0),   qe(0x0cef, 43, 21, 0),
    qe(0x09a1, 45, 22, 0),   qe(0x072f, 46, 23, 0),   qe(0x055c, 48, 24, 0),
    qe(0x0406, 49, 25, 0),   qe(0x0303, 51, 26, 0),   qe(0x0240, 52, 27, 0),
    qe(0x01b1, 54, 28, 0),   qe(0x0144, 56, 29, 0),   qe(0x00f5, 57, 30, 0),
    qe(0x00b7, 59, 31, 0),   qe(0x008a, 60, 32, 0),   qe(0x0068, 62, 33, 0),
    qe(0x004e, 63, 34, 0),   qe(0x003b, 32, 35, 0),   qe(0x002c, 33, 9, 0),
    qe(0x5ae1, 37, 37, 1),   qe(0x484c, 64, 38, 0),   qe(0x3a0d, 65, 39, 0),
    qe(0x2ef1, 67, 40, 0),   qe(0x261f, 68, 41, 0),   qe(0x1f33, 69, 42, 0),
    qe(0x19a8, 70, 43, 0),   qe(0x1518, 72, 44, 0),   qe(0x1177, 73, 45, 0),
    qe(0x0e74, 74, 46, 0),   qe(0x0bfb, 75, 47, 0),   qe(0x09f8, 77, 48, 0),
    qe(0x0861, 78, 49, 0),   qe(0x0706, 79, 50, 0),   qe(0x05cd, 48, 51, 0),
    qe(0x04de, 50, 52, 0),   qe(0x040f, 50, 53, 0),   qe(0x0363, 51, 54, 0),
    qe(0x02d4, 52, 55, 0),   qe(0x025c, 53, 56, 0),   qe(0x01f8, 54, 57, 0),
    qe(0x01a4, 55, 58, 0),   qe(0x0160, 56, 59, 0),   qe(0x0125, 57, 60, 0),
    qe(0x00f6, 58, 61, 0),   qe(0x00cb, 59, 62, 0),   qe(0x00ab, 61, 63, 0),
    qe(0x008f, 61, 32, 0),   qe(0x5b12, 65, 65, 1),   qe(0x4d04, 80, 66, 0),
    qe(0x412c, 81, 67, 0),   qe(0x37d8, 82, 68, 0),   qe(0x2fe8, 83, 69, 0),
    qe(0x293c, 84, 70, 0),   qe(0x2379, 86, 71, 0),   qe(0x1edf, 87, 72, 0),
    qe(0x1aa9, 87, 73, 0),   qe(0x174e, 72, 74, 0),   qe(0x1424, 72, 75, 0),
    qe(0x119c, 74, 76, 0),   qe(0x0f6b, 74, 77, 0),   qe(0x0d51, 75, 78, 0),
    qe(0x0bb6, 77, 79, 0),   qe(0x0a40, 77, 48, 0),   qe(0x5832, 80, 81, 1),
    qe(0x4d1c, 88, 82, 0),   qe(0x438e, 89, 83, 0),   qe(0x3bdd, 90, 84, 0),
    qe(0x34ee, 91, 85, 0),   qe(0x2eae, 92, 86, 0),   qe(0x299a, 93, 87, 0),
    qe(0x2516, 86, 71, 0),   qe(0x5570, 88, 89, 1),   qe(0x4ca9, 95, 90, 0),
    qe(0x44d9, 96, 91, 0),   qe(0x3e22, 97, 92, 0),   qe(0x3824, 99, 93, 0),
    qe(0x32b4, 99, 94, 0),   qe(0x2e17, 93, 86, 0),   qe(0x56a8, 95, 96, 1),
    qe(0x4f46, 101, 97, 0),  qe(0x47e5, 102, 98, 0),  qe(0x41cf, 103, 99, 0),
    qe(0x3c3d, 104, 100, 0), qe(0x375e, 99, 93, 0),   qe(0x5231, 105, 102, 0),
    qe(0x4c0f, 106, 103, 0), qe(0x4639, 107, 104, 0), qe(0x415e, 103, 99, 0),
    qe(0x5627, 105, 106, 1), qe(0x50e7, 108, 107, 0), qe(0x4b85, 109, 103, 0),
    qe(0x5597, 110, 109, 0), qe(0x504f, 111, 107, 0), qe(0x5a10, 110, 111, 1),
    qe(0x5522, 112, 109, 0), qe(0x59eb, 112, 111, 1), qe(0x5a1d, 113, 113, 0)};

enum : int {
  M_SOF0 = 0xc0, M_SOF1 = 0xc1, M_SOF2 = 0xc2, M_SOF3 = 0xc3, M_DHT = 0xc4,
  M_SOF5 = 0xc5, M_SOF6 = 0xc6, M_SOF7 = 0xc7, M_JPG = 0xc8, M_SOF9 = 0xc9,
  M_SOF10 = 0xca, M_SOF11 = 0xcb, M_DAC = 0xcc, M_SOF13 = 0xcd, M_SOF14 = 0xce,
  M_SOF15 = 0xcf, M_RST0 = 0xd0, M_RST7 = 0xd7, M_SOI = 0xd8, M_EOI = 0xd9,
  M_SOS = 0xda, M_DQT = 0xdb, M_DNL = 0xdc, M_DRI = 0xdd, M_APP0 = 0xe0,
  M_APP14 = 0xee, M_APP15 = 0xef, M_COM = 0xfe, M_TEM = 0x01,
};

// Thrown for libjpeg's ERREXIT; caught at the API boundary.
struct Error {
  std::string why;
};
[[noreturn]] void die(const std::string& why) { throw Error{why}; }

// The stdio source: the file's bytes, then fake EOI markers for ever.
struct Source {
  const uint8_t* d;
  size_t n, pos = 0;
  int fake = 0;
  int byte() {
    if (pos < n) return d[pos++];
    if (pos == 0) die("empty input file");
    return (fake++ & 1) ? M_EOI : 0xff;
  }
  int two() {
    int a = byte();
    return (a << 8) | byte();
  }
};

struct Huff {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  const uint8_t* vals;
  int lookup[256];  // nb << 8 | symbol, nb = 9 when no code of <= 8 bits
};

void derive(const Huff& h, bool dc, Derived* t) {
  char size[257];
  unsigned code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = h.bits[l];
    if (p + i > 256) die("bogus Huffman table definition");
    while (i--) size[p++] = char(l);
  }
  size[p] = 0;
  int nsym = p;
  unsigned c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) die("bogus Huffman table definition");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (h.bits[l]) {
      t->valoffset[l] = p - int32_t(code[p]);
      p += h.bits[l];
      t->maxcode[l] = int32_t(code[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  t->vals = h.vals;
  for (int i = 0; i < 256; ++i) t->lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= h.bits[l]; ++i, ++p) {
      int look = int(code[p]) << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr) t->lookup[look++] = (l << 8) | h.vals[p];
    }
  }
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (h.vals[i] > 15) die("bogus Huffman table definition");
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int bw = 0, bh = 0;  // the coefficient plane, in blocks
  int dw = 0, dh = 0;  // downsampled size, in samples
  bool latched = false;
  uint16_t quant[64] = {0};
  std::vector<int16_t> coef;  // bw*bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride);

struct Decoder {
  Source src;
  int unread_marker = 0;
  bool saw_soi = false, saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int precision = 8, width = 0, height = 0, ncomp = 0;
  Component comp[kMaxComps];
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huff dc_huff[4], ac_huff[4];
  int restart_interval = 0;
  int next_restart_num = 0;
  // the current scan
  int comps_in_scan = 0;
  int scan_comp[kMaxInScan];
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int max_h = 1, max_v = 1;
  bool multiple_scans = false;
  bool progressive = false, arith = false;
  int input_scan_number = 0;
  // The progression status (jdphuff.c's coef_bits: the Al of each
  // coefficient's last scan, -1 before any) and its state before each
  // component's latest scan, which block smoothing reads.
  int coef_bits[kMaxComps][64], prev_coef_bits[kMaxComps][64];
  // jdcoefct.c: the last iMCU row completed with data left in the scan
  int total_imcu_rows = 0, last_good_imcu_row = 0;
  // DAC conditioning per table (jdmarker.c's defaults at SOI)
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  // bit reader (libjpeg's bitread_working_state)
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;
  int eobrun = 0;
  // arithmetic decoder (jdarith.c's C, A and CT registers and statistics)
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = 113;
  int dc_context[kMaxInScan];

  // ---------------------------------------------------------- markers
  void first_marker() {
    int c = src.byte(), c2 = src.byte();
    if (c != 0xff || c2 != M_SOI) die("not a JPEG file");
    unread_marker = c2;
  }

  void next_marker() {
    int c;
    for (;;) {
      c = src.byte();
      while (c != 0xff) c = src.byte();
      do {
        c = src.byte();
      } while (c == 0xff);
      if (c != 0) break;
    }
    unread_marker = c;
  }

  void skip_variable() {
    long length = src.two() - 2;
    while (length-- > 0) src.byte();
  }

  void get_soi() {
    if (saw_soi) die("invalid JPEG file structure: two SOI markers");
    restart_interval = 0;
    saw_jfif = saw_adobe = false;
    std::fill(arith_dc_L, arith_dc_L + 16, 0);
    std::fill(arith_dc_U, arith_dc_U + 16, 1);
    std::fill(arith_ac_K, arith_ac_K + 16, 5);
    saw_soi = true;
  }

  void get_sof(int code) {
    long length = src.two();
    precision = src.byte();
    height = src.two();
    width = src.two();
    ncomp = src.byte();
    length -= 8;
    if (saw_sof) die("invalid JPEG file structure: two SOF markers");
    if (height <= 0 || width <= 0 || ncomp <= 0) die("empty JPEG image (DNL not supported)");
    if (length != ncomp * 3) die("bogus marker length");
    if (ncomp > kMaxComps) die("too many color components");
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      c.id = src.byte();
      int s = src.byte();
      c.h = (s >> 4) & 15;
      c.v = s & 15;
      c.tq = src.byte();
    }
    progressive = code == M_SOF2 || code == M_SOF10;
    arith = code == M_SOF9 || code == M_SOF10;
    saw_sof = true;
  }

  void get_sos() {
    if (!saw_sof) die("invalid JPEG file structure: SOS before SOF");
    long length = src.two();
    int n = src.byte();
    if (length != n * 2 + 6 || n < 1 || n > kMaxInScan) die("bogus marker length");
    comps_in_scan = n;
    for (int i = 0; i < n; ++i) {
      int cc = src.byte(), c = src.byte();
      for (int k = 0; k < i; ++k) {  // duplicate IDs: libjpeg's fake ID
        if (cc == comp[scan_comp[k]].id) {
          cc = comp[scan_comp[0]].id;
          for (int m = 1; m < i; ++m) cc = std::max(cc, comp[scan_comp[m]].id);
          ++cc;
          break;
        }
      }
      int ci = 0;
      while (ci < ncomp && comp[ci].id != cc) ++ci;
      if (ci == ncomp) die("invalid component ID in SOS");
      scan_comp[i] = ci;
      comp[ci].dc_tbl = (c >> 4) & 15;
      comp[ci].ac_tbl = c & 15;
    }
    Ss = src.byte();
    Se = src.byte();
    int c = src.byte();
    Ah = (c >> 4) & 15;
    Al = c & 15;
    next_restart_num = 0;
    ++input_scan_number;
  }

  void get_dac() {
    long length = src.two() - 2;
    while (length > 0) {
      int index = src.byte(), val = src.byte();
      length -= 2;
      if (index < 0 || index >= 32) die("bogus DAC index");
      if (index >= 16) {
        arith_ac_K[index - 16] = uint8_t(val);
      } else {
        arith_dc_L[index] = uint8_t(val & 15);
        arith_dc_U[index] = uint8_t(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) die("bogus DAC value");
      }
    }
    if (length != 0) die("bogus marker length");
  }

  void get_dht() {
    long length = src.two() - 2;
    while (length > 16) {
      int index = src.byte();
      Huff h;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        h.bits[i] = uint8_t(src.byte());
        count += h.bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length) die("bogus Huffman table definition");
      for (int i = 0; i < count; ++i) h.vals[i] = uint8_t(src.byte());
      length -= count;
      h.present = true;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) die("bogus DHT index");
        ac_huff[index] = h;
      } else {
        if (index < 0 || index >= 4) die("bogus DHT index");
        dc_huff[index] = h;
      }
    }
    if (length != 0) die("bogus marker length");
  }

  void get_dqt() {
    long length = src.two() - 2;
    while (length > 0) {
      length--;
      int n = src.byte();
      int prec = n >> 4;
      n &= 15;
      if (n >= 4) die("bogus DQT index");
      for (int i = 0; i < 64; ++i) qt[n][kNatural[i]] = uint16_t(prec ? src.two() : src.byte());
      qt_present[n] = true;
      length -= 64;
      if (prec) length -= 64;
    }
    if (length != 0) die("bogus marker length");
  }

  void get_dri() {
    if (src.two() != 4) die("bogus marker length");
    restart_interval = src.two();
  }

  void get_app(int marker) {
    long length = src.two() - 2;
    uint8_t b[14];
    int datalen = 0;
    int want = marker == M_APP0 ? 14 : 12;
    if (length >= want) datalen = want;
    else if (length > 0) datalen = int(length);
    for (int i = 0; i < datalen; ++i) b[i] = uint8_t(src.byte());
    length -= datalen;
    if (marker == M_APP0) {
      if (datalen >= 14 && !std::memcmp(b, "JFIF", 5)) saw_jfif = true;
    } else if (datalen >= 12 && !std::memcmp(b, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    while (length-- > 0) src.byte();
  }

  // libjpeg's read_markers: true at SOS, false at EOI.
  bool read_markers() {
    for (;;) {
      if (unread_marker == 0) {
        if (!saw_soi) first_marker();
        else next_marker();
      }
      int m = unread_marker;
      switch (m) {
        case M_SOI: get_soi(); break;
        case M_SOF0: case M_SOF1: case M_SOF2: case M_SOF9: case M_SOF10: get_sof(m); break;
        case M_SOF3: case M_SOF5: case M_SOF6: case M_SOF7: case M_JPG: case M_SOF11:
        case M_SOF13: case M_SOF14: case M_SOF15:
          die(m == M_SOF3 || m == M_SOF11 ? "lossless JPEG is not supported"
                                          : "hierarchical JPEG is not supported");
        case M_SOS: get_sos(); unread_marker = 0; return true;
        case M_EOI: unread_marker = 0; return false;
        case M_DAC: get_dac(); break;
        case M_DHT: get_dht(); break;
        case M_DQT: get_dqt(); break;
        case M_DRI: get_dri(); break;
        case M_APP0: case M_APP14: get_app(m); break;
        case M_COM: skip_variable(); break;
        case M_DNL: skip_variable(); break;
        case M_TEM: break;
        default:
          if (m >= M_RST0 && m <= M_RST7) break;
          if (m > M_APP0 && m <= M_APP15) {
            skip_variable();
            break;
          }
          die("unsupported marker type");
      }
      unread_marker = 0;
    }
  }

  // jdinput.c's initial_setup, at the first SOS.
  void initial_setup() {
    if (height > kMaxDim || width > kMaxDim) die("image too big");
    if (precision != 8) die("unsupported JPEG data precision " + std::to_string(precision));
    max_h = max_v = 1;
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) die("bogus sampling factors");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      c.width_in_blocks = int((long(width) * c.h + max_h * 8 - 1) / (max_h * 8));
      c.height_in_blocks = int((long(height) * c.v + max_v * 8 - 1) / (max_v * 8));
      c.dw = int((long(width) * c.h + max_h - 1) / max_h);
      c.dh = int((long(height) * c.v + max_v - 1) / max_v);
    }
    multiple_scans = comps_in_scan < ncomp || progressive;
    total_imcu_rows = (height + max_v * 8 - 1) / (max_v * 8);
    for (int ci = 0; ci < ncomp; ++ci) {
      std::fill(coef_bits[ci], coef_bits[ci] + 64, -1);
      std::fill(prev_coef_bits[ci], prev_coef_bits[ci] + 64, 0);
    }
  }

  // What libjpeg cannot decode to RGB either.
  void refuse_unsupported() {
    if (ncomp == 4) die("CMYK/YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3) die("unsupported color conversion");
  }

  // ------------------------------------------------------- bit reading
  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bits_left < 57) {
        int c = src.byte();
        if (c == 0xff) {
          do {
            c = src.byte();
          } while (c == 0xff);
          if (c == 0) {
            c = 0xff;
          } else {
            unread_marker = c;
            break;
          }
        }
        get_buffer = (get_buffer << 8) | uint64_t(c);
        bits_left += 8;
      }
      if (unread_marker == 0) return;
    }
    if (nbits > bits_left) {
      insufficient = true;
      get_buffer <<= 57 - bits_left;
      bits_left = 57;
    }
  }

  int get_bits(int n) {
    if (bits_left < n) fill(n);
    bits_left -= n;
    return int((get_buffer >> bits_left) & ((1u << n) - 1));
  }

  int huff_decode(const Derived& t) {
    int l;
    if (bits_left < 8) {
      fill(0);
      if (bits_left < 8) {
        l = 1;
        goto slow;
      }
    }
    {
      int look = int((get_buffer >> (bits_left - 8)) & 0xff);
      int nb = t.lookup[look] >> 8;
      if (nb <= 8) {
        bits_left -= nb;
        return t.lookup[look] & 0xff;
      }
      l = nb;
    }
  slow:
    int32_t code = get_bits(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      ++l;
    }
    if (l > 16) return 0;  // a bad code reads as 0, as in libjpeg
    return t.vals[(code + t.valoffset[l]) & 0xff];
  }

  static int extend(int r, int s) {
    return s == 0 ? 0 : (r < (1 << (s - 1)) ? r - (1 << s) + 1 : r);
  }

  // jdmarker.c's read_restart_marker with jpeg_resync_to_restart.
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    if (unread_marker == M_RST0 + next_restart_num) {
      unread_marker = 0;
    } else {
      int desired = next_restart_num;
      for (;;) {
        int marker = unread_marker, action;
        if (marker < M_SOF0) {
          action = 2;
        } else if (marker < M_RST0 || marker > M_RST7) {
          action = 3;
        } else if (marker == M_RST0 + ((desired + 1) & 7) ||
                   marker == M_RST0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (marker == M_RST0 + ((desired - 1) & 7) ||
                   marker == M_RST0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          unread_marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }

  // ------------------------------------------------------------- scans
  // jdphuff.c's and jdarith.c's start_pass: bad scan parameters are fatal;
  // an inconsistent progression is only warned about, and decoded.
  void start_progressive_scan() {
    bool bad = false;
    if (Ss == 0) {
      if (Se != 0) bad = true;
    } else {
      if (Ss > Se || Se >= 64) bad = true;
      if (comps_in_scan != 1) bad = true;
    }
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad)
      die("invalid progressive parameters Ss=" + std::to_string(Ss) + " Se=" +
          std::to_string(Se) + " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al));
    for (int i = 0; i < comps_in_scan; ++i) {
      int* bits = coef_bits[scan_comp[i]];
      int* prev = prev_coef_bits[scan_comp[i]];
      for (int k = std::min(Ss, 1); k <= std::max(Se, 9); ++k)
        prev[k] = input_scan_number > 1 ? bits[k] : 0;
      for (int k = Ss; k <= Se; ++k) bits[k] = Al;
    }
  }

  // ----------------------------------------------- Huffman, sequential
  void decode_mcu_huff(int16_t* const* blk, const int* blk_ci, int nblk, const Derived* dct,
                       const Derived* act, int* last_dc) {
    for (int b = 0; b < nblk; ++b) {
      const Component& c = comp[blk_ci[b]];
      int s = huff_decode(dct[c.dc_tbl]);
      if (s) s = extend(get_bits(s), s);
      s = int(unsigned(s) + unsigned(last_dc[blk_ci[b]]));
      last_dc[blk_ci[b]] = s;
      blk[b][0] = int16_t(s);
      const Derived& at = act[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        s = huff_decode(at);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          s = extend(get_bits(s), s);
          blk[b][kNatural[k]] = int16_t(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  // ---------------------------------------------- Huffman, progressive
  void decode_dc_first_huff(int16_t* const* blk, const int* blk_ci, int nblk,
                            const Derived* dct, int* last_dc) {
    for (int b = 0; b < nblk; ++b) {
      int s = huff_decode(dct[comp[blk_ci[b]].dc_tbl]);
      if (s) s = extend(get_bits(s), s);
      s = int(unsigned(s) + unsigned(last_dc[blk_ci[b]]));
      last_dc[blk_ci[b]] = s;
      blk[b][0] = int16_t(unsigned(s) << Al);
    }
  }

  void decode_dc_refine_huff(int16_t* const* blk, int nblk) {
    for (int b = 0; b < nblk; ++b)
      if (get_bits(1)) blk[b][0] = int16_t(blk[b][0] | (1 << Al));
  }

  void decode_ac_first_huff(int16_t* blk, const Derived& t) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int s = huff_decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(get_bits(s), s);
        blk[kNatural[k]] = int16_t(unsigned(s) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine_huff(int16_t* blk, const Derived& t) {
    const int p1 = 1 << Al, m1 = int(~0u << Al);
    auto correct = [&](int16_t* coef) {
      if (get_bits(1) && (*coef & p1) == 0) *coef = int16_t(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int s = huff_decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // a size other than 1 is only warned about
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k)
        if (blk[kNatural[k]] != 0) correct(blk + kNatural[k]);
      --eobrun;
    }
  }

  // --------------------------------------------------------- arithmetic
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        int data = 0;
        if (unread_marker == 0) {
          data = src.byte();
          if (data == 0xff) {
            do {
              data = src.byte();
            } while (data == 0xff);
            if (data == 0) {
              data = 0xff;
            } else {  // a marker: zeros from here on, as T.81 asks
              unread_marker = data;
              data = 0;
            }
          }
        }
        ar_c = (ar_c << 8) | data;
        if ((ar_ct += 8) < 0)
          if (++ar_ct == 0) ar_a = 0x8000;  // the two initial bytes are in
      }
      ar_a <<= 1;
    }
    int sv = *st;
    int64_t q = kAritab[sv & 0x7f];
    const int nl = int(q & 0xff), nm = int((q >> 8) & 0xff);
    q >>= 16;
    int64_t temp = ar_a - q;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < q) {
        ar_a = q;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        ar_a = q;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < q) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void reset_arith_stats() {
    for (int i = 0; i < comps_in_scan; ++i) {
      const Component& c = comp[scan_comp[i]];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c.dc_tbl], 0, 64);
        dc_context[i] = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c.ac_tbl], 0, 256);
    }
    ar_c = ar_a = 0;
    ar_ct = -16;
  }

  // F.2.4.1: one DC difference added to the prediction; false on a
  // magnitude overflow (a bad code).
  bool arith_dc(int tbl, int i, int* last_dc) {
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    if (arith_decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    if (m < int((1L << arith_dc_L[tbl]) >> 1)) dc_context[i] = 0;
    else if (m > int((1L << arith_dc_U[tbl]) >> 1)) dc_context[i] = 12 + sign * 4;
    else dc_context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    *last_dc = (*last_dc + v) & 0xffff;
    return true;
  }

  // F.2.4.2: the AC coefficients Ss..Se of one block, each passed to put;
  // false on a spectral or magnitude overflow.
  template <class Put>
  bool arith_ac(int tbl, int ss, int se, Put put) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      int sign = arith_decode(&fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m && arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      put(k, v);
    }
    return true;
  }

  // One MCU of an arithmetic-coded scan. A bad code sets CT to -1, which
  // leaves the rest of the scan, up to the next restart, at zero.
  void decode_mcu_arith(int16_t* const* blk, const int* blk_slot, int nblk, int* last_dc) {
    if (progressive && Ss == 0 && Ah != 0) {  // DC refinement: no error state
      for (int b = 0; b < nblk; ++b)
        if (arith_decode(&fixed_bin)) blk[b][0] = int16_t(blk[b][0] | (1 << Al));
      return;
    }
    if (ar_ct == -1) return;
    if (progressive && Ss == 0) {
      for (int b = 0; b < nblk; ++b) {
        int i = blk_slot[b];
        if (!arith_dc(comp[scan_comp[i]].dc_tbl, i, &last_dc[i])) {
          ar_ct = -1;
          return;
        }
        blk[b][0] = int16_t(unsigned(last_dc[i]) << Al);
      }
    } else if (progressive && Ah == 0) {
      int16_t* o = blk[0];
      const int al = Al;
      if (!arith_ac(comp[scan_comp[0]].ac_tbl, Ss, Se,
                    [&](int k, int v) { o[kNatural[k]] = int16_t(unsigned(v) << al); }))
        ar_ct = -1;
    } else if (progressive) {
      if (!arith_ac_refine(blk[0], comp[scan_comp[0]].ac_tbl)) ar_ct = -1;
    } else {
      for (int b = 0; b < nblk; ++b) {
        int i = blk_slot[b];
        const Component& c = comp[scan_comp[i]];
        if (!arith_dc(c.dc_tbl, i, &last_dc[i])) {
          ar_ct = -1;
          return;
        }
        int16_t* o = blk[b];
        o[0] = int16_t(last_dc[i]);
        if (!arith_ac(c.ac_tbl, 1, 63, [&](int k, int v) { o[kNatural[k]] = int16_t(v); })) {
          ar_ct = -1;
          return;
        }
      }
    }
  }

  // G.1.3.3: correction bits of the nonzero coefficients, and new ones.
  bool arith_ac_refine(int16_t* blk, int tbl) {
    const int p1 = 1 << Al, m1 = int(~0u << Al);
    int kex = Se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = int16_t(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = int16_t(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) return false;
      }
    }
    return true;
  }

  void decode_scan() {
    for (int i = 0; i < comps_in_scan; ++i) {
      Component& c = comp[scan_comp[i]];
      if (!c.latched) {  // jdinput.c's latch_quant_tables
        if (c.tq < 0 || c.tq >= 4 || !qt_present[c.tq]) die("quantization table not defined");
        std::memcpy(c.quant, qt[c.tq], sizeof c.quant);
        c.latched = true;
      }
    }
    if (progressive) start_progressive_scan();
    Derived dct[4], act[4];
    if (!arith) {  // the tables this scan reads (jdhuff.c, jdphuff.c)
      const bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      const bool need_ac = !progressive || Ss != 0;
      for (int i = 0; i < comps_in_scan; ++i) {
        Component& c = comp[scan_comp[i]];
        if (need_dc) {
          if (c.dc_tbl >= 4 || !dc_huff[c.dc_tbl].present) die("Huffman table not defined");
          derive(dc_huff[c.dc_tbl], true, &dct[c.dc_tbl]);
        }
        if (need_ac) {
          if (c.ac_tbl >= 4 || !ac_huff[c.ac_tbl].present) die("Huffman table not defined");
          derive(ac_huff[c.ac_tbl], false, &act[c.ac_tbl]);
        }
      }
    }
    // the MCU geometry (jdinput.c's per_scan_setup)
    int mcus_per_row, mcu_rows, nblk = 0, mcu_rows_per_imcu = 1;
    int blk_slot[kMaxBlocksInMcu], blk_dx[kMaxBlocksInMcu], blk_dy[kMaxBlocksInMcu];
    if (comps_in_scan == 1) {
      Component& c = comp[scan_comp[0]];
      mcus_per_row = c.width_in_blocks;
      mcu_rows = c.height_in_blocks;
      mcu_rows_per_imcu = c.v;
      blk_slot[0] = 0;
      blk_dx[0] = blk_dy[0] = 0;
      nblk = 1;
    } else {
      mcus_per_row = (width + max_h * 8 - 1) / (max_h * 8);
      mcu_rows = (height + max_v * 8 - 1) / (max_v * 8);
      for (int i = 0; i < comps_in_scan; ++i) {
        Component& c = comp[scan_comp[i]];
        if (nblk + c.h * c.v > kMaxBlocksInMcu) die("sampling factors too large for interleaved scan");
        for (int y = 0; y < c.v; ++y)
          for (int x = 0; x < c.h; ++x) {
            blk_slot[nblk] = i;
            blk_dx[nblk] = x;
            blk_dy[nblk] = y;
            ++nblk;
          }
      }
    }
    int blk_ci[kMaxBlocksInMcu];
    for (int b = 0; b < nblk; ++b) blk_ci[b] = scan_comp[blk_slot[b]];
    int last_dc[kMaxComps] = {0};  // by component (Huffman) or scan slot (arithmetic)
    get_buffer = 0;
    bits_left = 0;
    insufficient = false;
    eobrun = 0;
    if (arith) reset_arith_stats();
    int restarts_to_go = restart_interval;
    int16_t* blk[kMaxBlocksInMcu];
    for (int my = 0; my < mcu_rows; ++my) {
      // jdcoefct.c's consume_data, as an iMCU row starts
      if (my % mcu_rows_per_imcu == 0 && !insufficient) last_good_imcu_row = my / mcu_rows_per_imcu;
      for (int mx = 0; mx < mcus_per_row; ++mx) {
        if (restart_interval && restarts_to_go == 0) {
          if (arith) {
            read_restart_marker();
            reset_arith_stats();
          } else {
            bits_left = 0;
            read_restart_marker();
            if (unread_marker == 0) insufficient = false;
          }
          std::fill(last_dc, last_dc + kMaxComps, 0);
          eobrun = 0;
          restarts_to_go = restart_interval;
        }
        for (int b = 0; b < nblk; ++b) {
          Component& c = comp[blk_ci[b]];
          int bx = comps_in_scan == 1 ? mx : mx * c.h + blk_dx[b];
          int by = comps_in_scan == 1 ? my : my * c.v + blk_dy[b];
          blk[b] = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
        }
        if (arith) {
          decode_mcu_arith(blk, blk_slot, nblk, last_dc);
        } else if (!insufficient) {
          if (!progressive) decode_mcu_huff(blk, blk_ci, nblk, dct, act, last_dc);
          else if (Ss == 0 && Ah == 0) decode_dc_first_huff(blk, blk_ci, nblk, dct, last_dc);
          else if (Ss == 0) decode_dc_refine_huff(blk, nblk);
          else if (Ah == 0) decode_ac_first_huff(blk[0], act[comp[scan_comp[0]].ac_tbl]);
          else decode_ac_refine_huff(blk[0], act[comp[scan_comp[0]].ac_tbl]);
        }
        if (restart_interval) --restarts_to_go;
      }
    }
  }

  // ------------------------------------------------------ reconstruction
  void allocate() {
    int mcus_per_row = (width + max_h * 8 - 1) / (max_h * 8);
    int mcu_rows = (height + max_v * 8 - 1) / (max_v * 8);
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      c.bw = std::max(mcus_per_row * c.h, c.width_in_blocks);
      c.bh = std::max(mcu_rows * c.v, c.height_in_blocks);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
  }

  // jdcoefct.c's smoothing_ok (libjpeg-turbo 2.1): block smoothing runs on a
  // progressive image whose coefficients 1..9 are not all final, when every
  // component has its DC and nonzero quantisers at the positions it reads.
  // Latches the progression status now and before each component's last
  // scan (-1 where the file has a single scan).
  bool smoothing_ok(int (*now)[10], int (*before)[10]) {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < ncomp; ++ci) {
      const Component& c = comp[ci];
      if (!c.latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.quant[pos] == 0) return false;
      if (coef_bits[ci][0] < 0) return false;
      now[ci][0] = coef_bits[ci][0];
      for (int k = 1; k < 10; ++k) {
        before[ci][k] = input_scan_number > 1 ? prev_coef_bits[ci][k] : -1;
        now[ci][k] = coef_bits[ci][k];
        if (coef_bits[ci][k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data: each block's still-zero
  // coefficients 1..9 estimated from the DC values of a 5x5 window of
  // blocks (a Gaussian-like kernel that also replaces the DC when no AC
  // coefficient was sent), then the IDCT. An iMCU row past the last one the
  // final scan completed uses the status from before that scan. The window's
  // edges follow libjpeg's row and column registers exactly.
  void idct_smoothed(int ci, const int* now, const int* before) {
    Component& c = comp[ci];
    const int v = c.v, last = total_imcu_rows - 1, lastcol = c.width_in_blocks - 1;
    const size_t pw = size_t(c.bw) * 8;
    const uint16_t* q = c.quant;
    const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2],
                  Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    auto block = [&](int by, int bx) { return c.coef.data() + (size_t(by) * c.bw + bx) * 64; };
    for (int oy = 0; oy <= last; ++oy) {
      int block_rows = v;
      if (oy == last && c.height_in_blocks % v) block_rows = c.height_in_blocks % v;
      const int* bits = oy > last_good_imcu_row ? before : now;
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      for (int br = 0; br < block_rows; ++br) {
        const int by = oy * v + br;
        const int prev = br > 0 || oy > 0 ? by - 1 : by;
        const int pprev = br > 1 || oy > 1 ? by - 2 : prev;
        const int next = br < block_rows - 1 || oy < last ? by + 1 : by;
        const int nnext = br < block_rows - 2 || oy + 1 < last ? by + 2 : next;
        const int16_t* rows[5] = {block(pprev, 0), block(prev, 0), block(by, 0), block(next, 0),
                                  block(nnext, 0)};
        int dc[26];  // dc[1..25]: DC01..DC25, five rows of five columns
        for (int r = 0; r < 5; ++r)
          for (int x = 1; x <= 5; ++x) dc[r * 5 + x] = rows[r][0];
        for (int bx = 0; bx <= lastcol; ++bx) {
          int16_t ws[64];
          std::memcpy(ws, block(by, bx), sizeof ws);
          if (bx == 0 && bx < lastcol)
            for (int r = 0; r < 5; ++r) dc[r * 5 + 4] = rows[r][64];
          if (bx + 1 < lastcol)
            for (int r = 0; r < 5; ++r) dc[r * 5 + 5] = rows[r][128];
          const int *D = dc;
          auto put = [&](int pos, int al, int64_t Q, int64_t num) {
            if (al == 0 || ws[pos] != 0) return;
            num *= Q00;
            int pred;
            if (num >= 0) {
              pred = int(((Q << 7) + num) / (Q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = int(((Q << 7) - num) / (Q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            ws[pos] = int16_t(pred);
          };
          if (change_dc) {
            put(1, bits[1], Q01,
                -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
                    3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                    13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]);
            put(8, bits[2], Q10,
                -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
                    13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] +
                    D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]);
            put(16, bits[3], Q20,
                D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
                    2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]);
            put(9, bits[4], Q11,
                -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]);
            put(2, bits[5], Q02,
                2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
                    D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]);
            put(3, bits[6], Q03, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
            put(10, bits[7], Q12, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
            put(17, bits[8], Q21, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
            put(24, bits[9], Q30, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
            int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
                                 6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
                                 8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] -
                                 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                                 6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] -
                                 2 * D[25]);
            int pred = num >= 0 ? int(((Q00 << 7) + num) / (Q00 << 8))
                                : -int(((Q00 << 7) - num) / (Q00 << 8));
            ws[0] = int16_t(pred);
          } else {
            put(1, bits[1], Q01, -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
            put(8, bits[2], Q10, -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
            put(16, bits[3], Q20, -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
            put(9, bits[4], Q11,
                D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
                    D[6] + 10 * D[7] - 10 * D[9]);
            put(2, bits[5], Q02, -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
          }
          idct_islow(ws, q, c.plane.data() + size_t(by) * 8 * pw + size_t(bx) * 8, int(pw));
          for (int r = 0; r < 5; ++r)
            for (int x = 1; x < 5; ++x) dc[r * 5 + x] = dc[r * 5 + x + 1];
          for (auto& row : rows) row += 64;
        }
      }
    }
  }

  void run(Rgb8* out);
};

// libjpeg-turbo's x86 SIMD islow IDCT (jsimd_idct_islow_avx2; the SSE2 code
// computes the same): jidctint.c's algorithm in 16-bit lanes. Products of
// two 16-bit values are exact 32-bit (pmaddwd) and 32-bit sums wrap; the
// dequantising product keeps its low 16 bits (pmullw), in0 +- in4, in7 + in3
// and in5 + in1 wrap at 16 bits (paddw), pass 1 packs to int16 with
// saturation, and pass 2 saturates to [-128, 127] before adding 128. When
// coefficients 8..63 of the block are all zero, pass 1 is the DC shortcut:
// (dc * q) << 2 in 16 bits, for every row.
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int16_t wrap16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
inline uint32_t mul(int32_t a, int32_t c) { return uint32_t(a * c); }  // |a| < 2^15, |c| < 2^15
inline int32_t descale(uint32_t x, int n) { return int32_t(x + (1u << (n - 1))) >> n; }

// One 8-point pass on in[0..7] (as int16): the eight outputs, before descaling.
void idct_1d(const int16_t* in, uint32_t* out) {
  const int32_t in0 = in[0], in1 = in[1], in2 = in[2], in3 = in[3], in4 = in[4], in5 = in[5],
                in6 = in[6], in7 = in[7];
  // even part
  uint32_t tmp3 = mul(in2, F0541 + F0765) + mul(in6, F0541);
  uint32_t tmp2 = mul(in2, F0541) + mul(in6, F0541 - F1847);
  uint32_t tmp0 = uint32_t(int32_t(wrap16(in0 + in4))) << 13;
  uint32_t tmp1 = uint32_t(int32_t(wrap16(in0 - in4))) << 13;
  const uint32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  // odd part
  const int32_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const uint32_t z3s = mul(z3, F1175 - F1961) + mul(z4, F1175);
  const uint32_t z4s = mul(z3, F1175) + mul(z4, F1175 - F0390);
  uint32_t o0 = mul(in7, F0298 - F0899) + mul(in1, -F0899) + z3s;
  uint32_t o3 = mul(in7, -F0899) + mul(in1, F1501 - F0899) + z4s;
  uint32_t o1 = mul(in5, F2053 - F2562) + mul(in3, -F2562) + z4s;
  uint32_t o2 = mul(in5, -F2562) + mul(in3, F3072 - F2562) + z3s;
  out[0] = t10 + o3;
  out[7] = t10 - o3;
  out[1] = t11 + o2;
  out[6] = t11 - o2;
  out[2] = t12 + o1;
  out[5] = t12 - o1;
  out[3] = t13 + o0;
  out[4] = t13 - o0;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];  // pass 1's output, ws[row * 8 + col]
  bool ac_zero = true;
  for (int i = 8; i < 64; ++i) ac_zero = ac_zero && in[i] == 0;
  if (ac_zero) {
    for (int col = 0; col < 8; ++col) {
      int16_t dc = wrap16(int32_t(uint16_t(wrap16(in[col] * int32_t(int16_t(q[col]))))) << 2);
      for (int row = 0; row < 8; ++row) ws[row * 8 + col] = dc;
    }
  } else {
    for (int col = 0; col < 8; ++col) {
      int16_t v[8];
      uint32_t o[8];
      for (int i = 0; i < 8; ++i) v[i] = wrap16(in[i * 8 + col] * int32_t(int16_t(q[i * 8 + col])));
      idct_1d(v, o);
      for (int i = 0; i < 8; ++i)
        ws[i * 8 + col] = int16_t(std::clamp(descale(o[i], 11), -32768, 32767));
    }
  }
  for (int row = 0; row < 8; ++row) {
    uint32_t o[8];
    idct_1d(ws + row * 8, o);
    uint8_t* op = out + size_t(row) * stride;
    for (int i = 0; i < 8; ++i) op[i] = uint8_t(std::clamp(descale(o[i], 18), -128, 127) + 128);
  }
}

// jdcolor.c's build_ycc_rgb_table.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// One component upsampled to the image's width for output row y
// (jdsample.c's methods, chosen as jinit_upsampler chooses them).
void upsample_row(const Component& c, int max_h, int max_v, int width, int y, uint8_t* dst) {
  const int pw = c.bw * 8;
  auto row = [&](int r) { return c.plane.data() + size_t(std::clamp(r, 0, c.dh - 1)) * pw; };
  const bool h2 = c.h * 2 == max_h, v2 = c.v * 2 == max_v;
  if (c.h == max_h && c.v == max_v) {
    std::memcpy(dst, row(y), width);
  } else if (h2 && c.v == max_v && c.dw > 2) {  // h2v1 fancy
    const uint8_t* in = row(y);
    std::vector<uint8_t> tmp(size_t(c.dw) * 2);
    uint8_t* o = tmp.data();
    int v = in[0];
    *o++ = uint8_t(v);
    *o++ = uint8_t((v * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < c.dw - 1; ++x) {
      v = in[x] * 3;
      *o++ = uint8_t((v + in[x - 1] + 1) >> 2);
      *o++ = uint8_t((v + in[x + 1] + 2) >> 2);
    }
    v = in[c.dw - 1];
    *o++ = uint8_t((v * 3 + in[c.dw - 2] + 1) >> 2);
    *o++ = uint8_t(v);
    std::memcpy(dst, tmp.data(), width);
  } else if (c.h == max_h && v2) {  // h1v2 fancy
    const int r = y >> 1;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < width; ++x) dst[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (h2 && v2 && c.dw > 2) {  // h2v2 fancy
    const int r = y >> 1;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
    std::vector<uint8_t> tmp(size_t(c.dw) * 2);
    uint8_t* o = tmp.data();
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    *o++ = uint8_t((this_sum * 4 + 8) >> 4);
    *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 2; x < c.dw; ++x) {
      next_sum = in0[x] * 3 + in1[x];
      *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
    *o++ = uint8_t((this_sum * 4 + 7) >> 4);
    std::memcpy(dst, tmp.data(), width);
  } else {  // box: h2v1, h2v2 and the generic integral method
    const int he = max_h / c.h, ve = max_v / c.v;
    const uint8_t* in = row(y / ve);
    for (int x = 0; x < width; ++x) dst[x] = in[x / he];
  }
}

void Decoder::run(Rgb8* out) {
  if (!read_markers()) die("no image in the JPEG file");
  initial_setup();
  refuse_unsupported();
  // jinit_upsampler: only integral sampling ratios
  for (int ci = 0; ci < ncomp; ++ci)
    if (max_h % comp[ci].h || max_v % comp[ci].v)
      die("fractional sampling not implemented");
  // jdhuff.c: a Huffman table 0 or 1 that a sequential file leaves out is the
  // standard one (jdphuff.c has no such rule)
  auto standard = [](Huff* h, const uint8_t* bits, const uint8_t* vals, int n) {
    if (h->present) return;
    std::memcpy(h->bits, bits, 17);
    std::memcpy(h->vals, vals, n);
    h->present = true;
  };
  if (!progressive && !arith) {
    standard(&dc_huff[0], kDcLumBits, kDcVals, 12);
    standard(&dc_huff[1], kDcChrBits, kDcVals, 12);
    standard(&ac_huff[0], kAcLumBits, kAcLumVals, 162);
    standard(&ac_huff[1], kAcChrBits, kAcChrVals, 162);
  }
  allocate();
  for (;;) {
    decode_scan();
    bool more = read_markers();
    if (!more) break;
    // one scan, then anything up to EOI but another SOS
    if (!multiple_scans) die("invalid JPEG file structure: two SOS markers");
  }

  int now[kMaxComps][10], before[kMaxComps][10];
  const bool smooth = smoothing_ok(now, before);
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp[ci];
    const size_t pw = size_t(c.bw) * 8;
    c.plane.assign(pw * c.bh * 8, 0);
    if (smooth) {
      idct_smoothed(ci, now[ci], before[ci]);
    } else {
      for (int by = 0; by < c.height_in_blocks; ++by)
        for (int bx = 0; bx < c.width_in_blocks; ++bx)
          idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.quant,
                     c.plane.data() + size_t(by) * 8 * pw + size_t(bx) * 8, int(pw));
    }
    std::vector<int16_t>().swap(c.coef);
  }

  out->w = width;
  out->h = height;
  out->rgb.resize(size_t(width) * height * 3);
  std::vector<uint8_t> rows(size_t(width) * ncomp);
  bool as_rgb = false;
  if (ncomp == 3) {
    if (saw_jfif) as_rgb = false;
    else if (saw_adobe) as_rgb = adobe_transform == 0;
    else as_rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
  static const YccTables kYcc;
  for (int y = 0; y < height; ++y) {
    for (int ci = 0; ci < ncomp; ++ci)
      upsample_row(comp[ci], max_h, max_v, width, y, rows.data() + size_t(ci) * width);
    uint8_t* o = out->rgb.data() + size_t(y) * width * 3;
    if (ncomp == 1) {
      for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = rows[x];
    } else if (as_rgb) {
      for (int x = 0; x < width; ++x)
        for (int k = 0; k < 3; ++k) o[3 * x + k] = rows[size_t(k) * width + x];
    } else {
      const uint8_t *Y = rows.data(), *cb = Y + width, *cr = cb + width;
      for (int x = 0; x < width; ++x) {
        int yy = Y[x];
        o[3 * x] = clamp255(yy + kYcc.cr_r[cr[x]]);
        o[3 * x + 1] = clamp255(yy + int((kYcc.cb_g[cb[x]] + kYcc.cr_g[cr[x]]) >> 16));
        o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb[x]]);
      }
    }
  }
}

}  // namespace

bool jpeg_decode(const uint8_t* data, size_t n, Rgb8* out, std::string* err) {
  Decoder d{Source{data, n}};
  try {
    d.run(out);
    return true;
  } catch (const Error& e) {
    *err = e.why;
    return false;
  } catch (const std::exception& e) {  // an allocation the image's size asks for
    *err = e.what();
    return false;
  }
}

bool jpeg_size(const uint8_t* data, size_t n, int* w, int* h, std::string* err) {
  Decoder d{Source{data, n}};
  try {
    if (!d.read_markers()) die("no image in the JPEG file");
    d.initial_setup();
    *w = d.width;
    *h = d.height;
    return true;
  } catch (const Error& e) {
    *err = e.why;
    return false;
  }
}

}  // namespace fsd
