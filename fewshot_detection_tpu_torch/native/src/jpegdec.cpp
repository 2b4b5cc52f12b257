// Sequential JPEG decoder of the port's native image pipeline (SOF0 and
// SOF1, 8-bit, Huffman coding, interleaved or not, any sampling factors up
// to 4, restart intervals).
//
// Its output is bit-equal to libjpeg-turbo's default decode to RGB, which is
// what the JAX package's native library gets (jpeg_read_header, then
// out_color_space = JCS_RGB, on a stdio source):
// - the integer "islow" IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
//   with its range-limit table, which wraps a value through & RANGE_MASK
//   rather than clamping it;
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
// leaves the rest of the scan at zero coefficients (flat gray), restart
// markers are resynchronised as jpeg_resync_to_restart does, and a missing
// Huffman table 0 or 1 is the standard one (libjpeg-turbo's Motion-JPEG
// rule). It fails where libjpeg's error_exit would.
//
// It refuses, with the reason, what it does not implement: progressive,
// arithmetic-coded, lossless and hierarchical JPEG, precision other than 8
// bits, and four-component (CMYK/YCCK) images. jpeg_size still reads the
// dimensions of a file that jpeg_read_header accepts.

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

struct Decoder {
  Source src;
  int unread_marker = 0;
  bool saw_soi = false, saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int sof = 0;
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
  // bit reader (libjpeg's bitread_working_state)
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;

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
    sof = code;
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
        case M_DAC: skip_variable(); break;
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
    multiple_scans = comps_in_scan < ncomp || sof == M_SOF2 || sof == M_SOF10;
  }

  // What the decoder does not implement, in the order libjpeg would meet it.
  void refuse_unsupported() {
    if (sof == M_SOF2) die("progressive JPEG (SOF2) is not supported");
    if (sof == M_SOF9 || sof == M_SOF10) die("arithmetic-coded JPEG is not supported");
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
  void decode_scan() {
    for (int i = 0; i < comps_in_scan; ++i) {
      Component& c = comp[scan_comp[i]];
      if (!c.latched) {  // jdinput.c's latch_quant_tables
        if (c.tq < 0 || c.tq >= 4 || !qt_present[c.tq]) die("quantization table not defined");
        std::memcpy(c.quant, qt[c.tq], sizeof c.quant);
        c.latched = true;
      }
    }
    Derived dct[4], act[4];
    bool dc_done[4] = {false, false, false, false}, ac_done[4] = {false, false, false, false};
    for (int i = 0; i < comps_in_scan; ++i) {
      Component& c = comp[scan_comp[i]];
      if (c.dc_tbl >= 4 || !dc_huff[c.dc_tbl].present) die("Huffman table not defined");
      if (c.ac_tbl >= 4 || !ac_huff[c.ac_tbl].present) die("Huffman table not defined");
      if (!dc_done[c.dc_tbl]) derive(dc_huff[c.dc_tbl], true, &dct[c.dc_tbl]);
      if (!ac_done[c.ac_tbl]) derive(ac_huff[c.ac_tbl], false, &act[c.ac_tbl]);
      dc_done[c.dc_tbl] = ac_done[c.ac_tbl] = true;
    }
    // the MCU geometry (jdinput.c's per_scan_setup)
    int mcus_per_row, mcu_rows, nblk = 0;
    int blk_comp[kMaxBlocksInMcu], blk_dx[kMaxBlocksInMcu], blk_dy[kMaxBlocksInMcu];
    if (comps_in_scan == 1) {
      Component& c = comp[scan_comp[0]];
      mcus_per_row = c.width_in_blocks;
      mcu_rows = c.height_in_blocks;
      blk_comp[0] = scan_comp[0];
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
            blk_comp[nblk] = scan_comp[i];
            blk_dx[nblk] = x;
            blk_dy[nblk] = y;
            ++nblk;
          }
      }
    }
    int last_dc[kMaxComps] = {0};
    get_buffer = 0;
    bits_left = 0;
    insufficient = false;
    int restarts_to_go = restart_interval;
    for (int my = 0; my < mcu_rows; ++my) {
      for (int mx = 0; mx < mcus_per_row; ++mx) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            bits_left = 0;
            read_restart_marker();
            std::fill(last_dc, last_dc + kMaxComps, 0);
            restarts_to_go = restart_interval;
            if (unread_marker == 0) insufficient = false;
          }
        }
        if (!insufficient) {
          for (int b = 0; b < nblk; ++b) {
            Component& c = comp[blk_comp[b]];
            int bx, by;
            if (comps_in_scan == 1) {
              bx = mx;
              by = my;
            } else {
              bx = mx * c.h + blk_dx[b];
              by = my * c.v + blk_dy[b];
            }
            int16_t* blk = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
            int s = huff_decode(dct[c.dc_tbl]);
            if (s) s = extend(get_bits(s), s);
            s = int(unsigned(s) + unsigned(last_dc[blk_comp[b]]));
            last_dc[blk_comp[b]] = s;
            blk[0] = int16_t(s);
            const Derived& at = act[c.ac_tbl];
            for (int k = 1; k < 64; ++k) {
              s = huff_decode(at);
              int r = s >> 4;
              s &= 15;
              if (s) {
                k += r;
                s = extend(get_bits(s), s);
                blk[kNatural[k]] = int16_t(s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
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

  void run(Rgb8* out);
};

// jidctint.c's jpeg_idct_islow and its range-limit table.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i : i - 1024;  // the value before CENTERJSAMPLE
      if (i < 128) t[i] = uint8_t(v + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(v + 128);
    }
  }
};

constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const uint16_t* q, const uint8_t* lim, uint8_t* out,
                int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = int(ip[0]) * int(int16_t(qp[0])) * 4;
      for (int i = 0; i < 8; ++i) wp[i * 8] = dc;
      continue;
    }
    auto dq = [&](int i) { return int64_t(int(ip[i * 8]) * int(int16_t(qp[i * 8]))); };
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = int(descale(t10 + tmp3, 11));
    wp[56] = int(descale(t10 - tmp3, 11));
    wp[8] = int(descale(t11 + tmp2, 11));
    wp[48] = int(descale(t11 - tmp2, 11));
    wp[16] = int(descale(t12 + tmp1, 11));
    wp[40] = int(descale(t12 - tmp1, 11));
    wp[24] = int(descale(t13 + tmp0, 11));
    wp[32] = int(descale(t13 - tmp0, 11));
  }
  for (int row = 0; row < 8; ++row) {
    const int* wp = ws + row * 8;
    uint8_t* op = out + size_t(row) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = lim[int(descale(wp[0], 5)) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * 8192, tmp1 = (int64_t(wp[0]) - wp[4]) * 8192;
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = lim[int(descale(t10 + tmp3, 18)) & 1023];
    op[7] = lim[int(descale(t10 - tmp3, 18)) & 1023];
    op[1] = lim[int(descale(t11 + tmp2, 18)) & 1023];
    op[6] = lim[int(descale(t11 - tmp2, 18)) & 1023];
    op[2] = lim[int(descale(t12 + tmp1, 18)) & 1023];
    op[5] = lim[int(descale(t12 - tmp1, 18)) & 1023];
    op[3] = lim[int(descale(t13 + tmp0, 18)) & 1023];
    op[4] = lim[int(descale(t13 - tmp0, 18)) & 1023];
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
  // jdhuff.c: a Huffman table 0 or 1 that the file leaves out is the standard one
  auto standard = [](Huff* h, const uint8_t* bits, const uint8_t* vals, int n) {
    if (h->present) return;
    std::memcpy(h->bits, bits, 17);
    std::memcpy(h->vals, vals, n);
    h->present = true;
  };
  standard(&dc_huff[0], kDcLumBits, kDcVals, 12);
  standard(&dc_huff[1], kDcChrBits, kDcVals, 12);
  standard(&ac_huff[0], kAcLumBits, kAcLumVals, 162);
  standard(&ac_huff[1], kAcChrBits, kAcChrVals, 162);
  allocate();
  for (;;) {
    decode_scan();
    bool more = read_markers();
    if (!more) break;
    // one scan, then anything up to EOI but another SOS
    if (!multiple_scans) die("invalid JPEG file structure: two SOS markers");
  }

  static const RangeLimit kLimit;
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp[ci];
    const size_t pw = size_t(c.bw) * 8;
    c.plane.assign(pw * c.bh * 8, 0);
    for (int by = 0; by < c.height_in_blocks; ++by)
      for (int bx = 0; bx < c.width_in_blocks; ++bx)
        idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.quant, kLimit.t,
                   c.plane.data() + size_t(by) * 8 * pw + size_t(bx) * 8, int(pw));
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
