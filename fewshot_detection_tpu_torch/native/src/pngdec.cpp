// PNG decoder of the port's native image pipeline, on zlib's inflate.
//
// It gives what libpng 1.6 gives the JAX package's native library after
// png_set_expand + png_set_strip_16 + png_set_strip_alpha +
// png_set_gray_to_rgb and png_read_image: 8-bit RGB for every colour type
// (0/2/3/4/6) and bit depth (1/2/4/8/16); low-bit gray scaled to 8 bits
// (x255, x0x55, x0x11); palettes expanded (an index past the palette reads
// black, as libpng's 256-entry palette does); 16 bits chopped to the high
// byte; alpha and tRNS dropped; Adam7 de-interlaced.
//
// It fails where libpng's read ends in png_error: a bad signature, a bad
// IHDR, a CRC error in a critical chunk (an ancillary chunk with a bad CRC
// is skipped, as libpng skips it), an unknown critical chunk, a zlib error
// or a stream that ends before the last row, a bad filter type, and a file
// that ends before IEND (png_read_end reads up to it). The compressed data
// are fed to inflate the way libpng feeds them (at most 8192 bytes of one
// IDAT at a time, one row's bytes of output a call), so a corrupt stream
// fails or decodes as it does there.

#include <zlib.h>

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <exception>

#include "decoders.h"

namespace fsd {
namespace {

constexpr uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};
constexpr uint32_t kMaxDim = 1000000;  // libpng's default user limits
constexpr size_t kReadSize = 8192;     // PNG_IDAT_READ_SIZE

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

bool fail(std::string* err, const char* why) {
  *err = why;
  return false;
}

struct Chunk {
  uint32_t type = 0;
  const uint8_t* data = nullptr;
  uint32_t length = 0;
  bool crc_ok = false;
};

constexpr uint32_t tag(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 |
         uint32_t(uint8_t(s[2])) << 8 | uint8_t(s[3]);
}
constexpr uint32_t kIHDR = tag("IHDR"), kPLTE = tag("PLTE"), kIDAT = tag("IDAT"),
                   kIEND = tag("IEND");

bool critical(uint32_t type) { return !(type & 0x20000000u); }

// The 8-byte header of the chunk at pos; false when the file ends inside it
// or it is invalid (libpng's png_read_chunk_header errors).
bool chunk_header(const uint8_t* d, size_t n, size_t pos, Chunk* c, std::string* err) {
  if (n - pos < 8) return fail(err, "file ends inside a chunk header");
  c->length = be32(d + pos);
  c->type = be32(d + pos + 4);
  if (c->length > 0x7fffffffu) return fail(err, "chunk length out of range");
  for (int i = 0; i < 4; ++i) {
    uint8_t b = d[pos + 4 + i];
    if (!((b >= 'A' && b <= 'Z') || (b >= 'a' && b <= 'z')))
      return fail(err, "invalid chunk type");
  }
  return true;
}

// Reads the whole chunk at *pos and checks its CRC (a critical chunk's
// CRC error is fatal; an ancillary one's is reported in crc_ok).
bool next_chunk(const uint8_t* d, size_t n, size_t* pos, Chunk* c, std::string* err) {
  if (!chunk_header(d, n, *pos, c, err)) return false;
  if (n - *pos - 8 < size_t(c->length) + 4) return fail(err, "file ends inside a chunk");
  c->data = d + *pos + 8;
  uLong crc = crc32(0L, d + *pos + 4, 4 + c->length);
  c->crc_ok = crc == be32(c->data + c->length);
  *pos += 12 + size_t(c->length);
  if (!c->crc_ok && critical(c->type)) return fail(err, "CRC error in a critical chunk");
  return true;
}

struct Header {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  int channels = 0;
  uint8_t palette[256 * 3] = {0};
  bool have_plte = false;
  size_t first_idat = 0;  // offset of the first IDAT chunk
};

bool parse_ihdr(const Chunk& c, Header* h, std::string* err) {
  if (c.length != 13) return fail(err, "invalid IHDR length");
  h->w = be32(c.data);
  h->h = be32(c.data + 4);
  h->depth = c.data[8];
  h->ctype = c.data[9];
  h->interlace = c.data[12];
  if (h->w == 0 || h->h == 0 || h->w > kMaxDim || h->h > kMaxDim)
    return fail(err, "image size out of range");
  int d = h->depth;
  switch (h->ctype) {
    case 0: h->channels = 1; if (d != 1 && d != 2 && d != 4 && d != 8 && d != 16) return fail(err, "invalid bit depth"); break;
    case 2: h->channels = 3; if (d != 8 && d != 16) return fail(err, "invalid bit depth"); break;
    case 3: h->channels = 1; if (d != 1 && d != 2 && d != 4 && d != 8) return fail(err, "invalid bit depth"); break;
    case 4: h->channels = 2; if (d != 8 && d != 16) return fail(err, "invalid bit depth"); break;
    case 6: h->channels = 4; if (d != 8 && d != 16) return fail(err, "invalid bit depth"); break;
    default: return fail(err, "invalid colour type");
  }
  if (c.data[10] != 0) return fail(err, "unknown compression method");
  if (c.data[11] != 0) return fail(err, "unknown filter method");
  if (h->interlace > 1) return fail(err, "unknown interlace method");
  return true;
}

// libpng's png_read_info: the chunks up to the first IDAT's header.
bool read_info(const uint8_t* d, size_t n, Header* h, std::string* err) {
  if (n < 8 || std::memcmp(d, kSignature, 8) != 0) return fail(err, "not a PNG signature");
  size_t pos = 8;
  bool have_ihdr = false;
  for (;;) {
    Chunk c;
    if (!chunk_header(d, n, pos, &c, err)) return false;
    if (c.type == kIDAT && have_ihdr) {  // png_read_info stops at its header
      if (h->ctype == 3 && !h->have_plte) return fail(err, "missing PLTE before IDAT");
      h->first_idat = pos;
      return true;
    }
    if (!next_chunk(d, n, &pos, &c, err)) return false;
    if (c.type == kIHDR) {
      if (have_ihdr) return fail(err, "IHDR out of place");
      if (!parse_ihdr(c, h, err)) return false;
      have_ihdr = true;
      continue;
    }
    if (!have_ihdr) return fail(err, "missing IHDR");
    if (c.type == kIEND) return fail(err, "IEND before IDAT");
    if (c.type == kPLTE) {
      if (h->have_plte) return fail(err, "duplicate PLTE");
      if (c.length > 3 * 256 || c.length % 3) {
        if (h->ctype == 3) return fail(err, "invalid PLTE");
        continue;
      }
      if (!(h->ctype & 2)) continue;  // a palette in a gray PNG is ignored
      std::memcpy(h->palette, c.data, c.length);
      h->have_plte = true;
      continue;
    }
    if (critical(c.type)) return fail(err, "unknown critical chunk");
  }
}

// The IDAT stream as libpng feeds it to inflate.
struct IdatReader {
  const uint8_t* d;
  size_t n, pos;
  const uint8_t* piece = nullptr;
  uint32_t left = 0;  // bytes of the current IDAT not fed yet
  bool in_idat = false;
  z_stream zs{};
  bool ended = false;
  std::string* err;

  // Fills `out` with `want` bytes; false on a zlib error or too little data.
  bool read(uint8_t* out, size_t want) {
    if (ended) return fail(err, "not enough image data");
    zs.next_out = out;
    zs.avail_out = uInt(want);
    do {
      if (zs.avail_in == 0) {
        while (left == 0) {  // the next IDAT (pos starts at the first)
          Chunk c;
          if (!next_chunk(d, n, &pos, &c, err)) return false;
          if (c.type != kIDAT) return fail(err, "not enough image data");
          piece = c.data;
          left = c.length;
          in_idat = true;
        }
        uInt take = uInt(std::min<size_t>(left, kReadSize));
        zs.next_in = const_cast<Bytef*>(piece);
        zs.avail_in = take;
        piece += take;
        left -= take;
      }
      int ret = inflate(&zs, Z_NO_FLUSH);
      if (ret == Z_STREAM_END) {
        ended = true;
        break;
      }
      if (ret != Z_OK) return fail(err, "zlib error in the image data");
    } while (zs.avail_out > 0);
    if (zs.avail_out > 0) return fail(err, "not enough image data");
    return true;
  }
};

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

bool unfilter(uint8_t* row, const uint8_t* prev, size_t len, int bpp, std::string* err) {
  uint8_t f = row[0];
  uint8_t* x = row + 1;
  switch (f) {
    case 0: break;
    case 1: for (size_t i = bpp; i < len; ++i) x[i] = uint8_t(x[i] + x[i - bpp]); break;
    case 2: for (size_t i = 0; i < len; ++i) x[i] = uint8_t(x[i] + prev[i]); break;
    case 3:
      for (size_t i = 0; i < len; ++i) {
        int a = i >= size_t(bpp) ? x[i - bpp] : 0;
        x[i] = uint8_t(x[i] + ((a + prev[i]) >> 1));
      }
      break;
    case 4:
      for (size_t i = 0; i < len; ++i) {
        int a = i >= size_t(bpp) ? x[i - bpp] : 0;
        int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
        x[i] = uint8_t(x[i] + paeth(a, prev[i], c));
      }
      break;
    default: return fail(err, "bad adaptive filter value");
  }
  return true;
}

// One unfiltered row of `w` pixels -> RGB at `dst`, every `step`-th pixel
// from `x0` of the output row.
void emit_row(const Header& h, const uint8_t* x, uint32_t w, uint8_t* dst, uint32_t x0,
              uint32_t step) {
  const int d = h.depth;
  for (uint32_t i = 0; i < w; ++i) {
    uint8_t* o = dst + size_t(x0 + i * step) * 3;
    if (d < 8) {
      int per = 8 / d;
      int v = (x[i / per] >> ((per - 1 - int(i % per)) * d)) & ((1 << d) - 1);
      if (h.ctype == 3) {
        std::memcpy(o, h.palette + v * 3, 3);
      } else {
        uint8_t g = uint8_t(d == 1 ? v * 255 : d == 2 ? v * 0x55 : v * 0x11);
        o[0] = o[1] = o[2] = g;
      }
      continue;
    }
    const int bps = d / 8;  // bytes a sample; the high byte comes first
    const uint8_t* p = x + size_t(i) * h.channels * bps;
    switch (h.ctype) {
      case 0: case 4: o[0] = o[1] = o[2] = p[0]; break;
      case 3: std::memcpy(o, h.palette + p[0] * 3, 3); break;
      default: o[0] = p[0]; o[1] = p[bps]; o[2] = p[2 * bps]; break;
    }
  }
}

// The rest of the file after the image data, as png_read_end reads it.
bool read_end(const uint8_t* d, size_t n, size_t pos, std::string* err) {
  for (;;) {
    Chunk c;
    if (!next_chunk(d, n, &pos, &c, err)) return false;
    if (c.type == kIEND) return true;
    if (critical(c.type) && c.type != kIDAT && c.type != kPLTE)
      return fail(err, "unknown critical chunk");
  }
}

}  // namespace

bool png_size(const uint8_t* data, size_t n, int* w, int* h, std::string* err) {
  Header hd;
  if (!read_info(data, n, &hd, err)) return false;
  *w = int(hd.w);
  *h = int(hd.h);
  return true;
}

static bool decode(const uint8_t* data, size_t n, Rgb8* out, std::string* err) {
  Header hd;
  if (!read_info(data, n, &hd, err)) return false;
  out->w = int(hd.w);
  out->h = int(hd.h);
  out->rgb.assign(size_t(hd.w) * hd.h * 3, 0);
  const int bits = hd.depth * hd.channels;
  const int bpp = std::max(1, bits / 8);

  IdatReader rd{data, n, hd.first_idat};
  rd.err = err;
  if (inflateInit(&rd.zs) != Z_OK) return fail(err, "zlib init failed");
  struct Closer {
    z_stream* z;
    ~Closer() { inflateEnd(z); }
  } closer{&rd.zs};

  static constexpr int kX0[7] = {0, 4, 0, 2, 0, 1, 0}, kDx[7] = {8, 8, 4, 4, 2, 2, 1};
  static constexpr int kY0[7] = {0, 0, 4, 0, 2, 0, 1}, kDy[7] = {8, 8, 8, 4, 4, 2, 2};
  const int passes = hd.interlace ? 7 : 1;
  std::vector<uint8_t> cur, prev;
  for (int p = 0; p < passes; ++p) {
    uint32_t x0 = hd.interlace ? kX0[p] : 0, dx = hd.interlace ? kDx[p] : 1;
    uint32_t y0 = hd.interlace ? kY0[p] : 0, dy = hd.interlace ? kDy[p] : 1;
    if (x0 >= hd.w || y0 >= hd.h) continue;  // an empty pass has no bytes
    uint32_t pw = (hd.w - x0 + dx - 1) / dx;
    size_t len = (size_t(pw) * bits + 7) / 8;
    cur.assign(len + 1, 0);
    prev.assign(len, 0);
    for (uint32_t y = y0; y < hd.h; y += dy) {
      if (!rd.read(cur.data(), len + 1)) return false;
      if (!unfilter(cur.data(), prev.data(), len, bpp, err)) return false;
      emit_row(hd, cur.data() + 1, pw, out->rgb.data() + size_t(y) * hd.w * 3, x0, dx);
      std::memcpy(prev.data(), cur.data() + 1, len);
    }
  }
  // libpng consumes what is left of the IDAT chunks (its zlib errors there
  // are warnings) and then reads up to IEND.
  size_t pos = rd.pos;
  if (rd.in_idat) {
    while (true) {
      size_t at = pos;
      Chunk c;
      if (!next_chunk(data, n, &pos, &c, err)) return false;
      if (c.type != kIDAT) {
        pos = at;
        break;
      }
    }
  }
  return read_end(data, n, pos, err);
}

bool png_decode(const uint8_t* data, size_t n, Rgb8* out, std::string* err) {
  try {
    return decode(data, n, out, err);
  } catch (const std::exception& e) {  // an allocation the image's size asks for
    *err = e.what();
    return false;
  }
}

}  // namespace fsd
