"""PNG files written with zlib and struct only (no image library): the
synthetic data's images, and every colour type, bit depth, row filter and
Adam7 for checking a decoder. `libpng_rgb` is what a reader set up as the
native library's (libpng's expand, strip_16, strip_alpha, gray_to_rgb)
gets from such a file."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# samples a pixel of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (colour type, bit depth) the PNG standard allows
KINDS = ((0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16))
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def chunk(tag: bytes, data: bytes, crc: int | None = None) -> bytes:
    """One chunk; its CRC computed unless given."""
    if crc is None:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    """One packed row filtered with PNG filter type `kind` (0-4)."""
    x, up = row.astype(np.int32), prev.astype(np.int32)
    left, upleft = np.zeros_like(x), np.zeros_like(x)
    left[bpp:], upleft[bpp:] = x[:-bpp], up[:-bpp]
    if kind == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        pred = (0 * x, left, up, (left + up) // 2)[kind]
    return bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def _pack_rows(flat: np.ndarray, depth: int) -> list:
    """(h, w*channels) samples -> the rows' bytes at bit depth `depth`."""
    flat = flat.astype(np.int64)
    if depth == 16:
        return [np.frombuffer(r.astype(">u2").tobytes(), np.uint8) for r in flat]
    if depth == 8:
        return [r.astype(np.uint8) for r in flat]
    per = 8 // depth
    packed = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per))).reshape(flat.shape[0], -1, per)
    return list((packed << ((per - 1 - np.arange(per)) * depth)).sum(2).astype(np.uint8))


def _filtered(samples: np.ndarray, depth: int, filters, interlace: bool, bpp: int) -> bytes:
    """The image's rows (Adam7's passes in turn when interlaced), packed and
    filtered, as the zlib stream holds them."""
    raw, k = bytearray(), 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        prev = np.zeros_like(rows[0])
        for r in rows:
            raw += _filter_row(k % 5 if filters == "cycle" else int(filters), r, prev, bpp)
            prev, k = r, k + 1
    return bytes(raw)


def png_bytes(samples: np.ndarray, ctype: int | None = None, depth: int = 8, *,
              filters: int | str = 0, interlace: bool = False, palette=None, trns=None,
              idat_pieces: int = 1, extra_chunks=(), level: int = 6) -> bytes:
    """A PNG of `samples`: by default an 8-bit RGB (H, W, 3) or gray (H, W)
    image, else (H, W, channels) samples of colour type `ctype` at bit depth
    `depth`. `filters`: one filter type for every row, or "cycle" for 0-4
    in turn. `idat_pieces` splits the zlib stream over that many IDATs;
    `extra_chunks` are (tag, data) chunks put before the PLTE."""
    samples = np.asarray(samples)
    if ctype is None:
        ctype = 2 if samples.ndim == 3 else 0
    h, w = samples.shape[:2]
    samples = samples.reshape(h, w, CHANNELS[ctype])
    if filters == 0 and depth == 8 and not interlace:  # every row at once
        rows = samples.reshape(h, -1).astype(np.uint8)
        raw = np.hstack([np.zeros((h, 1), np.uint8), rows]).tobytes()
    else:
        raw = _filtered(samples, depth, filters, interlace, max(1, depth * CHANNELS[ctype] // 8))
    z = zlib.compress(raw, level)
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    for tag, data in extra_chunks:
        out += chunk(tag, data)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    step = max(1, -(-len(z) // idat_pieces))
    for i in range(0, len(z), step):
        out += chunk(b"IDAT", z[i:i + step])
    return out + chunk(b"IEND", b"")


def write_png(path: str, samples: np.ndarray, ctype: int | None = None, depth: int = 8,
              **kw) -> None:
    """`png_bytes(samples, ctype, depth, **kw)` into `path`, through a
    temporary name."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(png_bytes(samples, ctype, depth, **kw))
    os.replace(tmp, path)


def libpng_rgb(samples: np.ndarray, ctype: int, depth: int, palette=None) -> np.ndarray:
    """The (H, W, 3) uint8 pixels libpng gives for these samples under
    expand, strip_16, strip_alpha and gray_to_rgb: low-bit gray scaled to 8
    bits, 16 bits cut to the high byte, palettes looked up, alpha dropped."""
    s = np.asarray(samples).astype(np.int64)
    if ctype == 3:
        return np.asarray(palette, np.uint8)[s[..., 0]]
    if depth == 16:
        s = s >> 8
    elif depth < 8:
        s = s * (255 // ((1 << depth) - 1))
    rgb = np.repeat(s[..., :1], 3, -1) if ctype in (0, 4) else s[..., :3]
    return rgb.astype(np.uint8)
