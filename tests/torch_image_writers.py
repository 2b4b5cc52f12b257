"""A pure-Python baseline-JPEG writer for the decoder tests, and a PNG
chunk lister (the PNG writer is the port's own, `data/png.py`).

The JPEG writer writes what PIL cannot be asked for: any sampling factors,
non-interleaved scans, restart intervals, missing Huffman tables, Adobe and
component-ID colour hints, and coefficients chosen directly (so that an
IDCT output lands far outside the sample range). numpy and the standard
library only."""

import struct
import zlib

import numpy as np

# ------------------------------------------------------------------ PNG


def png_chunks(data: bytes) -> list:
    """[(offset, length, tag)] of every chunk of a PNG file."""
    out, pos = [], 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((pos, n, tag))
        pos += 12 + n
    return out


# ----------------------------------------------------------------- JPEG

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

STD_DC = (
    ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
)
STD_AC = (
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
        "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
        "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
        "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
        "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374757677"
        "78797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
)
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def _codes(bits, vals):
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _dct_matrix():
    c = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                   for n in range(8)] for k in range(8)])
    return c


def quantized_blocks(plane: np.ndarray, bw: int, bh: int, q: np.ndarray) -> np.ndarray:
    """(bh, bw, 64) natural-order quantized DCT coefficients of a sample
    plane, padded by edge replication to bw*8 x bh*8."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128
    c = _dct_matrix()
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ki,abij,lj->abkl", c, blocks, c)
    return np.round(coef.reshape(bh, bw, 64) / q.reshape(64)).astype(np.int64)


def jpeg_bytes(planes=None, *, size=None, sampling=((1, 1),), coefs=None, quant=None,
               tq=None, scans=None, restart=0, marker="jfif", ids=None, sof=0xC0,
               precision=8, dht=True, table_of=None, truncate_tail=False) -> bytes:
    """A sequential Huffman JPEG.

    planes: per component, its (dh, dw) uint8 samples at its own sampling
    (or coefs: per component (bh, bw, 64) quantized coefficients, natural
    order, at least the component's MCU-grid size). size: (w, h) of the
    image. sampling: (h, v) per component. quant: tables (64,) natural
    order, quant[tq[ci]] for component ci. scans: lists of component
    indices (default: one interleaved scan). marker: "jfif", "adobe0",
    "adobe1" or None. table_of: Huffman table index per component (default
    0 for the first, 1 for the others); dht=False leaves the tables out."""
    n = len(sampling)
    w, h = size
    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    quant = quant if quant is not None else [STD_LUMA_Q]
    tq = tq if tq is not None else [min(i, len(quant) - 1) for i in range(n)]
    ids = ids if ids is not None else list(range(1, n + 1))
    table_of = table_of if table_of is not None else [0 if i == 0 else 1 for i in range(n)]
    scans = scans if scans is not None else [list(range(n))]
    mcux, mcuy = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    if coefs is None:
        coefs = []
        for ci, (sh, sv) in enumerate(sampling):
            coefs.append(quantized_blocks(planes[ci], mcux * sh, mcuy * sv,
                                          np.asarray(quant[tq[ci]])))
    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    elif marker and marker.startswith("adobe"):
        out += b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64\x00\x00\x00\x00" + bytes(
            [int(marker[5:])])
    for i, qt in enumerate(quant):
        qz = np.asarray(qt).reshape(64)[ZIGZAG]
        out += b"\xff\xdb" + struct.pack(">HB", 67, i) + bytes(int(v) for v in qz)
    out += bytes([0xFF, sof]) + struct.pack(">HBHHB", 8 + 3 * n, precision, h, w, n)
    for ci, (sh, sv) in enumerate(sampling):
        out += bytes([ids[ci], (sh << 4) | sv, tq[ci]])
    if dht:
        for t in sorted(set(table_of)):
            for cls, std in ((0, STD_DC), (1, STD_AC)):
                bits, vals = std[min(t, 1)]
                body = bytes([(cls << 4) | t]) + bytes(bits) + bytes(vals)
                out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    dc_codes = [_codes(*STD_DC[min(t, 1)]) for t in range(4)]
    ac_codes = [_codes(*STD_AC[min(t, 1)]) for t in range(4)]
    for comps in scans:
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps), len(comps))
        for ci in comps:
            out += bytes([ids[ci], (table_of[ci] << 4) | table_of[ci]])
        out += b"\x00\x3f\x00"
        if len(comps) == 1:
            ci = comps[0]
            sh, sv = sampling[ci]
            bw, bh = -(-w * sh // (8 * max_h)), -(-h * sv // (8 * max_v))
            mcus = [[(ci, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            mcus = []
            for my in range(mcuy):
                for mx in range(mcux):
                    mcu = []
                    for ci in comps:
                        sh, sv = sampling[ci]
                        mcu += [(ci, my * sv + y, mx * sh + x) for y in range(sv) for x in range(sh)]
                    mcus.append(mcu)
        bits = _Bits()
        last = {ci: 0 for ci in comps}
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                last = {ci: 0 for ci in comps}
            for ci, by, bx in mcu:
                zz = coefs[ci][by, bx][ZIGZAG]
                diff = int(zz[0]) - last[ci]
                last[ci] = int(zz[0])
                s = _category(diff)
                bits.put(*dc_codes[table_of[ci]][s])
                if s:
                    bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
                run = 0
                for k in range(1, 64):
                    v = int(zz[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_codes[table_of[ci]][0xF0])
                        run -= 16
                    s = _category(v)
                    bits.put(*ac_codes[table_of[ci]][(run << 4) | s])
                    bits.put(v if v > 0 else v + (1 << s) - 1, s)
                    run = 0
                if run:
                    bits.put(*ac_codes[table_of[ci]][0x00])
        bits.flush()
        out += bits.out
    if not truncate_tail:
        out += b"\xff\xd9"
    return bytes(out)


def rgb_to_ycc_planes(rgb: np.ndarray, sampling) -> list:
    """JFIF YCbCr planes of an (h, w, 3) image, each chroma plane box-
    averaged to its sampling (the planes' sizes as a decoder expects)."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128
    cr = 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128
    h, w = y.shape
    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    out = []
    for plane, (sh, sv) in zip((y, cb, cr), sampling):
        fx, fy = max_h // sh, max_v // sv
        dh, dw = -(-h * sv // max_v), -(-w * sh // max_h)
        p = np.pad(plane, ((0, dh * fy - h), (0, dw * fx - w)), mode="edge")
        out.append(np.clip(np.round(p.reshape(dh, fy, dw, fx).mean((1, 3))), 0, 255).astype(np.uint8))
    return out
