"""The port's own PNG decoder (`native/src/pngdec.cpp`, on zlib) against
the JAX package's native library, which reads PNGs with libpng (1.6 here)
under png_set_expand + strip_16 + strip_alpha + gray_to_rgb.

Every colour type, bit depth, row filter and Adam7, written by the port's
zlib writer (`data/png.py`) with IDAT split over many chunks: BIT-EQUAL to the JAX
library and to PIL. PIL and libpng disagree on one kind: 16-bit gray, which
PIL reads as "I;16" and clips to 255 where libpng keeps the high byte, so
the port is held to libpng there, not to PIL. Then the corrupt cases: the
same decision (decode or fail) as libpng, and equal pixels where both
decode."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.native import loader as t_loader
from fewshot_detection_tpu_torch.data.png import CHANNELS, KINDS, libpng_rgb, png_bytes
from torch_image_writers import png_chunks
from torch_port_util import jax_native_loader

PIL_DIFFERS = {(0, 16)}


@pytest.fixture(scope="module")
def pipes():
    return t_loader.NativeImagePipe(n_threads=3), jax_native_loader().NativeImagePipe(n_threads=3)


def write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def decode_or_error(pipe, path):
    try:
        return pipe.decode(path)
    except IOError as e:
        return e


def size_or_none(pipe, path):
    try:
        return pipe.image_size(path)
    except IOError:
        return None


def image(rng, ctype, depth, w, h, n_palette=None):
    s = rng.randint(0, (n_palette or (1 << depth)) if ctype == 3 else 1 << depth,
                    (h, w, CHANNELS[ctype]))
    pal = rng.randint(0, 256, (n_palette or 1 << depth, 3)) if ctype == 3 else None
    return s, pal


@pytest.mark.parametrize("ctype,depth", KINDS)
def test_every_kind_filter_and_interlace_equals_jax_and_pil(pipes, tmp_path, ctype, depth):
    t, j = pipes
    rng = np.random.RandomState(ctype * 100 + depth)
    for interlace in (False, True):
        for filters in ("cycle", 0, 1, 2, 3, 4):
            w, h = (int(v) for v in rng.randint(1, 30, 2))
            s, pal = image(rng, ctype, depth, w, h)
            trns = struct.pack(">H", int(s.flat[0])) if ctype == 0 and filters == 1 else None
            data = png_bytes(s, ctype, depth, filters=filters, interlace=interlace,
                             palette=pal, trns=trns, idat_pieces=int(rng.randint(1, 6)))
            path = write(tmp_path, f"{interlace}_{filters}.png", data)
            got = t.decode(path)
            assert t.image_size(path) == j.image_size(path) == (w, h)
            np.testing.assert_array_equal(got, j.decode(path))
            np.testing.assert_array_equal(got, libpng_rgb(s, ctype, depth, pal))
            if (ctype, depth) not in PIL_DIFFERS:
                np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_pixel_rules(pipes, tmp_path):
    """The 8-bit values the rules give, written out: low-bit gray scaled,
    16 bits chopped (not rounded), alpha dropped, palettes expanded."""
    t, _ = pipes
    cases = [
        (np.array([[[0], [1]]]), 0, 1, None, [0, 255]),
        (np.array([[[0], [1], [2], [3]]]), 0, 2, None, [0, 0x55, 0xAA, 0xFF]),
        (np.array([[[0], [5], [15]]]), 0, 4, None, [0, 0x55, 0xFF]),
        (np.array([[[0x12FF], [0xFF80]]]), 0, 16, None, [0x12, 0xFF]),
        (np.array([[[7, 200]]]), 4, 8, None, [7]),
        (np.array([[[1], [0]]]), 3, 1, [[1, 2, 3], [4, 5, 6]], [[4, 5, 6], [1, 2, 3]]),
    ]
    for k, (s, ctype, depth, pal, want) in enumerate(cases):
        path = write(tmp_path, f"rule{k}.png",
                     png_bytes(s, ctype, depth, filters="cycle", palette=pal))
        got = t.decode(path)[0]
        want = np.asarray(want)
        want = np.repeat(want[:, None], 3, 1) if want.ndim == 1 else want
        np.testing.assert_array_equal(got, want)


def test_one_byte_idat_chunks_and_an_index_past_the_palette(pipes, tmp_path):
    t, j = pipes
    rng = np.random.RandomState(5)
    s, pal = image(rng, 2, 8, 13, 7)
    path = write(tmp_path, "split.png",
                 png_bytes(s, 2, 8, filters="cycle", idat_pieces=10_000, interlace=True))
    assert len([c for c in png_chunks(open(path, "rb").read()) if c[2] == b"IDAT"]) > 100
    np.testing.assert_array_equal(t.decode(path), s.astype(np.uint8))
    np.testing.assert_array_equal(t.decode(path), j.decode(path))
    # a 4-entry palette, indices up to 15: libpng reads black past the end
    s = rng.randint(0, 16, (5, 9, 1))
    path = write(tmp_path, "short_palette.png",
                 png_bytes(s, 3, 4, filters="cycle", palette=rng.randint(0, 256, (4, 3))))
    got = t.decode(path)
    np.testing.assert_array_equal(got, j.decode(path))
    assert not got[s[..., 0] >= 4].any()


def corrupt_cases(rng):
    """(name, bytes) of broken variants of one PNG."""
    s, _ = image(rng, 2, 8, 21, 17)
    good = png_bytes(s, 2, 8, filters="cycle", idat_pieces=3,
                     extra_chunks=[(b"tEXt", b"k\x00v")])
    chunks = {tag: (pos, n) for pos, n, tag in png_chunks(good)}

    def flip(at):
        b = bytearray(good)
        b[at] ^= 0x40
        return bytes(b)

    def fix_crc(b, pos, n):
        b = bytearray(b)
        b[pos + 8 + n:pos + 12 + n] = struct.pack(">I", zlib.crc32(bytes(b[pos + 4:pos + 8 + n])))
        return bytes(b)

    ihdr, idat, text, iend = chunks[b"IHDR"], chunks[b"IDAT"], chunks[b"tEXt"], chunks[b"IEND"]
    first_idat = next(p for p, n, tag in png_chunks(good) if tag == b"IDAT")
    cases = [
        ("good", good),
        ("bad signature", flip(1)),
        ("IHDR CRC", flip(ihdr[0] + 12)),
        ("IDAT CRC", flip(idat[0] + 10)),
        ("IEND CRC", flip(iend[0] + 9)),
        ("tEXt CRC (ancillary: skipped)", flip(text[0] + 9)),
        ("zlib error", fix_crc(flip(first_idat + 8), first_idat, png_chunks(good)[2][1])),
        ("bad bit depth", fix_crc(good[:24] + b"\x03" + good[25:], 8, 13)),
        ("unknown critical chunk", good[:text[0] + 4] + b"XEXt" + good[text[0] + 8:]),
        ("no IEND", good[:iend[0]]),
        ("missing PLTE", png_bytes(s[..., :1] % 4, 3, 2, filters="cycle")),
    ]
    raw = bytearray()
    for row in s.astype(np.uint8):
        raw += b"\x05" + row.tobytes()  # filter type 5 does not exist
    bad_filter = bytearray(good[:first_idat])
    z = zlib.compress(bytes(raw))
    bad_filter += struct.pack(">I", len(z)) + b"IDAT" + z + struct.pack(
        ">I", zlib.crc32(b"IDAT" + z)) + good[iend[0]:]
    cases.append(("bad filter type", bytes(bad_filter)))
    short = zlib.compress(bytes(raw[:len(raw) // 2]).replace(b"\x05", b"\x00"))
    cases.append(("stream ends early", good[:first_idat] + struct.pack(">I", len(short)) + b"IDAT"
                  + short + struct.pack(">I", zlib.crc32(b"IDAT" + short)) + good[iend[0]:]))
    cases += [(f"cut at {cut}", good[:cut]) for cut in range(0, len(good), 23)]
    return cases


def test_corrupt_files_decide_like_libpng(pipes, tmp_path):
    t, j = pipes
    decided = {}
    for k, (name, data) in enumerate(corrupt_cases(np.random.RandomState(9))):
        path = write(tmp_path, f"c{k}.png", data)
        assert size_or_none(t, path) == size_or_none(j, path), name
        got, want = decode_or_error(t, path), decode_or_error(j, path)
        assert isinstance(got, IOError) == isinstance(want, IOError), (name, got, want)
        if isinstance(got, IOError):
            assert path in str(got)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
        decided[name] = not isinstance(got, IOError)
    assert decided["good"] and decided["tEXt CRC (ancillary: skipped)"]
    for name in ("bad signature", "IHDR CRC", "IDAT CRC", "IEND CRC", "zlib error",
                 "bad bit depth", "unknown critical chunk", "no IEND", "missing PLTE",
                 "bad filter type", "stream ends early"):
        assert not decided[name], name


def test_random_byte_corruption_decides_like_libpng(pipes, tmp_path):
    t, j = pipes
    rng = np.random.RandomState(4)
    s, _ = image(rng, 6, 8, 19, 11)
    good = png_bytes(s, 6, 8, filters="cycle", idat_pieces=2, interlace=True)
    for k in range(120):
        b = bytearray(good)
        b[rng.randint(len(b))] = rng.randint(256)
        path = write(tmp_path, f"r{k}.png", bytes(b))
        assert size_or_none(t, path) == size_or_none(j, path), k
        got, want = decode_or_error(t, path), decode_or_error(j, path)
        assert isinstance(got, IOError) == isinstance(want, IOError), k
        if not isinstance(got, IOError):
            np.testing.assert_array_equal(got, want)


def test_pil_written_pngs_equal_jax(pipes, tmp_path):
    t, j = pipes
    rng = np.random.RandomState(2)
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1"):
        arr = rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
        img = Image.fromarray(arr).convert(mode)
        buf = io.BytesIO()
        img.save(buf, "PNG", optimize=mode == "P")
        path = write(tmp_path, f"pil_{mode}.png", buf.getvalue())
        got = t.decode(path)
        np.testing.assert_array_equal(got, j.decode(path))
        np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))
