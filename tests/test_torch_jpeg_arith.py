"""The port's arithmetic decoding (`native/src/jpegdec.cpp`: SOF9 sequential
and SOF10 progressive, T.81 Annex D and F.2.4/G.1.3) BIT-EQUAL to the JAX
package's native library, which decodes with the system's libjpeg-turbo
(2.1.5, built with D_ARITH_CODING_SUPPORTED) at its default settings.

- Lossless transcodes (`tests/jpeg_transcode.py`) of PIL's baseline files
  into arithmetic coding: sequential and progressive (libjpeg's standard
  script and random ones), colour and gray, with and without restarts.
- DAC segments that condition the statistics otherwise than the encoder
  did: the decoder must follow them through bins the encoder never used.
- Huffman data under an SOF9 marker, read as arithmetic data: a strict test
  on arbitrary bytes (bad codes leave the rest of a scan at zero).
- Every cut of a few files (a marker, or the end of the file, feeds zeros)
  and single-byte corruptions: the same decision and the same pixels."""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_transcode import random_script, transcode, with_dac
from test_torch_jpeg_decoder import assert_same, pipes  # noqa: F401  (a fixture)
from test_torch_jpeg_progressive import check, photo, pil


@pytest.mark.parametrize("seed", range(4))
def test_sequential_arithmetic_equals_jax(pipes, tmp_path, seed):  # noqa: F811
    rng = np.random.RandomState(200 + seed)
    for i in range(10):
        w, h = (int(v) for v in rng.randint(1, 90, 2))
        base = pil(photo(rng, w, h, gray=i % 4 == 3), quality=int(rng.choice([10, 50, 90, 100])),
                   subsampling=int(rng.randint(3)))
        got = check(pipes, tmp_path, f"a{i}.jpg",
                    transcode(base, arith=True, restart=int(rng.choice([0, 1, 2, 5]))))
        assert got.shape == (h, w, 3)


@pytest.mark.parametrize("seed", range(4))
def test_progressive_arithmetic_equals_jax(pipes, tmp_path, seed):  # noqa: F811
    rng = np.random.RandomState(300 + seed)
    for i in range(10):
        w, h = (int(v) for v in rng.randint(1, 70, 2))
        gray = i % 3 == 2
        base = pil(photo(rng, w, h, gray), quality=int(rng.choice([30, 75, 95])),
                   subsampling=int(rng.randint(3)))
        if i % 4 == 0:
            kw = {"progressive": True}
        else:
            kw = {"script": random_script(rng, 1 if gray else 3, complete=i % 4 == 1)}
        check(pipes, tmp_path, f"pa{i}.jpg",
              transcode(base, arith=True, restart=int(rng.choice([0, 1, 3])), **kw))


@pytest.mark.parametrize("progressive", [False, True])
def test_dac_conditioning_equals_jax(pipes, tmp_path, progressive):  # noqa: F811
    """Random DAC values (L <= U for DC tables, K for AC tables); an L > U
    or a table index past 31 is fatal in libjpeg, and must fail here too."""
    rng = np.random.RandomState(17 + progressive)
    data = transcode(pil(photo(rng, 40, 32), quality=70), arith=True, progressive=progressive)
    outcomes = set()
    for k in range(16):
        pairs = []
        for tbl in range(2):
            lo = int(rng.randint(0, 16))
            hi = int(rng.randint(lo, 16))
            pairs.append((tbl, hi << 4 | lo))
            pairs.append((16 + tbl, int(rng.randint(1, 64))))
        if k % 5 == 4:
            pairs.append((0, 0x0f) if k % 2 else (32, 0))  # L > U, or no such table
        got = check(pipes, tmp_path, f"dac{k}.jpg", with_dac(data, pairs))
        outcomes.add(isinstance(got, IOError))
    assert outcomes == {True, False}


@pytest.mark.parametrize("seed", range(2))
def test_huffman_data_under_sof9_equals_jax(pipes, tmp_path, seed):  # noqa: F811
    rng = np.random.RandomState(400 + seed)
    for i in range(8):
        data = pil(photo(rng, *(int(v) for v in rng.randint(8, 80, 2))),
                   quality=int(rng.choice([20, 75, 95])), subsampling=int(rng.randint(3)),
                   **({"restart_marker_blocks": 2} if i % 2 else {}))
        j = data.index(b"\xff\xc0")
        check(pipes, tmp_path, f"h{i}.jpg", data[:j + 1] + b"\xc9" + data[j + 2:])


@pytest.mark.parametrize("kind", ["sequential", "sequential_restart", "progressive",
                                  "progressive_restart"])
def test_every_cut_decides_like_jax(pipes, tmp_path, kind):  # noqa: F811
    rng = np.random.RandomState(23)
    data = transcode(pil(photo(rng, 45, 37), quality=85, subsampling=2), arith=True,
                     progressive=kind.startswith("progressive"),
                     restart=2 if kind.endswith("restart") else 0)
    step = max(1, len(data) // 80)
    for cut in range(0, len(data), step):
        check(pipes, tmp_path, f"c{cut}.jpg", data[:cut])


@pytest.mark.parametrize("progressive", [False, True])
def test_single_byte_corruptions_decide_like_jax(pipes, tmp_path, progressive):  # noqa: F811
    rng = np.random.RandomState(29 + progressive)
    data = transcode(pil(photo(rng, 41, 33), quality=80, subsampling=1), arith=True,
                     progressive=progressive, restart=3)
    for k in range(60):
        bad = bytearray(data)
        bad[rng.randint(2, len(data))] = rng.randint(256)
        check(pipes, tmp_path, f"x{k}.jpg", bytes(bad))


def test_rgb_arithmetic_without_transform_equals_jax(pipes, tmp_path):  # noqa: F811
    """An Adobe-marked RGB file (no colour transform) in arithmetic coding."""
    rng = np.random.RandomState(31)
    buf = io.BytesIO()
    Image.fromarray(photo(rng, 30, 20)).save(buf, "JPEG", quality=80, subsampling=0)
    data = buf.getvalue()
    j = data.index(b"\xff\xe0")
    n = int.from_bytes(data[j + 2:j + 4], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    check(pipes, tmp_path, "rgb.jpg", transcode(data[:j] + adobe + data[j + 2 + n:], arith=True))
