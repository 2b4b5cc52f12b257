"""The port's progressive (SOF2) Huffman decoding (`native/src/jpegdec.cpp`)
BIT-EQUAL to the JAX package's native library, which decodes with the
system's libjpeg-turbo (written against 2.1.5) at its default settings.

- PIL's progressive files over subsampling 4:4:4/4:2:2/4:2:0, sizes,
  optimised tables (each scan then defines its own) and restart intervals.
- Lossless transcodes (`tests/jpeg_transcode.py`) with random scan scripts:
  spectral selection, successive approximation, and scripts that leave
  bands out or stop refining, which turn libjpeg-turbo 2.1's block
  smoothing on (with and without its DC interpolation), with restarts.
- Every cut of a few files (the rows past the cut smooth with the
  progression before the last scan) and single-byte corruptions: the same
  decision (decode or fail) and the same pixels.
- Scan headers libjpeg refuses (fatal) or only warns about (decoded), and a
  DQT between scans, which libjpeg does not apply to a component whose
  table it has latched."""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_transcode import random_script, transcode
from test_torch_jpeg_decoder import assert_same, pipes  # noqa: F401  (a fixture)


def photo(rng, w, h, gray=False):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 127 / max(w + h - 2, 1)], -1)
    img += rng.normal(0, 25, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def pil(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def check(pipes, tmp_path, name, data):  # noqa: F811
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return assert_same(pipes, path)


@pytest.mark.parametrize("seed", range(4))
def test_pil_progressive_files_equal_jax(pipes, tmp_path, seed):  # noqa: F811
    rng = np.random.RandomState(seed)
    for i in range(12):
        w, h = (int(v) for v in rng.randint(1, 90, 2))
        kw = {"quality": int(rng.choice([10, 50, 75, 90, 100])), "progressive": True,
              "subsampling": int(rng.randint(3)), "optimize": bool(rng.rand() < 0.5)}
        if rng.rand() < 0.4:
            kw["restart_marker_blocks"] = int(rng.randint(1, 4))
        got = check(pipes, tmp_path, f"p{i}.jpg", pil(photo(rng, w, h, gray=i % 4 == 3), **kw))
        assert got.shape == (h, w, 3)


@pytest.mark.parametrize("seed", range(6))
def test_random_scan_scripts_equal_jax(pipes, tmp_path, seed):  # noqa: F811
    rng = np.random.RandomState(100 + seed)
    for i in range(10):
        w, h = (int(v) for v in rng.randint(1, 70, 2))
        gray = i % 3 == 2
        base = pil(photo(rng, w, h, gray), quality=int(rng.choice([30, 75, 95])),
                   subsampling=int(rng.randint(3)))
        data = transcode(base, script=random_script(rng, 1 if gray else 3, complete=i % 5 == 0),
                         restart=int(rng.choice([0, 0, 1, 3])))
        check(pipes, tmp_path, f"s{i}.jpg", data)


SCRIPTS = {
    "dc_only": "0,1,2:0:0:0:0",
    "dc_al2": "0,1,2:0:0:0:2",
    "ac_al1_no_refine": "0,1,2:0:0:0:1;0:1:63:0:1;1:1:63:0:1;2:1:63:0:1",
    "low_band_only": "0,1,2:0:0:0:0;0:1:9:0:0",
    "standard": None,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_every_cut_decides_like_jax(pipes, tmp_path, script):  # noqa: F811
    rng = np.random.RandomState(7)
    base = pil(photo(rng, 45, 37), quality=85, subsampling=2)
    data = transcode(base, script=SCRIPTS[script], progressive=SCRIPTS[script] is None,
                     restart=2 if script == "standard" else 0)
    step = max(1, len(data) // 80)
    for cut in range(0, len(data), step):
        check(pipes, tmp_path, f"c{cut}.jpg", data[:cut])


@pytest.mark.parametrize("restart", [0, 2])
def test_single_byte_corruptions_decide_like_jax(pipes, tmp_path, restart):  # noqa: F811
    rng = np.random.RandomState(11 + restart)
    data = transcode(pil(photo(rng, 41, 33), quality=80, subsampling=1), progressive=True,
                     restart=restart)
    for k in range(60):
        bad = bytearray(data)
        bad[rng.randint(2, len(data))] = rng.randint(256)
        check(pipes, tmp_path, f"x{k}.jpg", bytes(bad))


def sos_offsets(data: bytes):
    out, i = [], 2
    while True:
        i = data.find(b"\xff\xda", i)
        if i < 0:
            return out
        out.append(i)
        i += 2


def test_bad_scan_parameters_fail_or_warn_like_jax(pipes, tmp_path):  # noqa: F811
    """Ss/Se/Al out of range and a refinement whose Al is not Ah - 1 are
    fatal in libjpeg; an Ah that does not follow the last scan's Al and an
    AC scan before its DC are only warned about, and decoded."""
    rng = np.random.RandomState(3)
    data = transcode(pil(photo(rng, 30, 22), quality=75), progressive=True)
    offsets = sos_offsets(data)
    assert len(offsets) >= 6
    decided = set()
    for k, off in enumerate(offsets):
        n = data[off + 4]
        params = off + 5 + 2 * n  # Ss, Se, Ah/Al
        for change in ({0: 0, 1: 5}, {0: 3, 1: 2}, {1: 64}, {2: 0x0e}, {2: 0x31}, {2: 0x20},
                       {2: 0x10}, {2: 0x01}):
            bad = bytearray(data)
            for i, v in change.items():
                bad[params + i] = v
            got = check(pipes, tmp_path, f"b{k}_{len(decided)}.jpg", bytes(bad))
            decided.add(isinstance(got, IOError))
    assert decided == {True, False}


def test_dqt_between_scans_is_not_applied_to_a_latched_component(pipes, tmp_path):  # noqa: F811
    rng = np.random.RandomState(5)
    data = transcode(pil(photo(rng, 40, 24), quality=60, subsampling=0), progressive=True)
    last = sos_offsets(data)[-1]
    dqt = b"\xff\xdb\x00\x43\x00" + bytes(range(1, 65))  # table 0 redefined
    changed = data[:last] + dqt + data[last:]
    got = check(pipes, tmp_path, "dqt.jpg", changed)
    np.testing.assert_array_equal(got, check(pipes, tmp_path, "orig.jpg", data))


def test_dc_only_scan_is_smoothed(pipes, tmp_path):  # noqa: F811
    """Block smoothing runs: a gray DC-only file's 8x8 blocks are not flat,
    where its DC coefficients alone would give constant blocks."""
    rng = np.random.RandomState(9)
    data = transcode(pil(photo(rng, 48, 40, gray=True), quality=75), script="0:0:0:0:0")
    img = check(pipes, tmp_path, "dc.jpg", data)[..., 0].astype(int)
    blocks = img.reshape(5, 8, 6, 8)
    assert (blocks.max((1, 3)) - blocks.min((1, 3)) > 0).mean() > 0.5
