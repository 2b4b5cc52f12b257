"""Writes the JPEG fixtures of the port's decoder tests and their manifest.

    python tests/data_torch/jpeg/make_fixtures.py

CPU only; needs PIL and the JAX package's native library (libjpeg-turbo),
which gives each file's reference decode. The fixtures are small images
that reach the decoder's corners: every chroma subsampling PIL writes and
4:4:0, gray, restart intervals, optimised Huffman tables, qualities 5 to 100
(100 with saturated colours), sizes of 1, 2, 3, 17 and 33, box upsampling
(a downsampled width of 2), non-interleaved scans, other sampling factors,
an MCU of more than 10 blocks (which libjpeg refuses),
RGB without a colour transform, the standard Huffman tables left out, a
truncated file, progressive and arithmetic coding (PIL's progressive files
and lossless transcodes by `tests/jpeg_transcode.py`: SOF2 with restarts and
scan scripts that leave the coefficients incomplete, so that libjpeg's block
smoothing runs; SOF9 and SOF10 with restarts and with DAC conditioning;
400x300 progressive and arithmetic transcodes of predictions.jpg, for the
decode rates), and the codings libjpeg fails on too (lossless, 12-bit, CMYK).

manifest.json holds, for each file (and the repo's predictions.jpg): its
`size` as jpeg_read_header reads it (null where that fails), `jax`: the
SHA-256 of the JAX library's RGB decode (or "fails"), and `port`: the
same digest where the port must decode bit-equal, or "refused" with the
`reason` its error must name. `arithmetic.jpg` is Huffman data under an
SOF9 marker: libjpeg decodes it as arithmetic data, and so must the port."""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from jpeg_transcode import transcode, with_dac  # noqa: E402
from torch_image_writers import jpeg_bytes, rgb_to_ycc_planes  # noqa: E402


def scene(rng, w, h, saturated=False):
    """A small photo-like image: gradients, a few shapes, some noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 127 / max(w + h - 2, 1)], -1)
    for _ in range(3):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(2, max(w, h) / 2)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.randint(0, 256, 3)
    img += rng.normal(0, 12, img.shape)
    if saturated:  # pure primaries on hard edges: IDCT overshoot at quality 100
        img = np.where(img > 127, 255.0, 0.0)
        img[..., rng.randint(3)] = 255 - img[..., rng.randint(3)]
    return np.clip(img, 0, 255).astype(np.uint8)


def pil(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def with_sof(data: bytes, marker: int, precision=None) -> bytes:
    """The same file with its SOF0 marker replaced (and its precision)."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def fixtures():
    rng = np.random.RandomState(20261017)
    a = scene(rng, 48, 40)
    files = {
        "q50_444.jpg": pil(a, quality=50, subsampling=0),
        "q50_422.jpg": pil(a, quality=50, subsampling=1),
        "q50_420.jpg": pil(a, quality=50, subsampling=2),
        "q5_420.jpg": pil(a, quality=5, subsampling=2),
        "q95_422.jpg": pil(a, quality=95, subsampling=1),
        "q100_420_saturated.jpg": pil(scene(rng, 40, 24, saturated=True), quality=100,
                                      subsampling=2),
        "q100_422_saturated.jpg": pil(scene(rng, 33, 17, saturated=True), quality=100,
                                      subsampling=1),
        "gray.jpg": pil(scene(rng, 33, 31)[..., 0], quality=75),
        "restart_420.jpg": pil(a, quality=75, subsampling=2, restart_marker_blocks=3),
        "optimized_444.jpg": pil(a, quality=80, subsampling=0, optimize=True),
        "size1x1_420.jpg": pil(scene(rng, 1, 1), quality=90, subsampling=2),
        "size2x17_420.jpg": pil(scene(rng, 2, 17), quality=90, subsampling=2),
        "size3x3_420.jpg": pil(scene(rng, 3, 3), quality=90, subsampling=2),
        "size17x9_422.jpg": pil(scene(rng, 17, 9), quality=90, subsampling=1),
        "size33x31_420.jpg": pil(scene(rng, 33, 31), quality=90, subsampling=2),
        "size33x2_420.jpg": pil(scene(rng, 33, 2), quality=90, subsampling=2),
    }
    b = scene(rng, 35, 29)
    for name, samp, kw in (
            ("s440.jpg", ((1, 2), (1, 1), (1, 1)), {}),
            ("s420_noninterleaved.jpg", ((2, 2), (1, 1), (1, 1)), {"scans": [[0], [1], [2]]}),
            ("s420_y_then_cbcr_restart.jpg", ((2, 2), (1, 1), (1, 1)),
             {"scans": [[0], [1, 2]], "restart": 2}),
            ("s411_box.jpg", ((4, 1), (1, 1), (1, 1)), {}),
            ("s31_box.jpg", ((3, 1), (1, 1), (1, 1)), {}),
            ("s44_22_11_noninterleaved.jpg", ((4, 4), (2, 2), (1, 1)),
             {"scans": [[0], [1], [2]]}),
            ("mcu_too_big.jpg", ((4, 4), (2, 2), (1, 1)), {}),
            ("s22_21_12.jpg", ((2, 2), (2, 1), (1, 2)), {}),
            ("no_dht_420.jpg", ((2, 2), (1, 1), (1, 1)), {"dht": False})):
        files[name] = jpeg_bytes(rgb_to_ycc_planes(b, samp), size=(35, 29), sampling=samp, **kw)
    rgb_planes = [b[..., k] for k in range(3)]
    files["adobe_rgb.jpg"] = jpeg_bytes(rgb_planes, size=(35, 29), sampling=((1, 1),) * 3,
                                        marker="adobe0")
    files["rgb_ids.jpg"] = jpeg_bytes(rgb_planes, size=(35, 29), sampling=((1, 1),) * 3,
                                      marker=None, ids=[ord("R"), ord("G"), ord("B")])
    whole = pil(scene(rng, 64, 48), quality=80, subsampling=2)
    files["truncated_420.jpg"] = whole[:len(whole) * 3 // 5]
    files["progressive.jpg"] = pil(a, quality=75, progressive=True)
    files["progressive_444_optimized.jpg"] = pil(a, quality=80, subsampling=0, progressive=True,
                                                 optimize=True)
    files["progressive_422_restart.jpg"] = pil(a, quality=75, subsampling=1, progressive=True,
                                               restart_marker_blocks=2)
    base = files["q50_420.jpg"]
    # DC only: smoothing estimates coefficients 1..9 and the DC itself
    files["progressive_dc_only.jpg"] = transcode(base, script="0,1,2:0:0:0:1")
    # the last AC scans at Al = 1: smoothing fills the still-zero ones
    files["progressive_al1_end.jpg"] = transcode(
        base, script="0,1,2:0:0:0:0;0:1:5:0:2;0:6:63:0:1;1:1:63:0:1;2:1:63:0:1;0:1:5:2:1")
    # cut in its last scan: the rows past the cut smooth as before that scan
    whole = transcode(files["q95_422.jpg"], progressive=True, restart=3)
    files["progressive_truncated.jpg"] = whole[:len(whole) * 4 // 5]
    files["arithmetic_restart.jpg"] = transcode(files["q50_422.jpg"], arith=True, restart=2)
    files["arithmetic_dac.jpg"] = with_dac(transcode(files["q50_444.jpg"], arith=True),
                                           [(0, 0x31), (1, 0x20), (16, 2), (17, 0x3f)])
    files["sof10.jpg"] = transcode(files["q50_420.jpg"], arith=True, progressive=True)
    files["sof10_restart_gray.jpg"] = transcode(files["gray.jpg"], arith=True, restart=1,
                                                script="0:0:0:0:1;0:1:5:0:2;0:6:63:0:0;0:1:5:2:1;0:0:0:1:0")
    with open(os.path.join(REPO, "predictions.jpg"), "rb") as f:
        photo = f.read()
    files["predictions_progressive.jpg"] = transcode(photo, progressive=True)
    files["predictions_arithmetic.jpg"] = transcode(photo, arith=True)
    files["arithmetic.jpg"] = with_sof(pil(a, quality=75), 0xC9)
    files["lossless.jpg"] = with_sof(pil(a, quality=75), 0xC3)
    files["precision12.jpg"] = with_sof(pil(a, quality=75), 0xC1, precision=12)
    cmyk = Image.fromarray(scene(rng, 24, 16)).convert("CMYK")
    buf = io.BytesIO()
    cmyk.save(buf, "JPEG", quality=75)
    files["cmyk.jpg"] = buf.getvalue()
    return files


REFUSED = {"lossless.jpg": "lossless", "precision12.jpg": "precision", "cmyk.jpg": "CMYK"}


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()).hexdigest()


def main():
    from torch_port_util import jax_native_loader

    pipe = jax_native_loader().NativeImagePipe(n_threads=1)
    files = fixtures()
    manifest = {}
    paths = {name: os.path.join(HERE, name) for name in files}
    for name, data in files.items():
        with open(paths[name], "wb") as f:
            f.write(data)
    paths["predictions.jpg"] = os.path.join(REPO, "predictions.jpg")
    for name, path in sorted(paths.items()):
        try:
            size = list(pipe.image_size(path))
        except IOError:
            size = None
        try:
            jax = digest(pipe.decode(path))
        except IOError:
            jax = "fails"
        entry = {"path": os.path.relpath(path, REPO), "size": size, "jax": jax}
        if name in REFUSED:
            entry.update(port="refused", reason=REFUSED[name])
        else:
            entry["port"] = jax
        manifest[name] = entry
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
