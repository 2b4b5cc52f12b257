"""The native library's copy of PIL's default resize (`native/src/resize.cpp`)
and the port's `load_image_resized` under FSD_NATIVE=1.

`NativeImagePipe.resize_pil` must be BIT-EQUAL to
`Image.fromarray(a).resize((w, h))` (bicubic, Pillow's fixed-point passes),
and `load_image_resized` under FSD_NATIVE=1 bit-equal to the JAX package's
`load_image_resized` (PIL's decode and resize) wherever the two decodes
agree. The inputs where they do not are named below with the reason: the
difference is in the decode, not in the resize."""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu.utils.imaging import load_image_resized as jax_load_image_resized
from fewshot_detection_tpu_torch.data import png
from fewshot_detection_tpu_torch.native import NativeImagePipe
from fewshot_detection_tpu_torch.utils.imaging import load_image_resized

from torch_port_util import REPO

MANIFEST = json.load(open(os.path.join(REPO, "tests", "data_torch", "jpeg", "manifest.json")))
DIGESTS = json.load(open(os.path.join(REPO, "tests", "data_torch", "resize_digests.json")))

# Fixtures the JAX package's library decodes, but PIL (libjpeg-turbo 6.2 API,
# bundled with Pillow) decodes otherwise: the decodes differ, so the whole
# load_image_resized cannot agree there. Each reason was found by decoding
# with PIL and comparing with the manifest's digest of the JAX library's
# decode (test_excluded_fixtures_are_the_decode_differences holds the list).
PIL_DECODES_OTHERWISE = {
    "progressive_al1_end.jpg": "PIL's decode differs from the library's (successive "
                               "approximation that ends at Al = 1)",
    "progressive_dc_only.jpg": "PIL's decode differs from the library's (a progressive "
                               "file with DC scans only)",
    "progressive_truncated.jpg": "PIL raises 'image file is truncated'; the library "
                                 "decodes what is there",
    "truncated_420.jpg": "PIL raises 'image file is truncated'; the library decodes "
                         "what is there",
}
# 16-bit grayscale PNG: PIL opens it as mode I;16 and convert("RGB") clips the
# 16-bit value to 255, where libpng's strip_16 keeps the high byte.
EXCLUDED_PNG = {(0, 16): "PIL clips I;16 to 255 in convert('RGB'); libpng keeps the high byte"}

AGREEING_JPEGS = sorted(k for k, v in MANIFEST.items()
                        if v["jax"] != "fails" and k not in PIL_DECODES_OTHERWISE)

# (in width, in height, out width, out height)
RESIZE_CASES = [
    (400, 300, 416, 416),   # the detector's input from a VOC-sized image: up
    (500, 375, 208, 160),   # down in both
    (64, 48, 64, 20),       # vertical only
    (64, 48, 13, 48),       # horizontal only
    (64, 48, 64, 48),       # unchanged: the image as it is
    (1, 1, 7, 5),           # 1 -> N
    (9, 1, 1, 9),           # N -> 1 and 1 -> N
    (31, 17, 1, 1),         # N -> 1 in both
    (37, 23, 61, 19),       # odd sizes, up one way, down the other
    (300, 200, 31, 17),     # ratio above 4 (filter support widens)
    (1000, 20, 100, 20),    # ratio 10, one axis
    (3, 1000, 3, 7),        # ratio above 100
    (33, 77, 4, 5),
]


@pytest.fixture(scope="module")
def pipe():
    return NativeImagePipe(2)


@pytest.mark.parametrize("w,h,ow,oh", RESIZE_CASES)
@pytest.mark.parametrize("content", ["noise", "blocks"])
def test_resize_equals_pil(pipe, w, h, ow, oh, content):
    rng = np.random.default_rng(w * 7919 + h * 31 + ow * 7 + oh)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if content == "blocks":  # flat areas with hard edges: over- and undershoot clip
        a = (a // 128 * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(a).resize((ow, oh)))
    np.testing.assert_array_equal(pipe.resize_pil(a, ow, oh), want)


def test_resize_refuses_bad_shapes(pipe):
    with pytest.raises(ValueError):
        pipe.resize_pil(np.zeros((4, 4), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        pipe.resize_pil(np.zeros((4, 4, 3), np.uint8), 0, 2)


def _both(path, w, h, monkeypatch):
    monkeypatch.setenv("FSD_NATIVE", "1")
    got = load_image_resized(path, w, h)
    want = jax_load_image_resized(path, w, h)
    return got, want


PNG_KINDS = {
    "rgb8": (2, 8),
    "rgba8": (6, 8),
    "palette8": (3, 8),
    "gray8": (0, 8),
    "rgb16": (2, 16),
}


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
def test_load_image_resized_png_equals_jax(tmp_path, monkeypatch, kind):
    ctype, depth = PNG_KINDS[kind]
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 45, 61
    samples = rng.integers(0, 1 << depth, (h, w, png.CHANNELS[ctype]), dtype=np.int64)
    samples[10:30, 15:40] = samples[10, 15]  # a flat block: edges that over- and undershoot
    kw = {}
    if ctype == 3:
        kw["palette"] = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, samples, ctype, depth, **kw)
    for size in ((416, 416), (20, 33), (61, 45)):
        got, want = _both(path, *size, monkeypatch)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", AGREEING_JPEGS)
def test_load_image_resized_jpeg_equals_jax(monkeypatch, name):
    path = os.path.join(REPO, MANIFEST[name]["path"])
    for size in ((416, 416), (7, 5)):
        got, want = _both(path, *size, monkeypatch)
        np.testing.assert_array_equal(got, want)


def test_excluded_fixtures_are_the_decode_differences():
    """The excluded JPEGs are exactly those the JAX library decodes whose
    PIL decode differs or fails, and 16-bit gray PNG is a decode
    difference: the exclusions hide no resize fault."""
    differ = set()
    for name, entry in MANIFEST.items():
        if entry["jax"] == "fails":
            continue
        try:
            rgb = np.asarray(Image.open(os.path.join(REPO, entry["path"])).convert("RGB"))
        except OSError:
            differ.add(name)
            continue
        if hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()).hexdigest() != entry["jax"]:
            differ.add(name)
    assert differ == set(PIL_DECODES_OTHERWISE)
    assert len(AGREEING_JPEGS) == 37
    samples = np.full((4, 4, 1), 0x1234, np.int64)
    raw = png.png_bytes(samples, 0, 16)
    pil = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    assert (pil == 255).all() and (png.libpng_rgb(samples, 0, 16) == 0x12).all()
    assert set(EXCLUDED_PNG) == {(0, 16)}


def test_committed_digest_of_predictions_jpg(monkeypatch):
    """The digest the smoke's `native` phase holds the card's
    load_image_resized to is the JAX package's output, and the port's."""
    entry = DIGESTS["predictions.jpg"]
    path = os.path.join(REPO, "predictions.jpg")
    got, want = _both(path, *entry["size"], monkeypatch)
    for arr in (got, want):
        digest = hashlib.sha256(np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()
        assert digest == entry["float32_sha256"]
