"""The port's native image pipeline (`native/`) against the JAX package's.

Both packages compile the same crop/resize/HSV/assembler code with the
same compiler and flags, and the port's own PNG and JPEG decoders give
libpng's and libjpeg's pixels, so every method must give BIT-EQUAL arrays
(no tolerance) on PNG and JPEG files. A library that cannot be built raises in
the port, where the JAX package falls back to PIL. `get_image_size` reads
the header natively under FSD_NATIVE=1 and gives PIL's (width, height)."""

import os
import random
import sys

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.native import loader as t_loader
from fewshot_detection_tpu_torch.utils.imaging import get_image_size

from torch_port_util import jax_native_loader

KINDS = ("png", "jpg", "gray_png")
# (width, height, pleft, pright, ptop, pbot, flip, dhue, dsat, dexp)
AUGMENTS = [
    (64, 48, 0, 0, 0, 0, 0, 0.0, 1.0, 1.0),
    (41, 37, 5, -3, 7, 2, 1, 0.07, 1.3, 0.8),
    (96, 96, -12, -9, -6, -4, 0, -0.1, 0.7, 1.4),
    (32, 80, 15, 10, -8, 12, 1, 0.1, 1.5, 0.67),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (48, 64, 3), np.uint8)
    arr[10:30, 20:40] = [250, 30, 30]
    out = {"arr": arr}
    for kind in KINDS:
        path = str(root / f"a_{kind}.{'jpg' if kind == 'jpg' else 'png'}")
        img = Image.fromarray(arr)
        if kind == "gray_png":
            img = img.convert("L")
        img.save(path, **({"quality": 90} if kind == "jpg" else {}))
        out[kind] = path
    return out


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    j = jax_native_loader()
    return t_loader.NativeImagePipe(n_threads=3), j.NativeImagePipe(n_threads=3)


@pytest.mark.parametrize("kind", KINDS)
def test_image_size_and_decode_equal_jax(files, pipes, kind):
    t, j = pipes
    assert t.image_size(files[kind]) == j.image_size(files[kind]) == (64, 48)
    got = t.decode(files[kind])
    np.testing.assert_array_equal(got, j.decode(files[kind]))
    if kind == "png":
        np.testing.assert_array_equal(got, files["arr"])  # lossless


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", [(32, 24), (64, 48), (97, 61)])
def test_load_plain_and_resize_raw_equal_jax(files, pipes, kind, size):
    t, j = pipes
    got = t.load_plain(files[kind], *size)
    assert got.shape == (size[1], size[0], 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j.load_plain(files[kind], *size))
    raw = t.decode(files[kind])
    np.testing.assert_array_equal(t.resize_raw(raw, *size), j.resize_raw(raw, *size))
    np.testing.assert_array_equal(t.resize_raw(raw, *size), got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("aug", range(len(AUGMENTS)))
def test_load_augment_and_augment_raw_equal_jax(files, pipes, kind, aug):
    t, j = pipes
    args = AUGMENTS[aug]
    got = t.load_augment(files[kind], *args)
    np.testing.assert_array_equal(got, j.load_augment(files[kind], *args))
    raw = t.decode(files[kind])
    np.testing.assert_array_equal(t.augment_raw(raw, *args), j.augment_raw(raw, *args))
    np.testing.assert_array_equal(t.augment_raw(raw, *args), got)


def _params(rng, n):
    return np.stack([
        [rng.randint(-12, 12), rng.randint(-12, 12), rng.randint(-9, 9),
         rng.randint(-9, 9), rng.randint(0, 2), rng.uniform(-0.1, 0.1),
         rng.uniform(0.7, 1.4), rng.uniform(0.7, 1.4)]
        for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("augment", [False, True])
def test_load_batch_and_batch_raw_equal_jax(files, pipes, augment):
    t, j = pipes
    paths = [files[k] for k in KINDS] * 3
    params = _params(np.random.RandomState(3), len(paths)) if augment else None
    got, fails = t.load_batch(paths, 40, 36, params)
    want, jfails = j.load_batch(paths, 40, 36, params)
    assert fails == jfails == 0
    np.testing.assert_array_equal(got, want)
    raws = [t.decode(p) for p in paths]
    got_raw, fails = t.load_batch_raw(raws, 40, 36, params)
    want_raw, _ = j.load_batch_raw(raws, 40, 36, params)
    assert fails == 0
    np.testing.assert_array_equal(got_raw, want_raw)
    np.testing.assert_array_equal(got_raw, got)
    for i in (0, 4, 8):  # row i of the batch is image i with params row i
        one = (t.load_augment(paths[i], 40, 36, *[int(v) for v in params[i, :5]],
                              *[float(v) for v in params[i, 5:]])
               if augment else t.load_plain(paths[i], 40, 36))
        np.testing.assert_array_equal(got[i], one)


def test_failed_images_raise_or_count_like_jax(files, pipes, tmp_path):
    t, j = pipes
    bad = str(tmp_path / "not_an_image.png")
    with open(bad, "wb") as f:
        f.write(b"neither png nor jpeg")
    for path in (bad, str(tmp_path / "missing.jpg")):
        for fn in (lambda p: p.image_size(path), lambda p: p.decode(path),
                   lambda p: p.load_plain(path, 8, 8),
                   lambda p: p.load_augment(path, 8, 8, 0, 0, 0, 0, 0, 0.0, 1.0, 1.0)):
            with pytest.raises(IOError):
                fn(t)
            with pytest.raises(IOError):
                fn(j)
    got, fails = t.load_batch([bad, files["png"]], 16, 16)
    want, jfails = j.load_batch([bad, files["png"]], 16, 16)
    assert fails == jfails == 1 and not got[0].any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        t.load_batch([files["png"]], 16, 16, np.zeros((2, 8), np.float32))


def test_library_lands_in_build_dir_named_by_hash():
    path = t_loader.library_path()
    assert os.path.dirname(path) == t_loader.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.basename(path).startswith("libimagepipe_") and path.endswith(".so")
    # the JAX package's flags, so both libraries give the same bytes
    cmd = t_loader.build_command("out.so")
    assert cmd[:6] == ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    # the port's own decoders: zlib, and no system image library
    assert cmd[-1:] == ["-lz"] and "-ljpeg" not in cmd and "-lpng" not in cmd
    with open(t_loader.SOURCE) as f:
        src = f.read()
    from fewshot_detection_tpu.native import loader as j_loader

    with open(j_loader._SRC) as f:
        jsrc = f.read()
    # the same code after the decoders: crop, resize, HSV and the assembler
    body = lambda s: s[s.index("// ----------------------------------------------------------- crop"):]
    assert body(src) == body(jsrc)


@pytest.mark.parametrize("compiler", ["false", "/nonexistent/g++"])
def test_a_failed_build_raises_and_never_falls_back(monkeypatch, compiler, tmp_path):
    """A compiler that fails (or is missing) raises RuntimeError with its
    output, from the pipe and from the datasets under FSD_NATIVE=1; nothing
    half-built is left behind."""
    from fewshot_detection_tpu_torch.config import Settings
    from fewshot_detection_tpu_torch.data import datasets as tds

    monkeypatch.setattr(t_loader, "CXX", compiler)
    monkeypatch.setattr(t_loader, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="native image pipeline"):
        t_loader.NativeImagePipe()
    assert os.listdir(tmp_path / "_build") == []
    monkeypatch.setenv("FSD_NATIVE", "1")
    s = Settings.configure({"metayolo": "1", "data": "voc", "novelid": "0"}, None, None)
    with pytest.raises(RuntimeError, match="native image pipeline"):
        tds.DetectionDataset(["x.png"], s, shuffle=False, rng=random.Random(0))
    with pytest.raises(RuntimeError, match="native image pipeline"):
        get_image_size("x.png")


def test_get_image_size_native_equals_pil_without_pil(files, monkeypatch):
    want = {k: Image.open(files[k]).size for k in KINDS}
    monkeypatch.setenv("FSD_NATIVE", "1")
    monkeypatch.setitem(sys.modules, "PIL", None)  # any PIL import now fails
    assert {k: get_image_size(files[k]) for k in KINDS} == want
    monkeypatch.setenv("FSD_NATIVE", "0")
    with pytest.raises(ImportError):
        get_image_size(files["png"])
