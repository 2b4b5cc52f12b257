"""The port's own JPEG decoder (`native/src/jpegdec.cpp`) against the JAX
package's native library, which decodes with the system's libjpeg-turbo
(2.1.5 here) to RGB with its defaults.

- The committed fixtures (`tests/data_torch/jpeg/`, written by
  `make_fixtures.py`) and the repo's `predictions.jpg`: the manifest's
  digests are checked against the JAX library here, so they cannot go
  stale, and the port's decode is BIT-EQUAL to the JAX library's on every
  file the library decodes, progressive and arithmetic-coded included;
  `image_size` is equal on every file; what the library fails on too
  (lossless, 12-bit, CMYK) is refused with an error that names the file and
  the reason. Progressive and arithmetic coding have files of their own in
  test_torch_jpeg_progressive.py and test_torch_jpeg_arith.py.
- JPEGs that PIL writes from a seed over subsampling, quality, size,
  optimised tables and restart intervals, and JPEGs of the tests' own
  writer over sampling factors (4:2:0 and 4:2:2 at widths and heights of 1,
  2, 3, 17 and 33, box upsampling at a downsampled width of 2, 3:1, 4:1,
  4:4:0, non-interleaved scans): bit-equal.
- Truncated and corrupted files: the same decision (decode or fail) and the
  same pixels as the JAX library.

On coefficients no encoder writes, where an IDCT output falls outside
[-512, 511], libjpeg's C IDCT wraps it through its range-limit table
(& RANGE_MASK), while libjpeg-turbo's x86 SIMD IDCT, which the JAX library
runs by default, saturates it. The port computes as the SIMD code does and
equals the JAX library's default decode there; the C path (the JAX library
run with JSIMD_FORCENONE=1 in a child process) is pinned to differ.

PIL bundles its own libjpeg-turbo; it is used here to write files, never
as the reference."""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.native import loader as t_loader
from torch_image_writers import jpeg_bytes, rgb_to_ycc_planes
from torch_port_util import REPO, jax_native_loader

FIXTURES = os.path.join(REPO, "tests", "data_torch", "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def sha(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def pipes():
    return t_loader.NativeImagePipe(n_threads=3), jax_native_loader().NativeImagePipe(n_threads=3)


def outcome(pipe, path):
    """(size or None, decoded array or the error)."""
    try:
        size = pipe.image_size(path)
    except IOError:
        size = None
    try:
        return size, pipe.decode(path)
    except IOError as e:
        return size, e


def assert_same(pipes, path):
    (ts, tarr), (js, jarr) = (outcome(p, path) for p in pipes)
    assert ts == js, path
    assert isinstance(tarr, IOError) == isinstance(jarr, IOError), (path, tarr, jarr)
    if not isinstance(tarr, IOError):
        np.testing.assert_array_equal(tarr, jarr, err_msg=path)
    return tarr


def test_manifest_covers_the_fixtures():
    on_disk = {f for f in os.listdir(FIXTURES) if f.endswith(".jpg")}
    assert on_disk | {"predictions.jpg"} == set(MANIFEST)
    sizes = {name: os.path.getsize(os.path.join(REPO, e["path"])) for name, e in MANIFEST.items()}
    # the small fixtures, and the two 400x300 transcodes of predictions.jpg
    # that the card's smoke test times the decoder on
    photo = {"predictions.jpg", "predictions_progressive.jpg", "predictions_arithmetic.jpg"}
    assert sum(v for k, v in sizes.items() if k not in photo) < 150_000
    assert sum(v for k, v in sizes.items() if k in photo - {"predictions.jpg"}) < 150_000


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_against_manifest_and_jax(pipes, name):
    t, j = pipes
    entry = MANIFEST[name]
    path = os.path.join(REPO, entry["path"])
    js, jarr = outcome(j, path)
    # the manifest is the JAX library's word
    assert (list(js) if js else None) == entry["size"]
    assert (sha(jarr) if not isinstance(jarr, IOError) else "fails") == entry["jax"]
    ts, tarr = outcome(t, path)
    assert ts == js
    if entry["port"] == "refused":
        assert isinstance(tarr, IOError)
        assert path in str(tarr) and entry["reason"] in str(tarr), str(tarr)
    elif entry["port"] == "fails":
        assert isinstance(tarr, IOError) and path in str(tarr)
    else:
        assert not isinstance(tarr, IOError), str(tarr)
        np.testing.assert_array_equal(tarr, jarr)
        assert sha(tarr) == entry["port"]


def test_progressive_is_refused_but_sized(pipes):
    """Progressive and arithmetic-coded files, refused before, are now
    decoded EQUAL to the JAX library and sized as it sizes them, through
    every method that reads a file."""
    t, j = pipes
    for name in ("progressive.jpg", "arithmetic.jpg", "sof10.jpg"):
        path = os.path.join(FIXTURES, name)
        assert t.image_size(path) == j.image_size(path) == Image.open(path).size
        np.testing.assert_array_equal(t.decode(path), j.decode(path))
        np.testing.assert_array_equal(t.load_plain(path, 16, 16), j.load_plain(path, 16, 16))
        args = (16, 16, 1, 0, 2, 1, 1, 0.1, 1.2, 0.9)
        np.testing.assert_array_equal(t.load_augment(path, *args), j.load_augment(path, *args))


@pytest.mark.parametrize("seed", range(4))
def test_random_pil_jpegs_equal_jax(pipes, tmp_path, seed):
    rng = np.random.RandomState(seed)
    for i in range(16):
        w, h = (int(v) for v in rng.randint(1, 80, 2))
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 3 == 1:  # saturated primaries on hard edges
            arr = np.where(arr > 127, 255, 0).astype(np.uint8)
        img = Image.fromarray(arr)
        if i % 5 == 4:
            img = img.convert("L")
        kw = {"quality": int(rng.choice([5, 30, 50, 75, 90, 95, 100])),
              "subsampling": int(rng.randint(3)), "optimize": bool(rng.rand() < 0.3)}
        if rng.rand() < 0.3:
            kw["restart_marker_blocks"] = int(rng.randint(1, 5))
        path = str(tmp_path / f"r{i}.jpg")
        img.save(path, **kw)
        assert_same(pipes, path)


SAMPLINGS = {
    "420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)), "411": ((4, 1), (1, 1), (1, 1)),
    "31": ((3, 1), (1, 1), (1, 1)), "22_21_12": ((2, 2), (2, 1), (1, 2)),
    "42_11_11": ((4, 2), (1, 1), (1, 1)),
}


@pytest.mark.parametrize("samp", sorted(SAMPLINGS))
def test_sampling_factors_and_edges_equal_jax(pipes, tmp_path, samp):
    sampling = SAMPLINGS[samp]
    rng = np.random.RandomState(len(samp))
    sizes = [(w, h) for w in (1, 2, 3, 17, 33) for h in (1, 2, 3, 17, 33)]
    for k, (w, h) in enumerate(sizes):
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        kw = {}
        if k % 3 == 1:
            kw["scans"] = [[0], [1], [2]]
        if k % 4 == 2:
            kw["restart"] = 1 + k % 3
        path = str(tmp_path / f"{samp}_{w}x{h}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg_bytes(rgb_to_ycc_planes(arr, sampling), size=(w, h),
                               sampling=sampling, **kw))
        got = assert_same(pipes, path)
        assert not isinstance(got, IOError) and got.shape == (h, w, 3)


def c_path_digests(paths):
    """SHA-256 (or None) of the JAX library's decode of each file with
    libjpeg-turbo's SIMD turned off, in a child process (the switch is read
    once, at the library's first use)."""
    code = (
        "import sys, json, hashlib\n"
        "from torch_port_util import jax_native_loader\n"
        "p = jax_native_loader().NativeImagePipe(n_threads=1)\n"
        "out = []\n"
        "for path in json.loads(sys.stdin.read()):\n"
        "    try: out.append(hashlib.sha256(p.decode(path).tobytes()).hexdigest())\n"
        "    except IOError: out.append(None)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, JSIMD_FORCENONE="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], input=json.dumps(paths),
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_out_of_range_idct_wraps_as_libjpegs_c_path(pipes, tmp_path):
    """Coefficients whose IDCT leaves [-512, 511]: the port equals the JAX
    library's default decode (libjpeg-turbo's SIMD IDCT, which saturates);
    libjpeg's C path, which wraps, differs on them."""
    t, j = pipes
    rng = np.random.RandomState(7)
    paths = []
    for i in range(12):
        coef = rng.randint(-1023, 1024, (2, 2, 64))
        coef[..., rng.rand(64) < 0.5] = 0
        path = str(tmp_path / f"wrap{i}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg_bytes(coefs=[coef], size=(16, 16), sampling=((1, 1),),
                               quant=[np.full(64, 1 + i % 4)], marker=None))
        paths.append(path)
    got = [sha(t.decode(p)) for p in paths]
    assert got == [sha(j.decode(p)) for p in paths]
    # the C path wraps instead
    assert sum(c != g for c, g in zip(c_path_digests(paths), got)) > 0


def test_truncated_and_corrupt_files_decide_like_jax(pipes, tmp_path):
    t, j = pipes
    rng = np.random.RandomState(11)
    arr = rng.randint(0, 256, (37, 45, 3)).astype(np.uint8)
    cases = []
    for kw in ({"subsampling": 2}, {"subsampling": 0, "restart_marker_blocks": 2},
               {"subsampling": 1, "optimize": True}):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=80, **kw)
        data = buf.getvalue()
        cases += [data[:cut] for cut in range(0, len(data), 41)]
        for _ in range(25):
            bad = bytearray(data)
            bad[rng.randint(2, len(data))] = rng.randint(256)
            cases.append(bytes(bad))
    paths = []
    for k, data in enumerate(cases):
        path = str(tmp_path / f"c{k}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    for path in paths:
        assert_same(pipes, path)


def test_batch_assembler_on_fixtures_with_threads_equals_jax(pipes):
    t, j = pipes
    decoded = [e for e in MANIFEST.values() if e["port"] not in ("refused", "fails")]
    paths = [os.path.join(REPO, e["path"]) for e in decoded]
    got, fails = t.load_batch(paths, 24, 20)
    want, jfails = j.load_batch(paths, 24, 20)
    assert fails == jfails == 0
    np.testing.assert_array_equal(got, want)
    # augmenting crops one pixel off each side (the pipeline's (swidth-1)
    # quirk), so the images a pixel or two wide are left out here
    paths = [p for p, e in zip(paths, decoded) if min(e["size"]) > 2]
    rng = np.random.RandomState(3)
    params = np.zeros((len(paths), 8), np.float32)
    params[:, :4] = rng.randint(-2, 1, (len(paths), 4))  # pad, never cut into
    params[:, 4] = rng.randint(0, 2, len(paths))
    params[:, 5:] = [0.05, 1.2, 0.9]
    got, fails = t.load_batch(paths, 24, 20, params)
    want, jfails = j.load_batch(paths, 24, 20, params)
    assert fails == jfails == 0
    np.testing.assert_array_equal(got, want)


def _size_from_a_held_fifo(pipe, tmp_path, data: bytes, sent: int):
    """pipe.image_size on a FIFO whose writer has sent data[:sent] and holds
    the rest back until the call returns: a probe that read the whole file
    would wait for ever, and is failed after 30 s."""
    import threading

    fifo = str(tmp_path / "held.fifo")
    os.mkfifo(fifo)
    done, answer = threading.Event(), {}

    def writer():
        with open(fifo, "wb") as f:
            f.write(data[:sent])
            f.flush()
            done.wait(60)
            try:
                f.write(data[sent:])
            except BrokenPipeError:  # the reader took the header and left
                pass

    def reader():
        try:
            answer["size"] = pipe.image_size(fifo)
        finally:
            done.set()

    threads = [threading.Thread(target=fn, daemon=True) for fn in (writer, reader)]
    for th in threads:
        th.start()
    threads[1].join(30)
    stuck = threads[1].is_alive()
    done.set()
    assert not stuck, "image_size read past the header"
    return answer["size"]


def test_image_size_reads_the_header_not_the_file(pipes, tmp_path):
    """image_size stops at the header, as libjpeg and libpng stop at SOF and
    IHDR: it answers from a FIFO that has sent only the file's start. A SOF
    behind a 60 KB APP1 segment, past the first piece the probe reads, is
    sized as the JAX library sizes it."""
    from fewshot_detection_tpu_torch.data.png import png_bytes

    t, j = pipes
    rng = np.random.RandomState(11)
    arr = rng.randint(0, 256, (300, 280, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95)
    photo = buf.getvalue()
    for data in (photo, png_bytes(arr)):
        assert len(data) > 100_000
        assert _size_from_a_held_fifo(t, tmp_path, data, 20_000) == (280, 300)
        os.remove(str(tmp_path / "held.fifo"))
    app1 = b"\xff\xe1" + (60_002).to_bytes(2, "big") + bytes(rng.randint(0, 256, 60_000))
    path = str(tmp_path / "big_app1.jpg")
    with open(path, "wb") as f:
        f.write(photo[:2] + app1 + photo[2:])
    assert t.image_size(path) == j.image_size(path) == (280, 300)
    np.testing.assert_array_equal(t.decode(path), j.decode(path))
