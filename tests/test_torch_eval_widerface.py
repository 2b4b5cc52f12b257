"""`scripts/eval_widerface_torch.py` against the JAX package's
`scripts/eval_widerface.py`, on the CPU.

- tiny-yolo-voc from the port's seeded init (BN statistics randomised; the
  activations stay small, so the two frameworks' float32 sums agree to the
  printed digits) over a painted WIDER tree: two sub-directories, PNG and
  JPEG images, one image over the omit limit. The box files are
  BYTE-IDENTICAL, the annotated images pixel-equal and stdout equal, though
  the JAX tool decodes and NMSes on the host and the port through its
  device pipeline (here the plain `nms_rows` on CPU tensors).
- yolo-voc, narrowed (every conv's filters / 16 but the head's: the same
  layers, reorg and route), at an odd multiple of 16: its reorg needs an even
  stride-16 grid, and both tools raise the same ValueError after the same
  line.
- The port's device pipeline at the tool's settings (a buffer of every
  anchor of the grid, conf 0.05, NMS 0.4) gives the host path's boxes,
  box for box, at every size of the tree.
- `draw_rectangle` is PIL's `ImageDraw.rectangle(outline=...)` pixel for
  pixel on fractional corners, boxes that run off the image, zero-width
  and zero-height boxes, and raises where Pillow raises."""

import contextlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.data.png import write_png
from fewshot_detection_tpu_torch.eval.detector import PlainDetector
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes, nms
from fewshot_detection_tpu_torch.utils.imaging import draw_rectangle

from torch_port_util import REPO, cfg, randomize_bn

PORT, JAX = "scripts/eval_widerface_torch.py", "scripts/eval_widerface.py"
# (sub-directory, file, (height, width)); the last is over 1024 * 2560 pixels
TREE = (("0--Parade", "p1.png", (64, 96)), ("0--Parade", "p2.jpg", (70, 130)),
        ("1--Handshaking", "h1.png", (100, 60)), ("1--Handshaking", "h2.png", (130, 200)),
        ("1--Handshaking", "big.png", (2576, 1040)))


def _run(script, argv):
    old = sys.argv
    sys.argv = [script, *argv]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.fixture(scope="module")
def wider(tmp_path_factory):
    root = tmp_path_factory.mktemp("wider")
    spec = build_spec(parse_cfg(cfg("tiny-yolo-voc.cfg")))
    params = randomize_bn(init_params(spec, 0), np.random.default_rng(1))
    wpath = str(root / "tiny.weights")
    weights_io.save_weights(wpath, [spec], [params])
    rng = np.random.RandomState(3)
    for sub, name, (h, w) in TREE:
        os.makedirs(root / "val" / sub, exist_ok=True)
        arr = rng.randint(0, 255, (h, w, 3), np.uint8) if h < 1000 else np.zeros((h, w, 3),
                                                                                 np.uint8)
        path = str(root / "val" / sub / name)
        if name.endswith(".png"):
            write_png(path, arr)
        else:
            Image.fromarray(arr).save(path)
    return str(root), wpath


def test_files_and_prints_equal_the_jax_tools(wider):
    root, wpath = wider
    val = os.path.join(root, "val")
    want = _run(JAX, [cfg("tiny-yolo-voc.cfg"), wpath, val, os.path.join(root, "jax")])
    got = _run(PORT, [cfg("tiny-yolo-voc.cfg"), wpath, val, os.path.join(root, "port"),
                      "--device", "cpu"])
    assert got.replace(os.path.join(root, "port"), "S") == want.replace(
        os.path.join(root, "jax"), "S")
    assert "omit big.png" in got and got.count("save plot results to") == 4
    n_boxes = 0
    for sub, name, _ in TREE[:-1]:
        stem = os.path.splitext(name)[0]
        with open(os.path.join(root, "jax", sub, stem + ".txt"), "rb") as f:
            want_txt = f.read()
        with open(os.path.join(root, "port", sub, stem + ".txt"), "rb") as f:
            assert f.read() == want_txt, name
        n_boxes += int(want_txt.split(b"\n")[0])
        a = np.asarray(Image.open(os.path.join(root, "jax", sub, name)))
        b = np.asarray(Image.open(os.path.join(root, "port", sub, name)))
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert not os.path.exists(os.path.join(root, "port", "1--Handshaking", "big.txt"))
    assert n_boxes > 20, "too few boxes for the comparison to mean anything"


def test_usage_without_four_arguments(wider):
    assert _run(PORT, ["a", "b"]).startswith("Usage: python scripts/eval_widerface_torch.py")


def _narrow_yolo_voc(path):
    with open(cfg("yolo-voc.cfg")) as f:
        txt = f.read()
    txt = re.sub(r"(?m)^filters=(\d+)$",
                 lambda m: m.group(0) if m.group(1) == "125" else f"filters={int(m.group(1)) // 16}",
                 txt)
    with open(path, "w") as f:
        f.write(txt)
    return path


@pytest.mark.parametrize("hw,raises", [((48, 80), True), ((64, 96), False)],
                         ids=["odd_multiple_of_16", "even"])
def test_yolo_voc_reorg_decides_as_the_jax_tool(tmp_path, hw, raises):
    """sw, sh = 80, 48: the stride-16 grid is 5 x 3, and reorg refuses it in
    both packages; 96 x 64 passes in both. No weights file: both nets stay
    at their own init, which the decision does not depend on."""
    netcfg = _narrow_yolo_voc(str(tmp_path / "yolo-voc-narrow.cfg"))
    val = tmp_path / "val" / "0--Parade"
    val.mkdir(parents=True)
    write_png(str(val / "x.png"), np.full((*hw, 3), 90, np.uint8))
    outs = []
    for script, extra in ((JAX, []), (PORT, ["--device", "cpu"])):
        old = sys.argv
        sys.argv = [script, netcfg, "", str(tmp_path / "val"), str(tmp_path / script[8:11]),
                    *extra]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out), \
                    (pytest.raises(ValueError) if raises else contextlib.nullcontext()):
                runpy.run_path(os.path.join(REPO, script), run_name="__main__")
        finally:
            sys.argv = old
        outs.append(out.getvalue().splitlines()[0])
    assert outs[0] == outs[1] == f"x.png {hw[1]} {hw[0]} {hw[1]} {hw[0]}"


def test_device_pipeline_gives_the_host_paths_boxes(wider):
    """The tool's pipeline (every anchor of the grid in the buffer) against
    get_region_boxes + nms on the same raw output, at each image's size."""
    root, wpath = wider
    tool = runpy.run_path(os.path.join(REPO, PORT), run_name="not_main")
    m = PlainDetector(cfg("tiny-yolo-voc.cfg"), wpath, device="cpu")
    rng = np.random.RandomState(4)
    for _, _, (h, w) in TREE[:-1]:
        sh, sw = round(h / 16) * 16, round(w / 16) * 16
        output = m(rng.rand(1, sh, sw, 3).astype(np.float32))
        pipe = tool["detect_pipeline"](m, output)
        assert pipe.top_k == 5 * output.shape[1] * output.shape[2]
        got = pipe.eval_boxes(output)[0]
        want = nms(get_region_boxes(output, 0.05, 20, m.region.anchor_wh)[0], 0.4)
        assert got == want and 0 < len(got) < pipe.top_k


def _pil(size, xy, color=(255, 0, 0)):
    img = Image.new("RGB", size, (10, 20, 30))
    ImageDraw.Draw(img).rectangle(xy, outline=color)
    return np.asarray(img)


def test_draw_rectangle_is_pils():
    rng = np.random.default_rng(5)
    cases = [(0.5, 0.5, 3.7, 2.2), (-3.5, -2.0, 4.9, 9.9), (2.0, 1.0, 2.0, 6.5),
             (1.0, 3.0, 6.0, 3.0), (4.0, 4.0, 4.0, 4.0), (-0.9, -0.9, -0.1, -0.1),
             (7.5, 1.0, 30.0, 2.0), (1.0, 1.0, 2.0, 2.0), (-9.0, 8.0, -1.0, 11.0)]
    for _ in range(3000):
        x0, y0 = rng.uniform(-6, 14, 2)
        w, h = rng.uniform(0, 10, 2) * (rng.random(2) > 0.15)
        cases.append((x0, y0, x0 + w, y0 + h))
    for xy in cases:
        want = _pil((9, 7), list(xy))
        got = np.full((7, 9, 3), (10, 20, 30), np.uint8)
        draw_rectangle(got, xy)
        assert np.array_equal(got, want), xy
    for bad in ((3.0, 0.0, 2.9, 1.0), (0.0, 3.0, 1.0, 2.5)):
        with pytest.raises(ValueError):
            _pil((9, 7), list(bad))
        with pytest.raises(ValueError):
            draw_rectangle(np.zeros((7, 9, 3), np.uint8), bad)
