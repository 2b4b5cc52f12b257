"""`debug_torch.py` and `demo_torch.py` of the PyTorch port against the JAX
package's `debug.py` and `demo.py`, on the CPU.

- debug: the small plain cfg of tests/test_e2e_plain.py (96 px) from one
  `.weights` file, a painted PNG and its label file. The printed lines are
  the same; their numbers agree within 1e-4 of the largest value of the
  line's kind (convolution sums in another order: the output and the
  gradient maxima differ by about 1e-6 of their size), and the `<-- LARGE`
  marks are the same.
- demo: tiny-yolo-voc cut to 160 px from random weights (scaled so that
  boxes pass conf 0.5 but their sizes stay within the frame's order: at
  larger scales exp() of the box logits gives corners a million pixels out,
  whose integer parts float rounding moves), frames painted by a stubbed `cv2.VideoCapture` until it
  reports no frame; a stubbed `cv2` records each frame's rectangles, which
  must be the same, as must the printed lines. The port's boxes come from
  its device pipeline; `demo.py`'s from its host path.
- Without cv2 both print the same message and exit with code 2."""

import os
import re
import sys
import types

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import REPO, cfg, randomize_bn

sys.path.insert(0, REPO)
import debug as j_debug  # noqa: E402
import debug_torch as t_debug  # noqa: E402
import demo as j_demo  # noqa: E402
import demo_torch as t_demo  # noqa: E402

NUMBER = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def shape(line):
    """A printed line with its numbers and numpy's padding taken out."""
    return " ".join(NUMBER.sub("#", line).split())


def write_net(root, text, scale, seed=0):
    netcfg = str(root / "net.cfg")
    with open(netcfg, "w") as f:
        f.write(text)
    spec = build_spec(parse_cfg(netcfg))
    params = init_params(spec, seed)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * scale  # keep activations O(1) through the stack
    randomize_bn(params, np.random.default_rng(seed + 1))
    wpath = str(root / "net.weights")
    weights_io.save_weights(wpath, [spec], [params])
    return netcfg, wpath


@pytest.fixture(scope="module")
def debug_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("debug")
    netcfg, wpath = write_net(root, TINY_PLAIN_CFG, 2.0)
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    rng = np.random.RandomState(5)
    ipath = str(root / "images" / "scene.png")
    Image.fromarray(rng.randint(0, 255, (80, 112, 3), np.uint8)).save(ipath)
    np.savetxt(str(root / "labels" / "scene.txt"),
               [[3, 0.4, 0.5, 0.3, 0.2], [11, 0.7, 0.3, 0.2, 0.4]], fmt="%g")
    return netcfg, wpath, ipath


def printed(capsys, fn, *args, **kw):
    capsys.readouterr()
    fn(*args, **kw)
    return capsys.readouterr().out.splitlines()


def test_debug_prints_what_debug_py_does(debug_setup, capsys):
    netcfg, wpath, ipath = debug_setup
    want = printed(capsys, j_debug.main, netcfg, wpath, ipath)
    got = printed(capsys, t_debug.main, netcfg, wpath, ipath, device="cpu")
    assert len(got) == len(want) and any("nGT=2" in l for l in got)
    # the numbers of each kind of line: (printed numbers, the kind's scale)
    kinds = {}
    for g, w in zip(got, want):
        assert shape(g) == shape(w), (g, w)
        kind = "grad" if "|dw|max" in w else "line"
        gn = [float(v) for v in NUMBER.findall(g)]
        wn = [float(v) for v in NUMBER.findall(w)]
        kinds.setdefault(kind, []).append((gn, wn))
    assert len(kinds["grad"]) == 6  # five convs and the head
    for kind, pairs in kinds.items():
        scale = max(abs(v) for _, wn in pairs for v in wn)
        for gn, wn in pairs:
            np.testing.assert_allclose(gn, wn, rtol=1e-4, atol=1e-4 * scale)


def test_debug_refuses_to_run_without_a_card(debug_setup):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="GPU"):
        t_debug.main(*debug_setup)


class FakeCv2(types.ModuleType):
    """The calls the demo loops make: frames from a list, nearest-pixel
    resize, channel reversal, and the rectangles drawn on each frame."""

    COLOR_BGR2RGB = 4

    def __init__(self, frames):
        super().__init__("cv2")
        self.frames, self.drawn, self.shown = list(frames), [], 0

    def VideoCapture(self, index):
        cv = self

        class Capture:
            def isOpened(self):
                return index == 0

            def read(self):
                if not cv.frames:
                    return False, None
                cv.drawn.append([])
                return True, cv.frames.pop(0)

        return Capture()

    @staticmethod
    def resize(img, size):
        w, h = size
        ys = np.arange(h) * img.shape[0] // h
        xs = np.arange(w) * img.shape[1] // w
        return img[ys][:, xs]

    @staticmethod
    def cvtColor(img, code):
        return img[..., ::-1].copy()

    def rectangle(self, img, p1, p2, color, thickness):
        self.drawn[-1].append((p1, p2, color, thickness))

    def imshow(self, name, img):
        self.shown += 1

    def waitKey(self, delay):
        return 0


@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    with open(cfg("tiny-yolo-voc.cfg")) as f:
        text = f.read().replace("height=416", "height=160").replace("width=416", "width=160")
    return write_net(root, text, 2.0)


def run_demo(monkeypatch, capsys, fn, netcfg, wpath, **kw):
    rng = np.random.RandomState(9)
    frames = [rng.randint(0, 255, (120, 176, 3), np.uint8) for _ in range(3)]
    cv = FakeCv2(frames)
    monkeypatch.setitem(sys.modules, "cv2", cv)
    monkeypatch.chdir(REPO)  # the loops read data/voc.names
    lines = printed(capsys, fn, netcfg, wpath, **kw)
    return lines, cv.drawn, cv.shown


def test_demo_draws_what_demo_py_draws(demo_setup, monkeypatch, capsys):
    netcfg, wpath = demo_setup
    want = run_demo(monkeypatch, capsys, j_demo.demo, netcfg, wpath)
    got = run_demo(monkeypatch, capsys, t_demo.demo, netcfg, wpath, device="cpu")
    assert got == want
    lines, drawn, shown = got
    assert lines == ["------"] * 3 + ["Unable to read image"] and shown == 3
    assert sum(len(d) for d in drawn) > 2, "too few boxes for the comparison to mean anything"


def test_demo_without_cv2_exits_with_demo_pys_message(demo_setup, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 then raises ImportError
    out = []
    for fn in (j_demo.demo, t_demo.demo):
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            fn(*demo_setup)
        out.append((e.value.code, capsys.readouterr().out))
    assert out[0] == out[1] and out[0][0] == 2 and "OpenCV" in out[0][1]
