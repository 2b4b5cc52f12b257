"""`detect_torch.py` of the PyTorch port against the JAX package's
`detect.py`, on the CPU: random tiny-yolo-voc weights (scaled so the output
is not constant; the cfg cut to 160 px), one synthetic image. The same
boxes, in the same order, of the same classes, their printed confidences
within 1e-4 (convolution sums in another order move the class logits of the
random net by about 1e-6 of their size), and every pixel of predictions.jpg
equal (the corners are far from a pixel edge). The port always decodes and
NMS's through its device pipeline; `detect.py` is run both on its host path
and with FSD_DEVICE_NMS=1 (its buffer of 128 holds the 125 anchors of this
grid, so neither truncates)."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from torch_port_util import REPO, cfg, randomize_bn

sys.path.insert(0, REPO)
import detect as j_detect  # noqa: E402
import detect_torch as t_detect  # noqa: E402


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect")
    with open(cfg("tiny-yolo-voc.cfg")) as f:
        txt = f.read().replace("height=416", "height=160").replace("width=416", "width=160")
    netcfg = str(root / "tiny-yolo-voc.cfg")
    with open(netcfg, "w") as f:
        f.write(txt)
    spec = build_spec(parse_cfg(netcfg))
    params = init_params(spec, 0)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.45  # keep activations O(1) through the stack
    randomize_bn(params, np.random.default_rng(1))
    wpath = str(root / "tiny.weights")
    weights_io.save_weights(wpath, [spec], [params])
    ipath = str(root / "img.png")
    Image.fromarray(np.random.RandomState(3).randint(0, 255, (96, 128, 3), np.uint8)).save(ipath)
    # detect writes predictions.jpg into the working directory and reads
    # data/voc.names from it
    os.symlink(os.path.join(REPO, "data"), root / "data")
    return str(root), netcfg, wpath, ipath


def _detect(monkeypatch, capsys, root, fn, *args, **kw):
    """(printed lines but the timing one, the saved image's pixels)."""
    monkeypatch.chdir(root)
    capsys.readouterr()
    fn(*args, **kw)
    lines = [l for l in capsys.readouterr().out.splitlines() if "Predicted in" not in l]
    pixels = np.asarray(Image.open(os.path.join(root, "predictions.jpg")))
    os.remove(os.path.join(root, "predictions.jpg"))
    return lines, pixels


@pytest.mark.parametrize("variant,device_nms", [("pil", "0"), ("pil", "1"), ("cv2", "0")],
                         ids=["pil", "pil_device_nms", "cv2"])
def test_detect_prints_and_draws_what_detect_py_does(tiny_setup, monkeypatch, capsys, variant,
                                                     device_nms):
    if variant == "cv2":
        pytest.importorskip("cv2")
    root, netcfg, wpath, ipath = tiny_setup
    monkeypatch.setenv("FSD_DEVICE_NMS", device_nms)  # read by detect.py only
    want = _detect(monkeypatch, capsys, root, j_detect.VARIANTS[variant], netcfg, wpath, ipath)
    got = _detect(monkeypatch, capsys, root, t_detect.VARIANTS[variant], netcfg, wpath, ipath,
                  device="cpu")
    assert len(got[0]) == len(want[0])
    n_boxes = 0
    for g, w in zip(got[0], want[0]):
        name, _, conf = w.rpartition(": ")
        if name in _voc_names():
            assert g.rpartition(": ")[0] == name
            assert abs(float(g.rpartition(": ")[2]) - float(conf)) <= 1e-4
            n_boxes += 1
        else:
            assert g == w
    assert n_boxes > 2, "too few boxes for the comparison to mean anything"
    assert got[1].shape == want[1].shape and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("max_k", [None, 8], ids=["whole_grid", "overflow_host_path"])
def test_detect_boxes_are_the_host_paths(tiny_setup, monkeypatch, max_k):
    """`detect_pipeline` holds every anchor of the grid (125 here), so
    `detect_boxes` takes the device pipeline; past the kernel's limit (8
    here) an image with more candidates is redone on the host path. Either
    way the boxes are get_region_boxes + nms's."""
    from fewshot_detection_tpu_torch.eval.detector import PlainDetector
    from fewshot_detection_tpu_torch.ops import nms_device
    from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes, nms

    _, netcfg, wpath, _ = tiny_setup
    if max_k is not None:
        monkeypatch.setattr(nms_device, "MAX_K", max_k)
    m = PlainDetector(netcfg, wpath, device="cpu")
    x = np.random.RandomState(4).rand(m.height, m.width, 3).astype(np.float32)
    output = m(x[None])
    pipe = t_detect.detect_pipeline(m.region)
    assert (pipe.eval_boxes(output) is None) == (max_k is not None)
    got = t_detect.detect_boxes(m, pipe, output)
    want = nms(get_region_boxes(output, 0.5, m.region.num_classes, m.region.anchor_wh)[0], 0.4)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g[6] == w[6]
        np.testing.assert_allclose(g[:6], w[:6], rtol=0, atol=1e-6)


def _voc_names():
    with open(os.path.join(REPO, "data", "voc.names")) as f:
        return {l.strip() for l in f if l.strip()}


def test_skimage_variant_exists_and_needs_skimage(tiny_setup):
    assert t_detect.VARIANTS["skimage"] is t_detect.detect_skimage
    try:
        import skimage  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            t_detect.detect_skimage(*tiny_setup[1:], device="cpu")
