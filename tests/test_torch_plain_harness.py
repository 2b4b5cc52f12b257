"""The precision/recall harnesses of the PyTorch port (`eval/harness.py`,
`eval_torch.py`, `recall_torch.py`) against the JAX package's
`eval/harness.py`, on the CPU.

Precision, recall and F of `test_detector` (PlainDetector, and MetaDetector
with support batches) and `recall_list` equal the JAX package's to 1e-6
(they are ratios of counts of boxes that both sides keep). A random net
finds no object of the synthetic set, so the label files are rewritten
first: two of each image's own detections (a match) and one box where it
detected nothing (a miss)."""

import random
import re
import sys

import numpy as np
import pytest

from fewshot_detection_tpu.cli.common import resolve_configs as j_resolve
from fewshot_detection_tpu.data.datasets import MetaDataset as JMetaDataset
from fewshot_detection_tpu.eval import harness as j_harness
from fewshot_detection_tpu.eval.detector import MetaDetector as JMetaDetector
from fewshot_detection_tpu.eval.detector import PlainDetector as JPlainDetector
from fewshot_detection_tpu_torch.cli.common import resolve_configs
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.data.datasets import DetectionDataset, MetaDataset, get_labpath
from fewshot_detection_tpu_torch.eval import harness as t_harness
from fewshot_detection_tpu_torch.eval.detector import MetaDetector, PlainDetector
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes, nms

from synth import make_voc_like
from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import REPO, cfg, randomize_bn

sys.path.insert(0, REPO)
import eval_torch  # noqa: E402
import recall_torch  # noqa: E402

@pytest.fixture(scope="module")
def plain_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    d = make_voc_like(str(root / "voc"), n_images=12, seed=4)
    netcfg = str(root / "tiny_plain.cfg")
    with open(netcfg, "w") as f:
        f.write(TINY_PLAIN_CFG)
    datacfg = str(root / "plain.data")
    with open(datacfg, "w") as f:
        f.write(f"metayolo=0\ndata=voc\nnovel={REPO}/data/voc_novels.txt\nnovelid=None\n"
                f"train={d['train_list']}\nvalid={d['train_list']}\nmeta={d['traindict']}\n"
                f"backup={root}/backup\ngpus=0\n")
    spec = build_spec(parse_cfg(netcfg))
    params = init_params(spec, 2)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.45
    randomize_bn(params, np.random.default_rng(3))
    w = str(root / "plain.weights")
    weights_io.save_weights(w, [spec], [params])
    m = PlainDetector(netcfg, w, device="cpu")
    _, _, _, settings = resolve_configs(datacfg, netcfg)
    ds = DetectionDataset(d["train_list"], settings, shape=(m.width, m.height), shuffle=False,
                          train=False, filter_valid=False)
    found = []
    for imgs, _ in ds.batches(8, drop_last=False):
        found += get_region_boxes(m(imgs), 0.25, 20, m.region.anchor_wh)
    _write_labels(ds.lines, [[(b[6], b[:4]) for b in nms(boxes, 0.4)] for boxes in found])
    return dict(root=str(root), d=d, cfg=netcfg, datacfg=datacfg, weights=w)


def _write_labels(img_paths, found):
    """Label files of two found (class, box) pairs an image, and one box
    away from everything found."""
    for path, pairs in zip(img_paths, found):
        with open(get_labpath(path), "w") as f:
            for cls, (cx, cy, w, h) in pairs[:2]:
                f.write(f"{cls} {cx} {cy} {w} {h}\n")
            f.write("3 0.1 0.9 0.15 0.15\n")


def test_test_detector_and_eval_script_match_jax_for_the_plain_detector(plain_ws, capsys):
    _, _, _, jsettings = j_resolve(plain_ws["datacfg"], plain_ws["cfg"])
    want = j_harness.test_detector(JPlainDetector(plain_ws["cfg"], plain_ws["weights"]),
                                   plain_ws["d"]["train_list"], jsettings)
    (got,) = eval_torch.main(plain_ws["datacfg"], plain_ws["cfg"], [plain_ws["weights"]],
                             device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert 0 < want[0] < 1 and 0 < want[1] < 1  # matches and misses
    _, _, _, settings = resolve_configs(plain_ws["datacfg"], plain_ws["cfg"])
    direct = t_harness.test_detector(PlainDetector(plain_ws["cfg"], plain_ws["weights"],
                                                   device="cpu"),
                                     plain_ws["d"]["train_list"], settings, batch_size=5)
    np.testing.assert_allclose(direct, want, rtol=1e-6, atol=1e-9)  # batch size changes nothing


def test_recall_list_and_recall_script_match_jax(plain_ws, capsys):
    want = j_harness.recall_list(JPlainDetector(plain_ws["cfg"], plain_ws["weights"]),
                                 plain_ws["d"]["train_list"])
    wline = capsys.readouterr().out.strip().splitlines()[-1]
    got = recall_torch.main(plain_ws["cfg"], plain_ws["weights"], plain_ws["d"]["train_list"],
                            device="cpu")
    gline = capsys.readouterr().out.strip().splitlines()[-1]
    # "N IOU: x, Recall: x, Precision: x, Fscore: x"; the mean IoU of the
    # matches in float32 on either side
    assert re.sub(r"[\d.]+", "#", gline) == re.sub(r"[\d.]+", "#", wline)
    np.testing.assert_allclose([float(v) for v in re.findall(r"[\d.]+", gline)],
                               [float(v) for v in re.findall(r"[\d.]+", wline)], atol=2e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert 0 < want[1] < 1


def test_test_detector_matches_jax_for_the_meta_detector(tmp_path):
    """MetaDetector with one support batch per detection batch, drawn from
    one pinned `random.Random` on both sides."""
    d = make_voc_like(str(tmp_path / "voc"), n_images=22, classes_per_image=2, seed=3)
    datacfg = str(tmp_path / "meta.data")
    with open(datacfg, "w") as f:
        f.write("metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\nmeta={d['traindict']}\n"
                f"train={d['train_list']}\nvalid={d['train_list']}\nbackup={tmp_path}/b\ngpus=0\n")
    dk, ln = cfg("tiny_darknet_dynamic.cfg"), cfg("tiny_reweighting.cfg")
    data_options, darknet, learnet, settings = resolve_configs(datacfg, dk, ln)
    spec = MetaSpec(build_spec(darknet), build_spec(learnet))
    params = init_meta_params(spec, 5)
    for k in params:
        randomize_bn(params[k], np.random.default_rng(6))
    w = str(tmp_path / "meta.weights")
    weights_io.save_weights(w, [spec.darknet, spec.learnet], [params["darknet"], params["learnet"]])

    def supports(cls, opts, s):
        ms = cls(opts["meta"], s, train=False, num_replicas=1, rng=random.Random(7))
        return ms.batches(len(ms.classes))

    m = MetaDetector(darknet, learnet, w, device="cpu")
    ds = DetectionDataset(d["train_list"], settings, shape=(m.width, m.height), shuffle=False,
                          train=False, filter_valid=False)
    found, sup = [], supports(MetaDataset, data_options, settings)
    for imgs, _ in ds.batches(8, drop_last=False):  # the harness's batches
        rows = get_region_boxes(m(imgs, *next(sup)), 0.25, 1, m.region.anchor_wh)
        n_cls = len(rows) // imgs.shape[0]
        for i in range(imgs.shape[0]):  # the class of a row is its copy index
            found.append([(c, b[:4]) for c in range(n_cls)
                          for b in nms(rows[i * n_cls + c], 0.4)[:1]])
    _write_labels(ds.lines, found)

    jdo, jdk, jln, jsettings = j_resolve(datacfg, dk, ln)
    want = j_harness.test_detector(JMetaDetector(jdk, jln, w), d["train_list"], jsettings,
                                   meta_batches=supports(JMetaDataset, jdo, jsettings))
    got = t_harness.test_detector(m, d["train_list"], settings,
                                  meta_batches=supports(MetaDataset, data_options, settings))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert 0 < want[0] < 1 and 0 < want[1] < 1
