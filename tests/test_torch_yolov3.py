"""YOLOv3 on the port: `cfg/yolov3.cfg` as published, the [upsample] and
[yolo] layers of `models/spec.py` and `models/darknet.py`, the loss of
`ops/yolo_loss.py` and `PlainTrainer` with it, each held against the plain
reference `tests/yolov3_ref.py` (a byte copy of the benchmark's
`benchmark/reference/yolov3.py`), on the CPU at a tiny size; the plain
CLI on such a cfg; the benchmark's cell at a tiny size through
`benchmark/run.py`; and, on the card, one traced step.

Stated bounds. Float32, port against reference: the heads and the loss
to 1e-5 relative and every gradient leaf to 5e-5 of the leaf's largest
magnitude (measured up to 7e-6: the two forwards sum their convolutions in
other orders, channels-last against NCHW, and the port's CPU batch norm
sums in float64, so the last bits differ and grow through 19 layers and
the loss's thousands of terms). The loss cases are exact to float32
rounding (1e-6), and the reference gives the same numbers.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import types

import numpy as np
import pytest
import torch

import yolov3_ref as ref
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.config.darkcfg import propagate_shapes
from fewshot_detection_tpu_torch.models.convert import require_grads
from fewshot_detection_tpu_torch.models.darknet import apply_network
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops.yolo_loss import yolo_loss
from fewshot_detection_tpu_torch.train import PlainTrainer, init_momentum
from fewshot_detection_tpu_torch.utils import format_loss_line
from fewshot_detection_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "yolov3_coco.train_b64_608"
ANCHORS = "4,5,  8,10,  12,9,  16,22,  30,24,  40,44"


def _conv(filters, size, stride=1, bn=True, act="leaky"):
    return (f"[convolutional]\n{'batch_normalize=1' + chr(10) if bn else ''}filters={filters}\n"
            f"size={size}\nstride={stride}\npad=1\nactivation={act}\n")


def _yolo(mask, classes):
    return (f"[yolo]\nmask = {mask}\nanchors = {ANCHORS}\nclasses={classes}\nnum=6\njitter=.3\n"
            "ignore_thresh = .7\ntruth_thresh = 1\nrandom=1\n")


def tiny_cfg(classes=4, size=64) -> str:
    """The published cfg's kinds at a tiny size: two residual stages, a
    downsampling conv, a head at 1/8 of the input, then route back,
    upsample, a two-source route and a head at 1/4."""
    out = 3 * (5 + classes)
    blocks = [
        "[net]\nbatch=4\nsubdivisions=1\n"
        f"width={size}\nheight={size}\nchannels=3\nmomentum=0.9\ndecay=0.0005\n"
        "learning_rate=0.001\nburn_in=0\nmax_batches=2\npolicy=steps\nsteps=80,90\n"
        "scales=.1,.1\n",
        _conv(8, 3), _conv(16, 3, 2), _conv(8, 1), _conv(16, 3),
        "[shortcut]\nfrom=-3\nactivation=linear\n",
        _conv(32, 3, 2), _conv(16, 1), _conv(32, 3),
        "[shortcut]\nfrom=-3\nactivation=linear\n",
        _conv(64, 3, 2), _conv(32, 1), _conv(out, 1, bn=False, act="linear"),
        _yolo("3,4,5", classes),
        "[route]\nlayers = -3\n", _conv(16, 1), "[upsample]\nstride=2\n",
        "[route]\nlayers = -1, 8\n", _conv(32, 3), _conv(out, 1, bn=False, act="linear"),
        _yolo("0,1,2", classes),
    ]
    return "\n".join(blocks)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("yolov3") / "tiny_yolov3.cfg")
    with open(path, "w") as f:
        f.write(tiny_cfg())
    return path


def _seeded(path, size, seed=7, device="cpu"):
    """(reference layers, reference params, the port's params with the
    same values), from the benchmark's seeded weights."""
    from benchmark.common.painting import seeded_weights
    from benchmark.drivers.train import port_tree

    layers = ref.walk(ref.parse(path), size)
    nets = {"darknet": layers}
    w = seeded_weights(nets, seed, device)["darknet"]
    tree = require_grads(port_tree(nets, seeded_weights(nets, seed, device), "plain"))
    return layers, w, tree


def _targets(n, seed, classes=4, most=7):
    """(n, 50, 5) packed truths, 1 to `most` an image, one image with a
    second truth on its first truth's prediction (another class)."""
    rng = np.random.default_rng(seed)
    target = torch.zeros(n, 50, 5)
    for b in range(n):
        for s in range(int(rng.integers(1, most + 1))):
            bw, bh = rng.uniform(0.05, 0.7, 2)
            target[b, s] = torch.tensor([rng.integers(classes), rng.uniform(bw / 2, 1 - bw / 2),
                                         rng.uniform(bh / 2, 1 - bh / 2), bw, bh])
    k = int((target[0, :, 1] > 0).sum())
    target[0, k] = target[0, 0]
    target[0, k, 0] = (target[0, 0, 0] + 1) % classes
    return target


# -- the published cfg --------------------------------------------------------


def test_the_published_cfg_compiles_to_yolov3():
    path = os.path.join(REPO, "cfg", "yolov3.cfg")
    blocks = parse_cfg(path)
    spec = build_spec(blocks)
    kinds = [l.kind for l in spec.layers]
    assert len(spec.layers) == 107 and kinds.count("conv") == 75
    assert sum(l.kind == "conv" and l.batch_normalize for l in spec.layers) == 72
    assert kinds.count("shortcut") == 23 and kinds.count("upsample") == 2
    assert [l.index for l in spec.layers if l.kind == "conv" and l.stride == 2] == [1, 5, 12, 37,
                                                                                   62]
    assert [l.sources for l in spec.layers if l.kind == "route"] == [(79,), (85, 61), (91,),
                                                                     (97, 36)]
    assert all(l.sources == (l.index - 3, l.index - 1) for l in spec.layers
               if l.kind == "shortcut")
    heads = [l.index for l in spec.layers if l.kind == "yolo"]
    assert heads == [82, 94, 106]
    assert [spec.layers[i - 1].out_channels for i in heads] == [255] * 3
    assert all(not spec.layers[i - 1].batch_normalize and spec.layers[i - 1].bias for i in heads)
    shapes = propagate_shapes(blocks)
    assert [(shapes[i].width, shapes[i].height, shapes[i].filters) for i in heads] == [
        (19, 19, 255), (38, 38, 255), (76, 76, 255)]
    assert [(shapes[i].width, shapes[i].filters) for i in (36, 61, 74)] == [(76, 256), (38, 512),
                                                                             (19, 1024)]
    assert [h.mask for h in spec.yolo_heads] == [(6, 7, 8), (3, 4, 5), (0, 1, 2)]
    for h in spec.yolo_heads:
        assert h.anchor_wh == ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
                               (116, 90), (156, 198), (373, 326))
        assert (h.num_classes, h.num, h.ignore_thresh, h.truth_thresh) == (80, 9, 0.7, 1.0)
    net = blocks[0]
    assert {k: net[k] for k in ("batch", "subdivisions", "width", "height", "momentum", "decay",
                                "learning_rate", "burn_in", "max_batches", "policy", "steps",
                                "scales")} == {
        "batch": "64", "subdivisions": "16", "width": "608", "height": "608", "momentum": "0.9",
        "decay": "0.0005", "learning_rate": "0.001", "burn_in": "1000", "max_batches": "500200",
        "policy": "steps", "steps": "400000,450000", "scales": ".1,.1"}
    assert {k: blocks[83][k] for k in ("jitter", "random")} == {"jitter": ".3", "random": "1"}


def test_the_reference_agrees_on_the_published_cfg_and_its_flops():
    from benchmark.drivers import train_yolo3

    layers = ref.walk(ref.parse(os.path.join(REPO, "cfg", "yolov3.cfg")))
    spec = build_spec(parse_cfg(os.path.join(REPO, "cfg", "yolov3.cfg")))
    assert [l.kind for l in layers] == [l.kind for l in spec.layers]
    assert [l.c_out for l in layers if l.kind == "conv"] == [
        l.out_channels for l in spec.layers if l.kind == "conv"]
    # darknet prints 140.692 BFLOPs for the cfg at 608; a step is about three times that
    fwd = sum(2 * l.side_out ** 2 * l.c_in * l.c_out * l.size ** 2 for l in layers
              if l.kind == "conv")
    assert round(fwd / 1e9, 3) == 140.692
    first = 2 * 608 * 608 * 3 * 32 * 9
    assert train_yolo3.step_flops(layers, 64) == 64 * (3 * fwd - first)
    assert len(train_yolo3.bn_layers(layers, 64)) == 72


@pytest.mark.parametrize("pair", [("tests/yolov3_ref.py", "benchmark/reference/yolov3.py"),
                                  ("cfg/yolov3.cfg", "benchmark/configs/cfg/yolov3.cfg")])
def test_the_benchmarks_copies_are_byte_identical(pair):
    a, b = (open(os.path.join(REPO, p), "rb").read() for p in pair)
    assert a == b


# -- the port against the reference in float32 -------------------------------


@pytest.mark.parametrize("size", [64, 96])
def test_heads_loss_and_gradients_meet_the_reference(tiny, size):
    layers, w, tree = _seeded(tiny, size)
    spec = build_spec(parse_cfg(tiny))
    x = torch.rand(4, size, size, 3, generator=torch.Generator().manual_seed(size))
    target, keep = _targets(4, size), torch.ones(4)

    heads, _ = apply_network(spec, tree, x, train=True)
    want = ref.forward(layers, w, x, train=True)
    assert [tuple(h.shape) for h in heads] == [(4, size // 8, size // 8, 27),
                                               (4, size // 4, size // 4, 27)]
    for a, b in zip(heads, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    trainer = PlainTrainer(spec, device="cpu")
    loss, grads, _, metrics = trainer.loss_and_grads(
        tree, {"x": x[None], "target": target[None], "keep": keep[None]}, seen=64)
    names = [(i, k) for i, p in w.items() for k in p if k not in ("mean", "var")]
    for i, k in names:
        w[i][k].requires_grad_(True)
    got = ref.yolo_loss(ref.forward(layers, w, x, train=True), layers, target, keep,
                        (size, size))
    assert float(loss) == pytest.approx(float(got.detach()), rel=1e-5)
    assert float(metrics["nGT"]) == float((target[:, :, 1] > 0).sum())
    assert int(metrics["positives"].sum()) > 0
    ref_grads = torch.autograd.grad(got, [w[i][k] for i, k in names])
    for (i, k), g in zip(names, ref_grads):
        mine = grads[i]["bn"][k] if k in ("gamma", "beta") else grads[i][k]
        assert (mine - g).abs().max() <= 5e-5 * g.abs().max(), (i, k)


# -- the loss, case by case (the tiny cfg's heads: 8x8 of anchors 3-5 and
# 16x16 of anchors 0-2 at 64 px, 4 classes) -------------------------------


def _loss(tiny, target, logits=None):
    """(loss, metrics, gradient of each head) of the port and the
    reference's loss and head gradients, for heads of zero logits with
    `logits` {(head, b, j, i, a, channel): value} written in."""
    spec = build_spec(parse_cfg(tiny))
    layers = ref.walk(ref.parse(tiny), 64)
    heads = [torch.zeros(1, 8, 8, 27), torch.zeros(1, 16, 16, 27)]
    for (h, b, j, i, a, c), v in (logits or {}).items():
        heads[h][b, j, i, a * 9 + c] = v
    target = torch.tensor(target, dtype=torch.float32).reshape(1, -1, 5)
    target = torch.cat([target, torch.zeros(1, 50 - target.shape[1], 5)], 1)
    keep = torch.ones(1)
    mine = [h.clone().requires_grad_(True) for h in heads]
    loss, metrics = yolo_loss(mine, target, keep, spec.yolo_heads, (64, 64))
    grads = torch.autograd.grad(loss, mine)
    theirs = [h.clone().requires_grad_(True) for h in heads]
    want = ref.yolo_loss(theirs, layers, target, keep, (64, 64))
    for a, b in zip(grads, torch.autograd.grad(want, theirs)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-6)
    return loss, metrics, [g.reshape(g.shape[1], g.shape[2], 3, 9) for g in grads]


N_PRED = 3 * (8 * 8 + 16 * 16)


def test_each_truth_goes_to_its_best_anchor_over_both_heads(tiny):
    # 16x22 px is anchor 3 (the coarse head's first), 8x10 px anchor 1
    # (the fine head's second)
    _, metrics, (g0, g1) = _loss(tiny, [[2, 0.30, 0.70, 16 / 64, 22 / 64],
                                        [1, 0.55, 0.20, 8 / 64, 10 / 64]])
    assert metrics["positives"].tolist() == [1, 1]
    # a gradient on the box terms at exactly the predictions they take
    assert torch.nonzero(g0[..., 0]).tolist() == [[int(0.70 * 8), int(0.30 * 8), 0]]
    assert torch.nonzero(g1[..., 0]).tolist() == [[int(0.20 * 16), int(0.55 * 16), 1]]
    assert float(g0[5, 2, 0, 5 + 2]) == pytest.approx(-0.5)  # class 2's bit


def test_predictions_that_overlap_a_truth_above_the_threshold_lose_the_no_object_term(tiny):
    # a 30x24 px truth at the centre of coarse cell (3, 4) takes anchor 4;
    # anchor 5 there predicts the same box (IoU 1) and anchor 3 a box of
    # 0.6 of its width (IoU 0.6)
    truth = [0, 3.5 / 8, 4.5 / 8, 30 / 64, 24 / 64]
    logits = {(0, 0, 4, 3, 2, 2): math.log(30 / 40), (0, 0, 4, 3, 2, 3): math.log(24 / 44),
              (0, 0, 4, 3, 0, 2): math.log(0.6 * 30 / 16), (0, 0, 4, 3, 0, 3): math.log(24 / 22)}
    loss, metrics, (g0, _) = _loss(tiny, [truth], logits)
    assert int(metrics["ignored"]) == 1 and metrics["positives"].tolist() == [1, 0]
    assert float(metrics["loss_conf"].detach()) == pytest.approx((N_PRED - 1) * math.log(2.0),
                                                                 rel=1e-6)
    assert float(g0[4, 3, 2, 4]) == 0.0  # anchor 5: no objectness gradient
    assert float(g0[4, 3, 0, 4]) == pytest.approx(0.5)  # anchor 3: pushed to 0
    assert float(g0[4, 3, 1, 4]) == pytest.approx(-0.5)  # anchor 4: pushed to 1


@pytest.mark.parametrize("w, h, a, aw, ah", [(28, 26, 1, 30, 24), (44, 40, 2, 40, 44)])
def test_box_terms_scale_by_two_less_the_truths_area(tiny, w, h, a, aw, ah):
    """A 28x26 px truth takes anchor 4 (30x24), a 44x40 one anchor 5."""
    x, y, w, h = 0.43, 0.61, w / 64, h / 64
    _, metrics, (g0, _) = _loss(tiny, [[1, x, y, w, h]])
    s = 2 - w * h
    i, j = int(x * 8), int(y * 8)
    tx, ty = x * 8 - i, y * 8 - j
    tw, th = math.log(w * 64 / aw), math.log(h * 64 / ah)
    # at a zero logit BCE is log 2 whatever the target; its gradient is 1/2 - t
    assert float(metrics["loss_x"].detach()) == pytest.approx(s * math.log(2.0), rel=1e-6)
    assert float(metrics["loss_w"].detach()) == pytest.approx(s * tw * tw / 2, rel=1e-5)
    assert float(metrics["loss_h"].detach()) == pytest.approx(s * th * th / 2, rel=1e-5)
    assert float(g0[j, i, a, 0]) == pytest.approx(s * (0.5 - tx), rel=1e-5)
    assert float(g0[j, i, a, 1]) == pytest.approx(s * (0.5 - ty), rel=1e-5)
    assert float(g0[j, i, a, 2]) == pytest.approx(-s * tw, rel=1e-5)
    assert float(g0[j, i, a, 3]) == pytest.approx(-s * th, rel=1e-5)


def test_a_second_truth_on_one_prediction_replaces_the_box_and_adds_its_class(tiny):
    first = [1, 0.30, 0.30, 30 / 64, 24 / 64]
    second = [3, 0.34, 0.33, 31 / 64, 23 / 64]  # same cell (2, 2), same anchor 4
    _, metrics, (g0, _) = _loss(tiny, [first, second])
    assert metrics["positives"].tolist() == [1, 0]
    s = 2 - second[3] * second[4]
    assert float(g0[2, 2, 1, 0]) == pytest.approx(s * (0.5 - (0.34 * 8 - 2)), rel=1e-5)
    assert float(g0[2, 2, 1, 1]) == pytest.approx(s * (0.5 - (0.33 * 8 - 2)), rel=1e-5)
    assert g0[2, 2, 1, 5:].tolist() == pytest.approx([0.5, -0.5, 0.5, -0.5])
    assert int(metrics["nGT"]) == 2


def test_a_truth_whose_best_anchor_no_head_predicts_is_left_out():
    """Anchor 5 in no mask: its truth takes no prediction (darknet's
    `int_index` gives -1) and the other truth is scored as alone."""
    from fewshot_detection_tpu_torch.models.spec import YoloSpec

    anchors = tuple(float(v) for v in ANCHORS.split(","))
    specs = [YoloSpec(mask=(3, 4), anchors=anchors, num_classes=4, num=6, ignore_thresh=0.7),
             YoloSpec(mask=(0, 1, 2), anchors=anchors, num_classes=4, num=6, ignore_thresh=0.7)]
    heads = [torch.zeros(1, 8, 8, 18, requires_grad=True),
             torch.zeros(1, 16, 16, 27, requires_grad=True)]
    target = torch.zeros(1, 50, 5)
    target[0, 0] = torch.tensor([1, 0.5, 0.5, 40 / 64, 44 / 64])  # anchor 5
    target[0, 1] = torch.tensor([2, 0.3, 0.3, 8 / 64, 10 / 64])  # anchor 1
    loss, metrics = yolo_loss(heads, target, torch.ones(1), specs, (64, 64))
    loss.backward()
    assert metrics["positives"].tolist() == [0, 1] and int(metrics["nGT"]) == 2
    assert float(metrics["loss_x"].detach()) == pytest.approx((2 - 80 / 64 ** 2) * math.log(2.0))
    assert int(torch.count_nonzero(heads[0].grad.reshape(8, 8, 2, 9)[..., :4])) == 0


# -- the trainer's span and the CLI -----------------------------------------


def test_a_step_opens_train_loss_once_a_group_with_host_counts(tiny):
    layers, _, tree = _seeded(tiny, 64)
    spec = build_spec(parse_cfg(tiny))
    trainer = PlainTrainer(spec, device="cpu")
    mom = init_momentum(tree)
    x = torch.rand(2, 2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    batch = {"x": x, "target": _targets(4, 2).reshape(2, 2, 50, 5), "keep": torch.ones(2, 2)}
    with prof.recording() as spans:
        tree, mom, metrics = trainer.step(tree, mom, batch, seen=64, lr=1e-3)
        line = format_loss_line(64, metrics)
    loss = [s for s in spans if s.name == "train.loss"]
    assert [spans[s.parent].name for s in loss] == ["train.forward"] * 2
    assert all(s.counts == {"heads": 2, "predictions": 2 * 3 * (8 * 8 + 16 * 16),
                            "truth_rows": 100} for s in loss)
    pos = metrics["positives"].tolist()
    assert line.endswith(f", positives {pos[0]}/{pos[1]}, ignored {int(metrics['ignored'])}")


def test_train_torch_trains_the_tiny_cfg_on_coco_like_files(tmp_path, monkeypatch):
    from fewshot_detection_tpu_torch.cli import train_plain_cli
    from fewshot_detection_tpu_torch.data import synth
    from fewshot_detection_tpu_torch.models import weights_io
    from fewshot_detection_tpu_torch.models.darknet import init_params

    d = synth.make_coco_like(str(tmp_path / "coco"), [0, 1, 2, 3, 4, 5, 6, 7], seed=1, n_train=8)
    cfg = str(tmp_path / "tiny_yolov3_coco.cfg")
    with open(cfg, "w") as f:
        f.write(tiny_cfg(classes=80))
    data = str(tmp_path / "coco.data")
    with open(data, "w") as f:
        f.write(f"metayolo=0\ndata=coco\nneg=1\nrand=0\nscale=0\nnovelid=None\n"
                f"novel={REPO}/data/coco_novels.txt\ntrain={d['train_list']}\n"
                f"valid={d['valid_list']}\nbackup={tmp_path}/backup\ngpus=0\n")
    spec = build_spec(parse_cfg(cfg))
    params = init_params(spec, 0)
    init_w = str(tmp_path / "init.weights")
    weights_io.save_weights(init_w, [spec], [params], seen=0)
    for name in ("FSD_DTYPE", "FSD_WORKERS", "FSD_NATIVE", "FSD_CLIP_NORM", "FSD_INPUT_U8"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(train_plain_cli, "time", types.SimpleNamespace(time=lambda: 1234.0))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trained = train_plain_cli.main(data, cfg, init_w, device="cpu")
    lines = [l for l in out.getvalue().splitlines() if ": nGT " in l]
    assert len(lines) == 4 and all(", positives " in l for l in lines)
    assert all(math.isfinite(float(l.split("total ")[1].split(",")[0])) for l in lines)
    w0 = torch.from_numpy(np.ascontiguousarray(params[0]["w"].transpose(3, 2, 0, 1)))
    assert not torch.equal(trained[0]["w"].detach(), w0)  # it trained


# -- the benchmark's cell at a tiny size ---------------------------------------


def _tiny_root(root: str) -> str:
    """A checkout in miniature for the cell: the repo's BENCHMARK.json,
    limits and readers; the cell's configuration on the tiny cfg (4
    classes, 64 px) and its mix at batch 4, under the SAME names."""
    b = os.path.join(root, "benchmark")
    for sub in ("limits", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub), os.path.join(b, sub))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.makedirs(os.path.join(b, "configs", "cfg"))
    os.makedirs(os.path.join(b, "traffic"))
    with open(os.path.join(b, "configs", "cfg", "yolov3.cfg"), "w") as f:
        f.write(tiny_cfg())
    with open(os.path.join(REPO, "benchmark", "configs", "yolov3_coco.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "benchmark", "traffic", "train_b64_608.json")) as f:
        mix = json.load(f)
    mix.update(batch=4, size=64, pool=3, max_objects=6, warmup_steps=1, profiled_steps=2,
               object_sides=[[0.41, 1, 8], [0.34, 8, 24], [0.25, 24, 40]])
    for name, data in (("configs/yolov3_coco.json", dict(config, classes=4)),
                       ("traffic/train_b64_608.json", mix)):
        with open(os.path.join(b, name), "w") as f:
            json.dump(data, f)
    return root


def _run_cell(root, **kw):
    spec = importlib.util.spec_from_file_location(
        "bench_helpers", os.path.join(REPO, "benchmark", "tests", "helpers.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    return helpers.run_cell(root, CELL, **kw)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_the_cpu_and_loads_no_jax(tmp_path, trace):
    result, status = _run_cell(_tiny_root(str(tmp_path)), trace=trace)
    assert status == {"rc": 0, "banned": []}
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"grad_median_gap", "delta_median_gap.2",
                                     "delta_leaf_gap.1"}
    if trace:
        # no kernel on the CPU: the device readers and the loss's stay silent
        assert not any(k.startswith(("device_idle", "conv_", "bn_sums_", "yolo_loss"))
                       for k in result["metrics"])
        assert "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == {"train_img_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_planted_fault_turns_the_cell_incorrect(tmp_path, fault):
    result, status = _run_cell(_tiny_root(str(tmp_path)), fault=fault)
    assert status["rc"] == 0
    assert result["correct"] is False, result["checks"]


LEAF_FAULT = """
import json, sys
sys.path[:0] = [{repo!r}]
import torch
from fewshot_detection_tpu_torch.train import trainer

original = trainer.sgd_update


def sgd_update(params, grads, mom, lr, **kw):
    leaves = [params[i]["bn"][k] if k in ("gamma", "beta") else params[i][k]
              for i, k in {leaves!r}]
    before = [t.detach().clone() for t in leaves]
    out = original(params, grads, mom, lr, **kw)
    with torch.no_grad():
        for t, b in zip(leaves, before):
            t.copy_(b if {how!r} == "unmoved" else 2 * t - b)
    return out


trainer.sgd_update = sgd_update
from benchmark import run
rc = run.main({argv!r}, device="cpu", root={root!r})
print("RC " + json.dumps({{"rc": rc}}))
"""


@pytest.mark.parametrize("leaves,how", [
    ([(18, "b")], "unmoved"),                 # the second head's bias
    ([(14, "gamma"), (14, "beta")], "unmoved"),  # a BN affine pair that moves less than the median leaf
    ([(9, "w")], "twice"),
])
def test_a_leaf_left_unmoved_or_moved_twice_turns_the_cell_incorrect(tmp_path, leaves, how):
    """The worst leaf's first change, each leaf against its own, reads 1
    for a leaf the update leaves out or moves twice, whatever its size."""
    import subprocess
    import sys

    root = _tiny_root(str(tmp_path))
    argv = ["--workload", CELL, "--seed", "2147483900", "--seconds", "1", "--trace", "0"]
    code = LEAF_FAULT.format(repo=REPO, leaves=leaves, how=how, argv=argv, root=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"), cwd=root)
    lines = out.stdout.strip().splitlines()
    assert lines and lines[-1] == 'RC {"rc": 0}', out.stderr[-3000:]
    result = json.loads(lines[-2])
    assert result["correct"] is False
    # 1, give or take the leaf's own bfloat16 gap of a sound step (thousandths here)
    assert result["checks"]["delta_leaf_gap.1"]["value"] == pytest.approx(1.0, abs=0.02)
    assert result["checks"]["grad_median_gap"]["value"] <= result["checks"]["grad_median_gap"]["limit"]


def test_the_calibration_reads_the_cell_with_its_own_driver(tmp_path, capsys):
    """`benchmark/calibrate_yolo3.py` on the tiny cell: a program line with
    each step's worst leaf, and the control's and the half batch's lines,
    without changing `calibrate.py`'s module."""
    import sys

    root = _tiny_root(str(tmp_path))
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmark import calibrate, calibrate_yolo3

    before = calibrate.train_readings
    rc = calibrate_yolo3.main(["--workload", CELL, "--seeds", "2147483901",
                               "--controls", "2147483902", "--control", "fp8",
                               "--dump", str(tmp_path / "dump")], device="cpu", root=root)
    assert rc == 0 and calibrate.train_readings is before
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [l["kind"] for l in lines] == ["program", "control_fp8", "fault_half_batch"]
    program = lines[0]
    assert program["delta_leaf_gap.1"] < 0.5 and program["delta_worst_leaf.1"].startswith("darknet.")
    with open(tmp_path / "dump" / "2147483901.json") as f:
        dump = json.load(f)
    assert set(dump["program"]["grad"]) == set(dump["reference"]["grad"])
    assert len(dump["program"]["deltas"]) == 3


def test_the_loss_reader_gives_device_ms_a_step():
    spec = importlib.util.spec_from_file_location(
        "yolo_loss_ms", os.path.join(REPO, "benchmark", "metrics", "yolo_loss_ms.train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"kind": "train", "loss_device_s": 0.05, "loss_steps": 5}) == \
        pytest.approx(10.0)
    assert mod.read({"kind": "train", "loss_device_s": None, "loss_steps": 5}) is None
    assert mod.read({"kind": "train"}) is None  # a program without the span


def test_loss_kernels_are_put_to_the_span_open_at_their_launch(monkeypatch):
    """`train_yolo3.loss_stretch` on a made-up trace: two kernels launched
    inside `train.loss` (one running long after), one inside its parent,
    one with no launch; the spin warm-up left out."""
    from benchmark.drivers import train_yolo3

    base = 1_000_000_000
    spans = [types.SimpleNamespace(name="train.forward", start=base + 10_000, end=base + 50_000),
             types.SimpleNamespace(name="train.loss", start=base + 30_000, end=base + 40_000)]

    def x(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [x("kernel", "at::cuda::spin_kernel", 0, 5, 1), x("cuda_runtime", "launch", 0, 1, 1),
              x("cuda_runtime", "launch", 20, 1, 2), x("kernel", "conv", 25, 100, 2),
              x("cuda_runtime", "launch", 31, 1, 3), x("kernel", "bce", 131, 7, 3),
              x("cuda_runtime", "launch", 39, 1, 4), x("kernel", "sum", 500, 3, 4),
              x("kernel", "orphan", 600, 50, 9)]

    class Prof:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"baseTimeNanoseconds": base, "traceEvents": events}, f)

    @contextlib.contextmanager
    def recording():
        yield spans

    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(prof, "recording", recording)
    ctx = types.SimpleNamespace(cuda=False, sync=lambda: None)
    got, n = train_yolo3.loss_stretch(types.SimpleNamespace(step=lambda: None), ctx, 1)
    assert n == 1 and got == pytest.approx(10e-6)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
def test_one_step_on_the_card_puts_the_loss_kernels_under_its_span(card, tiny):
    """One traced step of the tiny cfg: `train.loss` opens once, kernels
    launched inside it run on the card, and both heads have positives."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.common.painting import plain_labels
    from benchmark.drivers import train_yolo3

    _, _, tree = _seeded(tiny, 64, device="cuda")
    spec = build_spec(parse_cfg(tiny))
    trainer = PlainTrainer(spec, device="cuda")
    mom = init_momentum(tree)
    mix = {"background_noise": [0.2, 0.2], "min_objects": 4, "max_objects": 8, "size": 64,
           "object_sides": [[0.5, 4, 10], [0.5, 20, 40]], "aspect": [0.5, 2.0]}
    scenes = train_yolo3.layouts(np.random.default_rng(5), 8, 4, mix)
    batch = {"x": torch.rand(1, 8, 64, 64, 3), "target": plain_labels(scenes)[None],
             "keep": np.ones((1, 8), np.float32)}
    trainer.step(tree, mom, batch, seen=64, lr=1e-3)  # cuDNN's first choices, the kernels built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        prof.warm_up_cuda_trace()
        with prof.recording() as spans:
            _, _, metrics = trainer.step(tree, mom, batch, seen=128, lr=1e-3)
            format_loss_line(128, metrics)
    assert [s.name for s in spans].count("train.loss") == 1
    assert all(v > 0 for v in metrics["positives"].tolist())
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"yolo_card_{os.getpid()}.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    os.remove(path)
    base = int(doc.get("baseTimeNanoseconds", 0))
    (loss,) = [s for s in spans if s.name == "train.loss"]
    lo, hi = (loss.start - base) / 1e3, (loss.end - base) / 1e3
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    inside = {e["args"]["correlation"] for e in events if e.get("cat") == "cuda_runtime"
              and lo <= float(e["ts"]) < hi and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in inside]
    assert len(kernels) >= 20, len(kernels)
