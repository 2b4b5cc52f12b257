"""YOLOv4 on the port: `cfg/yolov4.cfg` as published, Mish
(`ops/mish.py`), stride-1 max pools of odd size, routes of any number of
sources, and the [yolo] loss's YOLOv4 keys (`scale_x_y`, `iou_thresh`,
`iou_normalizer`, `cls_normalizer`, `iou_loss=ciou`) in `ops/yolo_loss.py`,
each held against the plain reference `tests/yolov4_ref.py` (a byte copy
of the benchmark's `benchmark/reference/yolov4.py`) on the CPU at a tiny
size; YOLOv3's loss bit-equal to its form before YOLOv4's keys; the
refusals that replaced the silent fallbacks; the plain CLI on such a cfg;
the benchmark's cell at a tiny size through `benchmark/run.py`; and, on
the card, one traced step.

Stated bounds. Float32, port against reference: the heads to 1e-5
(measured up to 5e-6: the two forwards sum their convolutions in other
orders, channels-last against NCHW, and the port's CPU batch norm sums in
float64), the loss to 1e-5 relative, every gradient leaf to 5e-5 of the
leaf's largest magnitude and the BN updates to 1e-5 (measured up to 6e-6:
the same last bits, grown through 36 layers and the loss's terms). The
loss cases compare with the reference to float32 rounding (1e-6) and with
closed forms written here to 1e-5 relative (the closed forms run in
float64). The odd pools are `F.max_pool2d`'s own values: equal.

The float32 comparison's inputs are drawn from seeds on which no leaky
input lies within float32 rounding of the kink at 0. Where one does, the
two sides, each right to float32, may take the kink's two branches there
(slope 1 against 0.1), and every leaf below moves by a few tenths of a
percent: at 64 px from seed 64 and at 96 px from seed 1 an input of layer
20's leaky at 1e-6 does so. That is no fault of either side, and no bound
set for rounding covers it. The comparisons run on PyTorch's own CPU
convolutions (oneDNN off): oneDNN picks among its algorithms from process
to process, and one process in six moved the reference's heads by 2e-4
at 64 px, where PyTorch's convolutions give the same bits in every process.
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
import torch.nn.functional as F

import yolov4_ref as ref
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.config.darkcfg import propagate_shapes
from fewshot_detection_tpu_torch.models.convert import require_grads
from fewshot_detection_tpu_torch.models.darknet import apply_network
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops import bn_act as ba
from fewshot_detection_tpu_torch.ops import layers as tl
from fewshot_detection_tpu_torch.ops.mish import mish
from fewshot_detection_tpu_torch.ops.yolo_loss import yolo_loss
from fewshot_detection_tpu_torch.train import PlainTrainer, init_momentum
from fewshot_detection_tpu_torch.utils import format_loss_line
from fewshot_detection_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "yolov4_coco.train_v4_b64_608"
ANCHORS = "4,5,  8,10,  12,9,  16,22,  30,24,  40,44"
IOU_NORM, CLS_NORM = 0.07, 0.9


def _conv(filters, size, stride=1, bn=True, act="mish"):
    return (f"[convolutional]\n{'batch_normalize=1' + chr(10) if bn else ''}filters={filters}\n"
            f"size={size}\nstride={stride}\npad=1\nactivation={act}\n")


def _yolo(mask, scale, classes, thresh=0.213, loss="ciou"):
    return (f"[yolo]\nmask = {mask}\nanchors = {ANCHORS}\nclasses={classes}\nnum=6\njitter=.3\n"
            f"ignore_thresh = .7\ntruth_thresh = 1\nscale_x_y = {scale}\niou_thresh={thresh}\n"
            f"cls_normalizer={CLS_NORM}\niou_normalizer={IOU_NORM}\niou_loss={loss}\n"
            "nms_kind=greedynms\nbeta_nms=0.6\nmax_delta=5\nrandom=1\n")


def tiny_cfg(classes=4, size=64, act="mish", pool=None) -> str:
    """The published cfg's kinds at a tiny size: a Mish stem, one CSP stage
    (split route, residual block, two-source join), two strided Mish convs,
    SPP (pools of 5, 9 and 13, the four-source route), the top-down
    upsample and route, a head at 1/4 of the input, the strided PANet conv
    and its route back to SPP's output, and a head at 1/8. `act` and `pool`
    (one size for the three pools) plant faults."""
    out = 3 * (5 + classes)

    def m(f, k, s=1):
        return _conv(f, k, s, act=act)

    def leaky(f, k, s=1):
        return _conv(f, k, s, act="leaky")

    def spp(k):
        return f"[maxpool]\nstride=1\nsize={pool or k}\n"

    blocks = [
        "[net]\nbatch=4\nsubdivisions=1\n"
        f"width={size}\nheight={size}\nchannels=3\nmomentum=0.949\ndecay=0.0005\n"
        "learning_rate=0.0013\nburn_in=0\nmax_batches=2\npolicy=steps\nsteps=80,90\n"
        "scales=.1,.1\n",
        m(8, 3), m(16, 3, 2), m(8, 1), "[route]\nlayers = -2\n", m(8, 1), m(8, 1), m(8, 3),
        "[shortcut]\nfrom=-3\nactivation=linear\n", m(8, 1), "[route]\nlayers = -1,-7\n", m(16, 1),
        m(32, 3, 2), m(64, 3, 2), leaky(16, 1),
        spp(5), "[route]\nlayers=-2\n", spp(9), "[route]\nlayers=-4\n", spp(13),
        "[route]\nlayers=-1,-3,-5,-6\n",
        leaky(32, 1), leaky(16, 1), "[upsample]\nstride=2\n", "[route]\nlayers = 11\n",
        leaky(16, 1), "[route]\nlayers = -1, -3\n", leaky(16, 1), leaky(32, 3),
        _conv(out, 1, bn=False, act="linear"), _yolo("0,1,2", 1.2, classes),
        "[route]\nlayers = -4\n", leaky(32, 3, 2), "[route]\nlayers = -1, -12\n", leaky(32, 1),
        _conv(out, 1, bn=False, act="linear"), _yolo("3,4,5", 1.1, classes),
    ]
    return "\n".join(blocks)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("yolov4") / "tiny_yolov4.cfg")
    with open(path, "w") as f:
        f.write(tiny_cfg())
    return path


def _write(tmp_path, text, name="tiny.cfg"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(text)
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


def _params(spec) -> int:
    """Learned parameters: conv weights, batch norm's scale and shift, the
    heads' biases (darknet's count; running statistics left out)."""
    total = 0
    for l in spec.layers:
        if l.kind == "conv":
            total += l.out_channels * l.in_channels * l.size ** 2
            total += 2 * l.out_channels if l.batch_normalize else l.out_channels
    return total


def test_the_published_cfg_compiles_to_yolov4():
    path = os.path.join(REPO, "cfg", "yolov4.cfg")
    blocks = parse_cfg(path)
    spec = build_spec(blocks)
    kinds = [l.kind for l in spec.layers]
    convs = [l for l in spec.layers if l.kind == "conv"]
    assert len(spec.layers) == 162 and len(convs) == 110
    assert [l.activation for l in convs].count("mish") == 72
    assert all(l.activation == "mish" for l in convs if l.index <= 104)
    assert sum(l.activation == "leaky" and l.batch_normalize for l in convs) == 35
    heads = [l.index for l in spec.layers if l.kind == "yolo"]
    assert heads == [139, 150, 161]
    assert [(spec.layers[i - 1].activation, spec.layers[i - 1].batch_normalize,
             spec.layers[i - 1].bias, spec.layers[i - 1].out_channels) for i in heads] == [
        ("linear", False, True, 255)] * 3
    assert _params(spec) == 64_363_101
    assert kinds.count("shortcut") == 23 and kinds.count("upsample") == 2
    assert [(l.index, l.size, l.stride) for l in spec.layers if l.kind == "maxpool"] == [
        (108, 5, 1), (110, 9, 1), (112, 13, 1)]
    assert [l.index for l in convs if l.stride == 2] == [1, 11, 24, 55, 86, 141, 152]
    routes = {l.index: l.sources for l in spec.layers if l.kind == "route"}
    assert {i: routes[i] for i in (3, 9, 22, 53, 84, 103)} == {
        3: (1,), 9: (8, 2), 22: (21, 12), 53: (52, 25), 84: (83, 56), 103: (102, 87)}
    assert {i: routes[i] for i in (109, 111, 113, 119, 121, 129, 131, 140, 142, 151, 153)} == {
        109: (107,), 111: (107,), 113: (112, 110, 108, 107), 119: (85,), 121: (120, 118),
        129: (54,), 131: (130, 128), 140: (136,), 142: (141, 126), 151: (147,),
        153: (152, 116)}
    assert spec.layers[113].out_channels == 2048
    assert all(l.sources == (l.index - 3, l.index - 1) for l in spec.layers
               if l.kind == "shortcut")
    assert [h.mask for h in spec.yolo_heads] == [(0, 1, 2), (3, 4, 5), (6, 7, 8)]
    assert [h.scale_x_y for h in spec.yolo_heads] == [1.2, 1.1, 1.05]
    for h in spec.yolo_heads:
        assert h.anchor_wh == ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
                               (142, 110), (192, 243), (459, 401))
        assert (h.num_classes, h.num, h.ignore_thresh, h.truth_thresh, h.iou_thresh,
                h.iou_normalizer, h.cls_normalizer, h.iou_loss) == (
            80, 9, 0.7, 1.0, 0.213, 0.07, 1.0, "ciou")
    net = blocks[0]
    assert {k: net[k] for k in ("batch", "subdivisions", "width", "height", "momentum", "decay",
                                "learning_rate", "burn_in", "max_batches", "policy", "steps",
                                "scales", "mosaic")} == {
        "batch": "64", "subdivisions": "8", "width": "608", "height": "608",
        "momentum": "0.949", "decay": "0.0005", "learning_rate": "0.0013", "burn_in": "1000",
        "max_batches": "500500", "policy": "steps", "steps": "400000,450000",
        "scales": ".1,.1", "mosaic": "1"}
    assert {k: blocks[140][k] for k in ("jitter", "random", "max_delta", "nms_kind")} == {
        "jitter": ".3", "random": "1", "max_delta": "5", "nms_kind": "greedynms"}


def test_shapes_propagate_through_the_published_cfg_at_608():
    shapes = propagate_shapes(parse_cfg(os.path.join(REPO, "cfg", "yolov4.cfg")))
    assert [(shapes[i].width, shapes[i].filters) for i in (54, 85, 104, 113, 116)] == [
        (76, 256), (38, 512), (19, 1024), (19, 2048), (19, 512)]
    assert [(shapes[i].width, shapes[i].height, shapes[i].filters) for i in (139, 150, 161)] == [
        (76, 76, 255), (38, 38, 255), (19, 19, 255)]
    assert [(shapes[i].width, shapes[i].filters) for i in (121, 131, 142, 153)] == [
        (38, 512), (76, 256), (38, 512), (19, 1024)]
    assert all(shapes[i].width == 19 for i in (108, 110, 112))  # the pools keep the side
    assert [s.width for s in propagate_shapes(parse_cfg(os.path.join(REPO, "cfg", "yolov4.cfg")),
                                              416, 416)][139] == 52


def test_the_reference_agrees_on_the_published_cfg_and_its_flops():
    from benchmark.drivers import train_yolo4

    layers = ref.walk(ref.parse(os.path.join(REPO, "cfg", "yolov4.cfg")))
    spec = build_spec(parse_cfg(os.path.join(REPO, "cfg", "yolov4.cfg")))
    assert [l.kind for l in layers] == [l.kind for l in spec.layers]
    assert [(l.c_out, l.activation) for l in layers if l.kind == "conv"] == [
        (l.out_channels, l.activation) for l in spec.layers if l.kind == "conv"]
    assert [l.sources for l in layers if l.kind == "route"] == [
        l.sources for l in spec.layers if l.kind == "route"]
    fwd = sum(2 * l.side_out ** 2 * l.c_in * l.c_out * l.size ** 2 for l in layers
              if l.kind == "conv")
    assert round(fwd / 1e9, 2) == 128.39
    first = 2 * 608 * 608 * 3 * 32 * 9
    assert train_yolo4.step_flops(layers, 64) == 64 * (3 * fwd - first)
    assert len(train_yolo4.bn_layers(layers, 64)) == 107
    elems = [l.side_out ** 2 * l.c_out for l in layers if l.kind == "conv"]
    mish_elems = [l.side_out ** 2 * l.c_out for l in layers
                  if l.kind == "conv" and l.activation == "mish"]
    assert (round(sum(elems) / 1e6, 1), round(sum(mish_elems) / 1e6, 1)) == (114.4, 94.8)


@pytest.mark.parametrize("pair", [("tests/yolov4_ref.py", "benchmark/reference/yolov4.py"),
                                  ("cfg/yolov4.cfg", "benchmark/configs/cfg/yolov4.cfg")])
def test_the_benchmarks_copies_are_byte_identical(pair):
    a, b = (open(os.path.join(REPO, p), "rb").read() for p in pair)
    assert a == b


# -- the port against the reference in float32 -------------------------------


def _ref_grads(layers, w, x, target, keep, size):
    names = [(i, k) for i, p in w.items() for k in p if k not in ("mean", "var")]
    for i, k in names:
        w[i][k].requires_grad_(True)
    terms = {}
    got = ref.yolo_loss(ref.forward(layers, w, x, train=True), layers, target, keep,
                        (size, size), terms)
    return got, terms, names, torch.autograd.grad(got, [w[i][k] for i, k in names])


@pytest.fixture
def plain_convs():
    """PyTorch's own CPU convolutions (see the module's docstring)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.mark.parametrize("size", [64, 96])
def test_heads_loss_gradients_and_bn_meet_the_reference(tiny, size, plain_convs):
    layers, w, tree = _seeded(tiny, size)
    spec = build_spec(parse_cfg(tiny))
    # inputs on which no leaky input lies within float32 rounding of the
    # kink (see the module's docstring)
    x = torch.rand(4, size, size, 3, generator=torch.Generator().manual_seed(size + 1))
    target, keep = _targets(4, size), torch.ones(4)

    heads, _ = apply_network(spec, tree, x, train=True)
    # a copy: the reference's training forward moves the running statistics
    want = ref.forward(layers, {i: {k: t.clone() for k, t in p.items()} for i, p in w.items()},
                       x, train=True)
    assert [tuple(h.shape) for h in heads] == [(4, size // 4, size // 4, 27),
                                               (4, size // 8, size // 8, 27)]
    for a, b in zip(heads, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    trainer = PlainTrainer(spec, device="cpu")
    loss, grads, bns, metrics = trainer.loss_and_grads(
        tree, {"x": x[None], "target": target[None], "keep": keep[None]}, seen=64)
    got, terms, names, ref_grads = _ref_grads(layers, w, x, target, keep, size)
    assert float(loss) == pytest.approx(float(got.detach()), rel=1e-5)
    assert float(metrics["loss_iou"]) == pytest.approx(terms["box"], rel=1e-5)
    assert float(metrics["loss_cls"]) == pytest.approx(terms["cls"], rel=1e-5)
    assert float(metrics["loss_conf"]) == pytest.approx(terms["obj"] + terms["noobj"], rel=1e-5)
    assert int(metrics["extra_positives"]) == terms["extra"] > 0
    assert float(metrics["nGT"]) == float((target[:, :, 1] > 0).sum())
    assert all(float(metrics[k]) == 0.0 for k in ("loss_x", "loss_y", "loss_w", "loss_h"))
    for (i, k), g in zip(names, ref_grads):
        mine = grads[i]["bn"][k] if k in ("gamma", "beta") else grads[i][k]
        assert (mine - g).abs().max() <= 5e-5 * g.abs().max(), (i, k)
    # the BN running statistics: the reference moved its own in its forward
    assert sorted(bns[0]) == sorted(i for i, l in enumerate(layers) if l.kind == "conv" and l.bn)
    for i, stats in bns[0].items():
        for k in ("mean", "var"):
            torch.testing.assert_close(stats[k], w[i][k], rtol=1e-5, atol=1e-5)


def test_one_trainer_step_meets_the_reference_step(tiny, plain_convs):
    from benchmark.drivers.train import port_leaves, ref_leaves

    size = 64
    layers, w, tree = _seeded(tiny, size, seed=11)
    spec = build_spec(parse_cfg(tiny))
    x = torch.rand(2, 2, size, size, 3, generator=torch.Generator().manual_seed(3))
    target, keep = _targets(4, 5), torch.ones(4)
    trainer = PlainTrainer(spec, momentum=0.949, weight_decay=0.0005 * 4, device="cpu")
    mom = init_momentum(tree)
    tree, mom, metrics = trainer.step(
        tree, mom, {"x": x, "target": target.reshape(2, 2, 50, 5), "keep": keep.reshape(2, 2)},
        seen=64, lr=0.0013 / 4)
    # the trainer's two groups normalise each with its own statistics and
    # sum their losses; the reference takes each group as one batch
    for i, k in [(i, k) for i, p in w.items() for k in p if k not in ("mean", "var")]:
        w[i][k].requires_grad_(True)
    rmom = {f"{i}.{k}": torch.zeros_like(t) for i, p in w.items() for k, t in p.items()
            if k not in ("mean", "var")}
    heads = [ref.forward(layers, w, x[r], train=True) for r in range(2)]
    loss = sum(ref.yolo_loss(h, layers, target.reshape(2, 2, 50, 5)[r], keep[:2], (size, size))
               for r, h in enumerate(heads))
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    names = [(i, k) for i, p in w.items() for k in p if k not in ("mean", "var")]
    grads = torch.autograd.grad(loss, [w[i][k] for i, k in names])
    with torch.no_grad():
        for (i, k), g in zip(names, grads):
            d = g + (0.0005 * 4 * w[i][k] if k == "w" else 0)
            rmom[f"{i}.{k}"].mul_(0.949).add_(d)
            w[i][k].sub_(0.0013 / 4 * rmom[f"{i}.{k}"])
    mine = port_leaves(tree, "plain")
    theirs = ref_leaves({"darknet": w})
    for k, t in theirs.items():
        if k.endswith((".mean", ".var")):
            continue
        assert (mine[k].detach() - t).abs().max() <= 5e-5 * t.abs().max(), k


def test_each_fault_of_the_forward_parts_from_the_reference(tmp_path):
    """Mish taken as leaky or linear, or SPP's pools taken as 2x2, moves
    the heads far past the float32 bound of the sound network."""
    layers, w, tree = _seeded(_write(tmp_path, tiny_cfg()), 64)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    want = ref.forward(layers, w, x, train=True)
    for name, text in (("leaky", tiny_cfg(act="leaky")), ("linear", tiny_cfg(act="linear")),
                       ("pool2", tiny_cfg(pool=2))):
        spec = build_spec(parse_cfg(_write(tmp_path, text, f"{name}.cfg")))
        heads, _ = apply_network(spec, tree, x, train=True)  # the same weights
        gap = max(float((a - b).abs().max()) for a, b in zip(heads, want))
        assert gap > 1e-2, name


# -- the new layers ----------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 3, 5, 9, 13])
def test_a_centred_pool_is_max_pool2d_padded_by_half_its_size(size):
    x = torch.randn(2, 7, 9, 5, generator=torch.Generator().manual_seed(size),
                    requires_grad=True)
    got = tl.maxpool_centred(x, size)
    xc = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
    want = F.max_pool2d(xc, size, 1, size // 2)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    # a window that reaches past the map takes the max of what lies inside
    r = size // 2
    assert float(got[0, 0, 0, 0]) == float(x[0, :r + 1, :r + 1, 0].max())
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    (gx,) = torch.autograd.grad(got, x, g)
    (gw,) = torch.autograd.grad(want, xc, g.permute(0, 3, 1, 2))
    assert torch.equal(gx, gw.permute(0, 2, 3, 1))


def test_a_stride1_pool_of_size_two_keeps_the_replicate_padded_pool(tmp_path):
    from fewshot_detection_tpu_torch.models.darknet import Walk

    text = ("[net]\nwidth=8\nheight=8\nchannels=3\n\n[maxpool]\nsize=2\nstride=1\n\n"
            "[maxpool]\nsize=3\nstride=1\n")
    spec = build_spec(parse_cfg(_write(tmp_path, text)))
    x = torch.randn(1, 8, 8, 3)
    walk = Walk(spec, [None, None])
    walk.run(x)
    assert torch.equal(walk.outputs[0], tl.maxpool_stride1(x))
    assert torch.equal(walk.outputs[1], tl.maxpool_centred(walk.outputs[0], 3))


def test_mish_is_torch_mish_each_way_and_counts_its_calls():
    x = torch.randn(4, 5, 6, 3, dtype=torch.float64, requires_grad=True)
    f, b = mish.launches, mish.backward_launches
    y = mish(x)
    assert torch.equal(y, F.mish(x.detach()))
    (g,) = torch.autograd.grad(y.sum(), x)
    x2 = x.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(F.mish(x2).sum(), x2)
    assert torch.equal(g, want)
    torch.testing.assert_close(y, x * torch.tanh(F.softplus(x)), rtol=1e-12, atol=1e-12)
    assert (mish.launches - f, mish.backward_launches - b) == (1, 1)


def test_training_bn_runs_mish_after_the_linear_epilogue():
    y = torch.randn(2, 4, 4, 6, generator=torch.Generator().manual_seed(3))
    bn = {"gamma": torch.rand(6) + 0.5, "beta": torch.randn(6), "mean": torch.zeros(6),
          "var": torch.ones(6)}
    out, stats = tl.bn_train_activate(y, bn, "mish")
    lin, stats2 = tl.bn_train_activate(y, bn, "linear")
    assert torch.equal(out, F.mish(lin))
    assert all(torch.equal(stats[k], stats2[k]) for k in stats)


# -- refusals that replaced the silent fallbacks ------------------------------------


def _net(body):
    return "[net]\nwidth=32\nheight=32\nchannels=3\n\n" + body


@pytest.mark.parametrize("body,match", [
    (_conv(8, 3, act="swish"), "activation 'swish'"),
    (_conv(8, 3, act="logistic"), "activation 'logistic'"),
    (_conv(8, 3, act="leaky") + "\n[shortcut]\nfrom=-1\nactivation=tanh\n", "activation 'tanh'"),
    ("[maxpool]\nsize=4\nstride=1\n", "even size 4"),
    (_conv(8, 1, bn=False, act="linear") + "\n" + _yolo("0,1", 1.0, 1, loss="giou"),
     "iou_loss='giou'"),
    (_conv(8, 1, bn=False, act="linear") + "\n" + _yolo("0,1", 1.1, 1, loss="mse"),
     "scale_x_y=1.1 with the mse"),
])
def test_build_spec_refuses_what_the_port_does_not_compute(tmp_path, body, match):
    with pytest.raises(ValueError, match=match):
        build_spec(parse_cfg(_write(tmp_path, _net(body))))


def test_the_activation_helpers_refuse_an_unknown_activation():
    y = torch.randn(3, 4)
    inv, bias = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="'swish'"):
        tl._activate(y, "swish")
    for bad in ("swish", "mish"):  # bn_act's kernels compute neither
        with pytest.raises(ValueError, match=repr(bad)):
            ba.activation_code(bad)
        with pytest.raises(ValueError, match=repr(bad)):
            ba.grad_at_z(y, y, inv, bias, bad)
        with pytest.raises(ValueError, match=repr(bad)):
            ba.bn_act(y, inv, bias, bad)
    assert [ba.activation_code(a) for a in ("leaky", "relu", "linear")] == [0, 1, 2]


def test_routes_join_any_number_of_sources_and_the_meta_walk_two(tmp_path):
    from fewshot_detection_tpu_torch.models import meta as tm
    from fewshot_detection_tpu_torch.models.darknet import Walk
    from fewshot_detection_tpu_torch.models.spec import LayerSpec

    text = _net(_conv(4, 1, act="linear") + "\n" + _conv(5, 1, act="linear") + "\n"
                + _conv(6, 1, act="linear") + "\n[route]\nlayers=-1,-3,-2\n")
    spec = build_spec(parse_cfg(_write(tmp_path, text)))
    assert spec.layers[3].out_channels == 15 and spec.layers[3].sources == (2, 0, 1)
    parts = [torch.randn(1, 2, 2, c) for c in (4, 5, 6)]
    assert torch.equal(Walk(spec, []).join(spec.layers[3], *parts),
                       torch.cat([parts[0], parts[1], parts[2]], -1))
    route = LayerSpec(index=9, kind="route", sources=(1, 2, 3))
    with pytest.raises(ValueError, match="joins two sources, the route has 3"):
        tm._DetectWalk.join(types.SimpleNamespace(), route, *parts)
    bad = _net(_conv(4, 1, act="linear") + "\n" + _conv(5, 3, 2, act="linear") + "\n"
               + _conv(6, 1, act="linear") + "\n[route]\nlayers=-1,-2,-3\n")
    with pytest.raises(ValueError, match="spatial mismatch"):
        propagate_shapes(parse_cfg(_write(tmp_path, bad, "bad.cfg")))
    tuple3 = _net(_conv(4, 1, act="linear") + "\n" + _conv(5, 1, act="linear") + "\n"
                  + "[route]\nlayers=-1,-2,-2\nconcat=0\n")
    with pytest.raises(ValueError, match="tuple route"):
        build_spec(parse_cfg(_write(tmp_path, tuple3, "tuple3.cfg")))


# -- the loss, case by case (the tiny cfg's heads: 16x16 of anchors 0-2 and
# 8x8 of anchors 3-5 at 64 px, 4 classes) -------------------------------------


def _loss(tiny, target, logits=None):
    """(loss, metrics, gradient of each head) of the port, checked against
    the reference's loss and head gradients, for heads of zero logits with
    `logits` {(head, b, j, i, a, channel): value} written in."""
    spec = build_spec(parse_cfg(tiny))
    layers = ref.walk(ref.parse(tiny), 64)
    heads = [torch.zeros(1, 16, 16, 27), torch.zeros(1, 8, 8, 27)]
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


def _shape_iou(w, h, aw, ah):
    return min(w, aw) * min(h, ah) / (w * h + aw * ah - min(w, aw) * min(h, ah))


def test_a_truth_takes_every_anchor_above_iou_thresh_in_either_head(tiny):
    """A 10x11 px truth: best anchor 1 (8x10, shape IoU 0.73); anchor 2
    (12x9, 0.70) of the same head and anchor 3 (16x22, 0.31) of the other
    pass 0.213; anchors 0 (0.18), 4 and 5 do not."""
    w, h = 10 / 64, 11 / 64
    ious = [_shape_iou(10, 11, aw, ah) for aw, ah in ((4, 5), (8, 10), (12, 9), (16, 22),
                                                       (30, 24), (40, 44))]
    assert [v > 0.213 for v in ious] == [False, True, True, True, False, False]
    assert max(ious) == ious[1]
    _, metrics, (g0, g1) = _loss(tiny, [[2, 0.30, 0.70, w, h]])
    assert metrics["positives"].tolist() == [2, 1] and int(metrics["extra_positives"]) == 2
    j, i = int(0.70 * 16), int(0.30 * 16)
    # objectness pushed to 1 at anchors 1 and 2 of the truth's cell, to 0 at anchor 0
    assert [float(g0[j, i, a, 4]) for a in range(3)] == pytest.approx([0.5, -0.5, -0.5])
    # each assigned prediction takes the box and class terms
    assert int(torch.count_nonzero(g0[j, i, 1:, :4].abs().sum(-1))) == 2
    assert float(g0[j, i, 2, 5 + 2]) == pytest.approx(-0.5 * CLS_NORM)
    assert int(torch.count_nonzero(g1[..., :4].abs().sum(-1))) == 1
    assert float(g1[int(0.70 * 8), int(0.30 * 8), 0, 4]) == pytest.approx(-0.5)


def test_a_truth_below_iou_thresh_at_every_other_anchor_takes_one(tiny):
    # 56x62 px: anchor 5 (shape IoU 0.51), anchor 4 at 0.207
    _, metrics, _ = _loss(tiny, [[1, 0.55, 0.5, 56 / 64, 62 / 64]])
    assert metrics["positives"].tolist() == [0, 1] and int(metrics["extra_positives"]) == 0


def _ciou_closed_form(p, t):
    """1 - CIoU in float64 from the published formula, and its parts."""
    px, py, pw, ph = p
    tx, ty, tw, th = t
    iw = min(px + pw / 2, tx + tw / 2) - max(px - pw / 2, tx - tw / 2)
    ih = min(py + ph / 2, ty + th / 2) - max(py - ph / 2, ty - th / 2)
    inter = max(iw, 0) * max(ih, 0)
    iou = inter / (pw * ph + tw * th - inter)
    cw = max(px + pw / 2, tx + tw / 2) - min(px - pw / 2, tx - tw / 2)
    ch = max(py + ph / 2, ty + th / 2) - min(py - ph / 2, ty - th / 2)
    dist = ((px - tx) ** 2 + (py - ty) ** 2) / (cw ** 2 + ch ** 2)
    v = 4 / math.pi ** 2 * (math.atan(tw / th) - math.atan(pw / ph)) ** 2
    alpha = v / (1 - iou + v)
    return 1 - (iou - dist - alpha * v), dist, alpha * v


def test_the_box_term_is_one_less_ciou_of_the_scaled_decode(tiny):
    """One 56x62 px truth, which takes anchor 5 (40x44, of the 8x8 head,
    scale_x_y 1.1) alone (anchor 4's shape IoU is 0.207), its prediction
    shifted and stretched by the logits written in: the box term is
    iou_normalizer (1 - CIoU) of the decoded box, centre (i + 1.1 sig(tx) -
    0.05) / 8, and both of CIoU's penalties count."""
    x, y, w, h = 0.47, 0.5, 56 / 64, 62 / 64
    assert _shape_iou(56, 62, 30, 24) < 0.213 < _shape_iou(56, 62, 40, 44)
    i, j = int(x * 8), int(y * 8)
    tx, ty, tw, th = 0.8, -0.5, 0.3, -0.2
    logits = {(1, 0, j, i, 2, 0): tx, (1, 0, j, i, 2, 1): ty, (1, 0, j, i, 2, 2): tw,
              (1, 0, j, i, 2, 3): th}
    _, metrics, _ = _loss(tiny, [[3, x, y, w, h]], logits)
    assert metrics["positives"].tolist() == [0, 1] and int(metrics["extra_positives"]) == 0

    def sig(v):
        return 1 / (1 + math.exp(-v))

    pred = ((i + 1.1 * sig(tx) - 0.05) / 8, (j + 1.1 * sig(ty) - 0.05) / 8,
            math.exp(tw) * 40 / 64, math.exp(th) * 44 / 64)
    term, dist, aspect = _ciou_closed_form(pred, (x, y, w, h))
    assert dist > 1e-3 and aspect > 1e-3
    assert float(metrics["loss_iou"]) == pytest.approx(IOU_NORM * term, rel=1e-5)
    # without either penalty the term would be off by more than the bound
    for part in (dist, aspect):
        assert abs(IOU_NORM * (term - part) - float(metrics["loss_iou"])) > 1e-3 * IOU_NORM * term


def test_classes_scale_by_cls_normalizer(tiny):
    _, metrics, (_, g1) = _loss(tiny, [[3, 0.47, 0.5, 56 / 64, 62 / 64]])  # anchor 5 alone
    # at zero logits each class term is log 2, and there are 4 of them
    assert float(metrics["loss_cls"]) == pytest.approx(CLS_NORM * 4 * math.log(2.0), rel=1e-6)
    assert float(g1[4, 3, 2, 5 + 3]) == pytest.approx(-0.5 * CLS_NORM)


def test_two_truths_on_one_prediction_the_later_box_and_both_classes(tiny):
    """Both truths take anchor 4 (best) and anchors 3 and 5 (above 0.213)
    at cell (2, 2) of the 8x8 head: three predictions, each with both
    classes; the second truth's assignments win, two of them extra."""
    first = [1, 0.30, 0.30, 30 / 64, 24 / 64]
    second = [3, 0.34, 0.33, 31 / 64, 23 / 64]
    _, metrics, (_, g1) = _loss(tiny, [first, second])
    assert metrics["positives"].tolist() == [0, 3] and int(metrics["extra_positives"]) == 2
    for a in range(3):
        assert g1[2, 2, a, 5:].tolist() == pytest.approx([0.5 * CLS_NORM, -0.5 * CLS_NORM,
                                                          0.5 * CLS_NORM, -0.5 * CLS_NORM])
    assert int(metrics["nGT"]) == 2


# -- YOLOv3's loss as it was before YOLOv4's keys -----------------------------------


def _yolov3_loss_before(heads, target, keep, specs, net_wh):
    """`ops/yolo_loss.py:yolo_loss` as it stood before it read YOLOv4's keys
    (its operations in their order), for the bit-equality test."""
    dev = heads[0].device
    nB, S = target.shape[:2]
    nC = specs[0].num_classes
    net_w, net_h = net_wh
    per_pred = {k: [] for k in ("i", "j", "w", "h", "aw", "ah", "thresh")}
    per_anchor = {k: [-1] * specs[0].num for k in ("head", "slot", "grid_w", "grid_h", "a",
                                                   "first")}
    first = 0
    for hd, (hh, spec) in enumerate(zip(heads, specs)):
        gh, gw_ = hh.shape[1:3]
        for jj in range(gh):
            for ii in range(gw_):
                for n in spec.mask:
                    aw, ah = spec.anchor_wh[n]
                    for k, v in (("i", ii), ("j", jj), ("w", gw_), ("h", gh), ("aw", aw / net_w),
                                 ("ah", ah / net_h), ("thresh", spec.ignore_thresh)):
                        per_pred[k].append(v)
        for slot, n in enumerate(spec.mask):
            for k, v in (("head", hd), ("slot", slot), ("grid_w", gw_), ("grid_h", gh),
                         ("a", len(spec.mask)), ("first", first)):
                per_anchor[k][n] = v
        first += gh * gw_ * len(spec.mask)
    lay = {k: torch.tensor(v, dtype=torch.float32) for k, v in per_pred.items()}
    lay.update({k: torch.tensor(v, dtype=torch.int64) for k, v in per_anchor.items()})
    lay["anchors"] = torch.tensor([(aw / net_w, ah / net_h) for aw, ah in specs[0].anchor_wh],
                                  dtype=torch.float32)

    def iou(a, b):
        w = (torch.minimum(a[..., 0] + a[..., 2] / 2, b[..., 0] + b[..., 2] / 2)
             - torch.maximum(a[..., 0] - a[..., 2] / 2, b[..., 0] - b[..., 2] / 2)).clamp(min=0)
        h = (torch.minimum(a[..., 1] + a[..., 3] / 2, b[..., 1] + b[..., 3] / 2)
             - torch.maximum(a[..., 1] - a[..., 3] / 2, b[..., 1] - b[..., 3] / 2)).clamp(min=0)
        inter = w * h
        return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter).clamp(min=1e-12)

    def bce(logit, t):
        if not isinstance(t, torch.Tensor):
            t = torch.full_like(logit, t)
        return F.binary_cross_entropy_with_logits(logit, t, reduction="none")

    t = target.to(dtype=torch.float32)
    km = keep.to(dtype=torch.float32)[:, None]
    valid = t[:, :, 1] > 0
    gx, gy, gw, gh = t[:, :, 1], t[:, :, 2], t[:, :, 3], t[:, :, 4]
    cls = t[:, :, 0].to(torch.int64)
    gt = t[:, :, 1:5]
    o = torch.cat([h.reshape(nB, -1, 5 + nC) for h in heads], 1).to(torch.float32)
    with torch.no_grad():
        od = o.detach()
        pred = torch.stack([(lay["i"] + torch.sigmoid(od[..., 0])) / lay["w"],
                            (lay["j"] + torch.sigmoid(od[..., 1])) / lay["h"],
                            torch.exp(od[..., 2]) * lay["aw"],
                            torch.exp(od[..., 3]) * lay["ah"]], -1)
        ious = iou(pred[:, :, None, :], gt[:, None, :, :])
        best = torch.where(valid[:, None, :], ious, torch.zeros_like(ious)).amax(dim=2)
        drop = best > lay["thresh"]
    anchors = lay["anchors"]
    inter = (torch.minimum(gw[..., None], anchors[:, 0]) *
             torch.minimum(gh[..., None], anchors[:, 1]))
    shape_iou = inter / (gw[..., None] * gh[..., None] + anchors[:, 0] * anchors[:, 1] - inter)
    best_n = torch.argmax(shape_iou, dim=-1)
    head = lay["head"][best_n]
    mine = valid & (head >= 0)
    grid_w, grid_h = lay["grid_w"][best_n], lay["grid_h"][best_n]
    gi = torch.minimum((gx * grid_w).to(torch.int64).clamp(min=0), grid_w - 1)
    gj = torch.minimum((gy * grid_h).to(torch.int64).clamp(min=0), grid_h - 1)
    cell = lay["first"][best_n] + (gj * grid_w + gi) * lay["a"][best_n] + lay["slot"][best_n]
    cell = torch.where(mine, cell, 0)
    later = torch.triu(torch.ones((S, S), dtype=torch.bool), diagonal=1)
    same = (cell[:, :, None] == cell[:, None, :]) & mine[:, :, None] & mine[:, None, :]
    win = mine & ~(same & later).any(dim=2)
    w = win.to(torch.float32) * km
    spare = o.shape[1]
    pos = torch.zeros((nB, spare + 1), dtype=torch.bool)
    pos.scatter_(1, torch.where(win, cell, spare), True)
    pos = pos[:, :spare]
    got = torch.gather(o, 1, cell[..., None].expand(-1, -1, 5 + nC))
    aw, ah = anchors[best_n, 0], anchors[best_n, 1]
    tx, ty = gx * grid_w - gi, gy * grid_h - gj
    tw = torch.log(gw.clamp(min=1e-12) / aw)
    th = torch.log(gh.clamp(min=1e-12) / ah)
    ws = w * (2.0 - gw * gh)
    onehot = (cls[..., None] == torch.arange(nC)).to(torch.float32)
    labels = same.to(torch.float32) @ onehot
    noobj = (~pos & ~drop).to(torch.float32) * km
    terms = {
        "loss_x": torch.sum(ws * bce(got[..., 0], tx)),
        "loss_y": torch.sum(ws * bce(got[..., 1], ty)),
        "loss_w": torch.sum(ws * torch.square(got[..., 2] - tw)) / 2,
        "loss_h": torch.sum(ws * torch.square(got[..., 3] - th)) / 2,
        "loss_conf": (torch.sum(w * bce(got[..., 4], 1.0))
                      + torch.sum(noobj * bce(o[..., 4], 0.0))),
        "loss_cls": torch.sum(w[..., None] * bce(got[..., 5:], labels.clamp(max=1.0))),
    }
    return sum(terms.values()), terms


@pytest.mark.parametrize("cfg_name", ["yolov3.cfg", "tiny"])
def test_yolov3s_loss_and_gradients_are_bit_equal_to_before(tmp_path, cfg_name):
    if cfg_name == "tiny":
        from test_torch_yolov3 import tiny_cfg as v3_tiny

        path = _write(tmp_path, v3_tiny(), "tiny_yolov3.cfg")
        sides, classes, size = (8, 16), 4, 64
    else:
        path = os.path.join(REPO, "cfg", cfg_name)
        sides, classes, size = (10, 20, 40), 80, 320
    specs = build_spec(parse_cfg(path)).yolo_heads
    assert all(s.iou_thresh == 1.0 and s.iou_loss == "mse" for s in specs)
    g = torch.Generator().manual_seed(size)
    heads = [torch.randn(3, s, s, 3 * (5 + classes), generator=g) for s in sides]
    target, keep = _targets(3, size, classes, most=20), torch.tensor([1.0, 0.0, 1.0])
    out = []
    for fn in (yolo_loss, _yolov3_loss_before):
        hs = [h.clone().requires_grad_(True) for h in heads]
        loss, m = fn(hs, target, keep, specs, (size, size))
        out.append((loss.detach(), torch.autograd.grad(loss, hs), m))
    (loss, grads, m), (loss0, grads0, m0) = out
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert all(torch.equal(m[k], m0[k]) for k in m0)
    assert "extra_positives" not in m and "loss_iou" not in m


# -- the trainer's counts, the loss line and the CLI ------------------------------


def test_a_step_counts_its_mish_calls_and_the_line_ends_with_the_new_counts(tiny):
    _, _, tree = _seeded(tiny, 64)
    spec = build_spec(parse_cfg(tiny))
    n_mish = sum(l.kind == "conv" and l.activation == "mish" for l in spec.layers)
    assert n_mish == 10
    trainer = PlainTrainer(spec, device="cpu")
    mom = init_momentum(tree)
    x = torch.rand(2, 2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    batch = {"x": x, "target": _targets(4, 2).reshape(2, 2, 50, 5), "keep": torch.ones(2, 2)}
    with prof.recording() as spans:
        tree, mom, metrics = trainer.step(tree, mom, batch, seen=64, lr=1e-3)
        line = format_loss_line(64, metrics)
    (step,) = [s for s in spans if s.name == "train.step"]
    assert (step.counts["mish_forward"], step.counts["mish_backward"]) == (2 * n_mish,
                                                                          2 * n_mish)
    pos = metrics["positives"].tolist()
    assert line.endswith(f", iou {float(metrics['loss_iou']):f}, positives {pos[0]}/{pos[1]}, "
                         f"extra {int(metrics['extra_positives'])}, "
                         f"ignored {int(metrics['ignored'])}")
    assert "loss: x 0.000000, y 0.000000, w 0.000000, h 0.000000," in line


def test_train_torch_trains_the_tiny_cfg_on_coco_like_files(tmp_path, monkeypatch):
    from fewshot_detection_tpu_torch.cli import train_plain_cli
    from fewshot_detection_tpu_torch.data import synth
    from fewshot_detection_tpu_torch.models import weights_io
    from fewshot_detection_tpu_torch.models.darknet import init_params

    d = synth.make_coco_like(str(tmp_path / "coco"), [0, 1, 2, 3, 4, 5, 6, 7], seed=1, n_train=8)
    cfg = _write(tmp_path, tiny_cfg(classes=80), "tiny_yolov4_coco.cfg")
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
    assert len(lines) == 4 and all(", iou " in l and ", extra " in l for l in lines)
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
    with open(os.path.join(b, "configs", "cfg", "yolov4.cfg"), "w") as f:
        f.write(tiny_cfg())
    with open(os.path.join(REPO, "benchmark", "configs", "yolov4_coco.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "benchmark", "traffic", "train_v4_b64_608.json")) as f:
        mix = json.load(f)
    mix.update(batch=4, size=64, pool=3, max_objects=6, warmup_steps=1, profiled_steps=2,
               object_sides=[[0.41, 1, 8], [0.34, 8, 24], [0.25, 24, 40]])
    for name, data in (("configs/yolov4_coco.json", dict(config, classes=4)),
                       ("traffic/train_v4_b64_608.json", mix)):
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
        # no kernel on the CPU: the device readers, the loss's and Mish's stay silent
        assert not any(k.startswith(("device_idle", "conv_", "bn_sums_", "yolo_loss", "mish"))
                       for k in result["metrics"])
        assert "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == {"train_img_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_planted_fault_turns_the_cell_incorrect(tmp_path, fault):
    result, status = _run_cell(_tiny_root(str(tmp_path)), fault=fault)
    assert status["rc"] == 0
    assert result["correct"] is False, result["checks"]


def test_the_mish_reader_gives_device_ms_a_step_of_the_mish_kernels():
    spec = importlib.util.spec_from_file_location(
        "mish_ms", os.path.join(REPO, "benchmark", "metrics", "mish_ms.train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    events = [{"cat": "kernel", "name": n, "dur": d} for n, d in (
        ("void at::native::vectorized_elementwise_kernel<4, at::native::mish_kernel(...)", 300.0),
        ("void at::native::elementwise_kernel<128, 2, MISH_backward_kernel>", 200.0),
        ("fsd_bn_act_fwd_vec", 900.0))] + [{"cat": "gpu_memcpy", "name": "mish", "dur": 50.0}]
    trace = types.SimpleNamespace(
        device=events, steps=5,
        seconds=lambda pred: sum(e["dur"] for e in events if pred(e)) / 1e6)
    assert mod.read({"kind": "train", "trace": trace}) == pytest.approx(0.1)
    none = types.SimpleNamespace(device=events[2:], steps=5,
                                 seconds=lambda pred: sum(e["dur"] for e in events[2:]
                                                          if pred(e)) / 1e6)
    assert mod.read({"kind": "train", "trace": none}) is None  # a program without Mish
    assert mod.read({"kind": "train"}) is None


def test_the_calibration_reads_the_cell_with_its_own_driver(tmp_path, capsys):
    """`benchmark/calibrate_yolo4.py` on the tiny cell: a program line, and
    the control's and the half batch's lines, from `train_yolo4`'s
    reference; `calibrate_yolo3`'s driver is left as it was."""
    import sys

    root = _tiny_root(str(tmp_path))
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmark import calibrate_yolo4
    from benchmark.drivers import train_yolo3

    rc = calibrate_yolo4.main(["--workload", CELL, "--seeds", "2147483901",
                               "--controls", "2147483902", "--control", "fp8"],
                              device="cpu", root=root)
    import benchmark.drivers

    assert rc == 0 and benchmark.drivers.train_yolo3 is train_yolo3
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [l["kind"] for l in lines] == ["program", "control_fp8", "fault_half_batch"]
    assert lines[0]["delta_leaf_gap.1"] < 0.5


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
def test_one_step_on_the_card_names_one_mish_kernel_a_call_each_way(card, tiny):
    """One traced step of the tiny cfg on the card: the kernels whose names
    hold "mish" (what `mish_ms` reads) are one a Mish call each way, as
    `train.step` counts them, and both heads have positives."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.common.painting import plain_labels
    from benchmark.drivers import train_yolo3

    _, _, tree = _seeded(tiny, 64, device="cuda")
    spec = build_spec(parse_cfg(tiny))
    trainer = PlainTrainer(spec, image_dtype=torch.bfloat16, device="cuda")
    mom = init_momentum(tree)
    mix = {"background_noise": [0.2, 0.2], "min_objects": 4, "max_objects": 8, "size": 64,
           "object_sides": [[0.5, 4, 10], [0.5, 20, 40]], "aspect": [0.5, 2.0]}
    scenes = train_yolo3.layouts(np.random.default_rng(5), 8, 4, mix)
    batch = {"x": torch.rand(1, 8, 64, 64, 3).to(torch.bfloat16),
             "target": plain_labels(scenes)[None], "keep": np.ones((1, 8), np.float32)}
    trainer.step(tree, mom, batch, seen=64, lr=1e-3)  # cuDNN's first choices, the kernels built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        prof.warm_up_cuda_trace()
        with prof.recording() as spans:
            _, _, metrics = trainer.step(tree, mom, batch, seen=128, lr=1e-3)
            format_loss_line(128, metrics)
        torch.cuda.synchronize()
    (step,) = [s for s in spans if s.name == "train.step"]
    assert (step.counts["mish_forward"], step.counts["mish_backward"]) == (10, 10)
    assert all(v > 0 for v in metrics["positives"].tolist())
    kernels = [ev for ev in p.key_averages() if ev.device_type.name == "CUDA"
               and "mish" in ev.key.lower()]
    assert sum(ev.count for ev in kernels) == 20, [(ev.key, ev.count) for ev in kernels]
