"""A plain-PyTorch reference of YOLOv4's training step, written from the
published description: Bochkovskiy, Wang and Liao, "YOLOv4: Optimal Speed
and Accuracy of Object Detection", arXiv:2004.10934, with `cfg/yolov4.cfg`
and `yolo_layer.c` of github.com/AlexeyAB/darknet; its box loss, CIoU, from
Zheng et al., arXiv:1911.08287; its activation, Mish, from Misra,
arXiv:1908.08681. It imports nothing of the program and no kernel: its own
cfg reader, the forward pass (conv + batch norm + leaky or Mish, shortcut,
stride-1 max pools, nearest upsample, route concat of any number of
sources), the loss and one SGD step, in plain `torch` operations, NCHW
inside and NHWC at the boundary. Its cfg reader, layer walk, roundings and
batch norm are those of `yolov3.py` beside it, copied and extended. The
same file serves the CPU tests and the benchmark's correctness check.

Parameters: one dict a conv's index, `{"w": (O, I, k, k), "b": (O,)}` for
a conv without batch norm, `{"w", "gamma", "beta", "mean", "var"}` with
it. The type is the input's: in float32 every operation is float32 (set
TF32 off on a card: `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32`); in bfloat16 the images, each weight as
a product takes it, every convolution's output and every activation are
bfloat16 (Mish computed in float32 from the bfloat16 value and rounded
once), batch norm takes its statistics in float32 over the bfloat16 values
and rounds its affine pair to bfloat16 before it multiplies, and the loss,
the running statistics and the master weights are float32. `precision`
other than "fp32" rounds on top of that, the control of a correctness
check: the operands of every convolution's three products (its input, its
weight, its output's gradient) and every activation a layer holds, to
"tf32" (10 mantissa bits), "fp8" (e4m3 values, e5m2 gradients) or "int8"
(symmetric), one scale a tensor.

Mish is x tanh(softplus(x)). A stride-1 max pool of odd size k takes the
k x k window centred on its output, positions outside the map left out
(darknet's maxpool_layer.c with pad k - 1): `F.max_pool2d(x, k, 1, k // 2)`.

The loss is darknet's, summed over the batch, written as the loss whose
gradient darknet's deltas are. For a head of grid W x H with `scale_x_y` s,
anchor a of its mask at cell (i, j) and an input of net_w x net_h pixels,
the predicted box is ((i + s sig(tx) - (s - 1) / 2) / W, (j + s sig(ty) -
(s - 1) / 2) / H, exp(tw) aw / net_w, exp(th) ah / net_h). Every
prediction whose best IoU with its image's truths is at most
`ignore_thresh` takes BCEwithlogits(to, 0). Each truth, in order, is
assigned to its best anchor over all of them (by the IoU of boxes of its
and the anchor's sizes at one centre), then to each other anchor in
order whose such IoU exceeds the head's `iou_thresh`; an assignment to an
anchor of this head's mask takes the prediction of that anchor at the
truth's cell (int(x W), int(y H)): the box term times `iou_normalizer`,
BCEwithlogits(to, 1), and BCEwithlogits(c_k, [k = c]) for each class
times `cls_normalizer`. The box term is, with `iou_loss=ciou`, 1 - CIoU of
the predicted box and the truth: CIoU = IoU - rho^2 / c^2 - alpha v, rho
the distance of the centres, c the diagonal of the smallest box holding
both, v = 4 / pi^2 (atan(w / h) - atan(bw / bh))^2, alpha = v / (1 - IoU +
v) without gradient (0 where v is 0); with `iou_loss=mse`, YOLOv3's
(`yolov3.py`). A later assignment on the same prediction replaces the box
terms and sets its class bit beside the earlier one's.

Departures from darknet: batch norm as PyTorch's BatchNorm2d (eps 1e-5,
the running statistics moved by 0.1 towards the batch mean and the
unbiased variance), the convention the port trains every darknet cfg with;
the optimizer is SGD with momentum handed lr / batch and decay x batch on
conv weights alone (the PyTorch darknet ports' `train.py`); at most 50
truths an image, where darknet reads 90; no `truth_thresh` branch (at the
published 1 it never fires); a truth's cell clamped into the grid; one 0/1
`keep` weight an image on all of its terms; one input size (no `random`
resizing) and no mosaic; the gradients are autograd's of the loss above,
not darknet's hand-derived CIoU deltas, and no `max_delta` clip; a later
assignment on a prediction replaces the box terms where AlexeyAB's
darknet adds them; Mish is computed without darknet's softplus threshold
of 20 (a value above it changes by less than float32 resolves).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LEAKY = 0.1


def parse(path: str) -> list[dict]:
    """The cfg's blocks in order: `{"type": name, key: value, ...}`, values
    as strings, comments (`#`, `;`) and blank lines dropped."""
    blocks: list[dict] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].split(";")[0].strip()
            if not line:
                continue
            if line.startswith("["):
                blocks.append({"type": line.strip("[]").strip()})
            else:
                key, value = line.split("=", 1)
                blocks[-1][key.strip()] = value.strip()
    return blocks


class Layer:
    """One layer of the walk. `kind` is conv, shortcut, route, maxpool,
    upsample or yolo; a yolo layer's `anchors` are all of the cfg's, (w, h)
    in input pixels, its `mask` the indices it predicts, and `yolo` its
    YOLOv4 keys (scale_x_y, iou_thresh, iou_normalizer, cls_normalizer,
    iou_loss). No conv is `dynamic`: darknet's cfgs for YOLOv4 have none."""

    def __init__(self, index, kind, c_in=0, c_out=0, side_in=0, side_out=0, size=0, stride=1,
                 pad=0, bn=False, activation="linear", sources=(), mask=(), anchors=(),
                 classes=0, ignore_thresh=0.5, yolo=None):
        self.index, self.kind, self.c_in, self.c_out = index, kind, c_in, c_out
        self.side_in, self.side_out, self.size, self.stride = side_in, side_out, size, stride
        self.pad, self.bn, self.activation, self.dynamic = pad, bn, activation, False
        self.sources, self.mask, self.anchors = sources, mask, anchors
        self.classes, self.ignore_thresh, self.yolo = classes, ignore_thresh, yolo


def walk(blocks: list[dict], side: int | None = None) -> list[Layer]:
    """The layers of a parsed YOLOv4-style cfg at input side `side`
    (default: the header's width). A conv pads (size - 1) // 2 when
    `pad=1`; a route takes its first source's side and sums its sources'
    channels; a shortcut adds its `from` layer to the previous one; a max
    pool of stride 1 keeps the side (odd sizes only)."""
    header = blocks[0]
    side = int(header["width"]) if side is None else side
    c = int(header["channels"])
    out_c: list[int] = []
    out_side: list[int] = []
    layers: list[Layer] = []
    for i, b in enumerate(blocks[1:]):
        kind = b["type"]
        if kind == "convolutional":
            size, stride = int(b["size"]), int(b["stride"])
            pad = (size - 1) // 2 if int(b.get("pad", "0")) else 0
            s_out = (side + 2 * pad - size) // stride + 1
            layer = Layer(i, "conv", c, int(b["filters"]), side, s_out, size, stride, pad,
                          bool(int(b.get("batch_normalize", "0"))), b.get("activation", "linear"))
        elif kind == "shortcut":
            src = int(b["from"])
            src = src if src >= 0 else src + i
            layer = Layer(i, "shortcut", c, c, side, side, activation=b.get("activation", "linear"),
                          sources=(src, i - 1))
        elif kind == "route":
            srcs = tuple(int(v) if int(v) >= 0 else int(v) + i for v in b["layers"].split(","))
            layer = Layer(i, "route", c, sum(out_c[s] for s in srcs), side, out_side[srcs[0]],
                          sources=srcs)
        elif kind == "maxpool":
            size, stride = int(b["size"]), int(b["stride"])
            if stride != 1 or size % 2 == 0:
                raise ValueError(f"layer {i}: the reference pools with stride 1 and odd sizes")
            layer = Layer(i, "maxpool", c, c, side, side, size=size, stride=1)
        elif kind == "upsample":
            s = int(b["stride"])
            layer = Layer(i, "upsample", c, c, side, side * s, stride=s)
        elif kind == "yolo":
            vals = [float(v) for v in b["anchors"].split(",")]
            layer = Layer(i, "yolo", c, c, side, side,
                          mask=tuple(int(m) for m in b["mask"].split(",")),
                          anchors=tuple((vals[2 * n], vals[2 * n + 1])
                                        for n in range(int(b["num"]))),
                          classes=int(b["classes"]),
                          ignore_thresh=float(b.get("ignore_thresh", "0.5")),
                          yolo={"scale_x_y": float(b.get("scale_x_y", "1")),
                                "iou_thresh": float(b.get("iou_thresh", "1")),
                                "iou_normalizer": float(b.get("iou_normalizer", "1")),
                                "cls_normalizer": float(b.get("cls_normalizer", "1")),
                                "iou_loss": b.get("iou_loss", "mse")})
        else:
            raise ValueError(f"layer {i}: the reference does not know the kind {kind!r}")
        layers.append(layer)
        c, side = layer.c_out, layer.side_out
        out_c.append(c)
        out_side.append(side)
    return layers


# -- rounding below the computing type (the controls) ------------------------


def _round(t: torch.Tensor, precision: str, grad: bool = False) -> torch.Tensor:
    """t rounded to `precision` (a gradient with `grad`), back in t's type."""
    if t.dtype != torch.float32:
        return _round(t.float(), precision, grad).to(t.dtype)
    if precision == "tf32":
        bits = t.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF  # to nearest at 10 mantissa bits
        return bits.view(torch.float32)
    if precision == "fp8":
        fmt, top = (torch.float8_e5m2, 57344.0) if grad else (torch.float8_e4m3fn, 448.0)
        scale = t.abs().amax().clamp(min=1e-30) / top
        return (t / scale).to(fmt).float() * scale
    if precision == "int8":
        scale = t.abs().amax().clamp(min=1e-30) / 127.0
        return torch.clamp(torch.round(t / scale), -127, 127) * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Operand(torch.autograd.Function):
    """An operand rounded; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, t, precision):
        return _round(t, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradOperand(torch.autograd.Function):
    """A value unchanged; its gradient rounded on the way back."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision, grad=True), None


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    return t if precision == "fp32" else _Operand.apply(t, precision)


def stored(t: torch.Tensor, precision: str) -> torch.Tensor:
    """An activation held at `precision`, value and gradient."""
    return t if precision == "fp32" else _GradOperand.apply(_Operand.apply(t, precision),
                                                            precision)


# -- the forward pass -------------------------------------------------------


def _batch_norm(y: torch.Tensor, p: dict, train: bool, moved: set | None) -> torch.Tensor:
    """Batch norm of NCHW y: biased batch statistics in float32 normalise,
    the affine pair is formed in float32 and taken in y's type; in training
    the running statistics move by 0.1 towards the batch mean and the
    unbiased batch variance, once a step (`moved` holds the ids of those
    already moved, for a layer computed again in the backward)."""
    if train:
        var, mean = torch.var_mean(y.float(), dim=(0, 2, 3), correction=0)
        if moved is None or id(p) not in moved:
            if moved is not None:
                moved.add(id(p))
            n = y.numel() // y.shape[1]
            with torch.no_grad():
                p["mean"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                p["var"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / max(n - 1, 1)))
    else:
        mean, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + BN_EPS) * p["gamma"]
    bias = p["beta"] - mean * inv
    return y * inv.to(y.dtype)[None, :, None, None] + bias.to(y.dtype)[None, :, None, None]


def _conv(layer: Layer, p: dict, x: torch.Tensor, train: bool, precision: str, moved):
    """conv [+ batch norm | + bias] [+ leaky | + Mish] of NCHW x, in x's
    type."""
    y = F.conv2d(rounded(x, precision), rounded(p["w"].to(x.dtype), precision), None,
                 layer.stride, layer.pad)
    y = stored(y, precision)
    if layer.bn:
        y = stored(_batch_norm(y, p, train, moved), precision)
    else:
        y = y + p["b"].to(y.dtype)[None, :, None, None]
    if layer.activation == "leaky":
        y = stored(F.leaky_relu(y, LEAKY), precision)
    elif layer.activation == "mish":
        z = y.float()
        y = stored((z * torch.tanh(F.softplus(z))).to(y.dtype), precision)
    elif layer.activation != "linear":
        raise ValueError(f"layer {layer.index}: activation {layer.activation!r}")
    return y


def forward(layers: list[Layer], params: dict, x: torch.Tensor, *, train: bool,
            precision: str = "fp32", recompute: bool = False) -> list[torch.Tensor]:
    """The net on NHWC x, in x's type; returns each [yolo] head's input,
    NHWC, in order. `recompute` keeps only each convolution's input for the
    backward and computes the layer again there (the same values), so that
    a large batch fits."""
    x = x.permute(0, 3, 1, 2)
    outs: dict = {}
    heads = []
    moved = set() if recompute else None
    for layer in layers:
        if layer.kind == "conv":
            args = (layer, params[layer.index], x, train, precision, moved)
            x = checkpoint(_conv, *args, use_reentrant=False) if recompute else _conv(*args)
        elif layer.kind == "shortcut":
            x = stored(outs[layer.sources[0]] + outs[layer.sources[1]], precision)
        elif layer.kind == "route":
            parts = [outs[s] for s in layer.sources]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        elif layer.kind == "maxpool":
            x = F.max_pool2d(x, layer.size, 1, layer.size // 2)
        elif layer.kind == "upsample":
            s = layer.stride
            x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        elif layer.kind == "yolo":
            heads.append(x.permute(0, 2, 3, 1))
        outs[layer.index] = x
    return heads


# -- the loss ---------------------------------------------------------------


def _iou(a, b) -> float:
    """darknet's box_iou of two centre-format boxes (x, y, w, h)."""
    def overlap(x1, w1, x2, w2):
        return min(x1 + w1 / 2, x2 + w2 / 2) - max(x1 - w1 / 2, x2 - w2 / 2)

    w = overlap(a[0], a[2], b[0], b[2])
    h = overlap(a[1], a[3], b[1], b[3])
    if w < 0 or h < 0:
        return 0.0
    inter = w * h
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def _pred_boxes(o: torch.Tensor, layer: Layer, net_w: int, net_h: int) -> torch.Tensor:
    """(nB, H, W, A, 4) boxes (x, y, w, h) of the logits o, in [0, 1]."""
    _, h, w, _, _ = o.shape
    anchors = torch.tensor([layer.anchors[n] for n in layer.mask], dtype=torch.float32,
                           device=o.device)
    i = torch.arange(w, device=o.device, dtype=torch.float32)[None, None, :, None]
    j = torch.arange(h, device=o.device, dtype=torch.float32)[None, :, None, None]
    s = layer.yolo["scale_x_y"]
    return torch.stack([(i + s * torch.sigmoid(o[..., 0]) - (s - 1) / 2) / w,
                        (j + s * torch.sigmoid(o[..., 1]) - (s - 1) / 2) / h,
                        torch.exp(o[..., 2]) * anchors[:, 0] / net_w,
                        torch.exp(o[..., 3]) * anchors[:, 1] / net_h], -1)


def _best_ious(boxes: torch.Tensor, truths: torch.Tensor) -> torch.Tensor:
    """Each box's largest IoU with the truths (k, 4), or 0 without any."""
    if truths.shape[0] == 0:
        return torch.zeros(boxes.shape[:-1], device=boxes.device)
    a, b = boxes[..., None, :], truths
    w = (torch.minimum(a[..., 0] + a[..., 2] / 2, b[:, 0] + b[:, 2] / 2)
         - torch.maximum(a[..., 0] - a[..., 2] / 2, b[:, 0] - b[:, 2] / 2))
    h = (torch.minimum(a[..., 1] + a[..., 3] / 2, b[:, 1] + b[:, 3] / 2)
         - torch.maximum(a[..., 1] - a[..., 3] / 2, b[:, 1] - b[:, 3] / 2))
    inter = torch.where((w < 0) | (h < 0), torch.zeros_like(w), w * h)
    iou = inter / (a[..., 2] * a[..., 3] + b[:, 2] * b[:, 3] - inter)
    return iou.amax(-1).clamp(min=0)


def _ciou(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """CIoU of boxes p and t, (P, 4) centre format: IoU - rho^2 / c^2 -
    alpha v."""
    px, py, pw, ph = p.unbind(-1)
    tx, ty, tw, th = t.unbind(-1)
    left, right = torch.maximum(px - pw / 2, tx - tw / 2), torch.minimum(px + pw / 2, tx + tw / 2)
    top, bottom = torch.maximum(py - ph / 2, ty - th / 2), torch.minimum(py + ph / 2, ty + th / 2)
    inter = (right - left).clamp(min=0) * (bottom - top).clamp(min=0)
    iou = inter / (pw * ph + tw * th - inter)
    cw = torch.maximum(px + pw / 2, tx + tw / 2) - torch.minimum(px - pw / 2, tx - tw / 2)
    ch = torch.maximum(py + ph / 2, ty + th / 2) - torch.minimum(py - ph / 2, ty - th / 2)
    rho2 = (px - tx) ** 2 + (py - ty) ** 2
    v = 4 / np.pi ** 2 * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
    with torch.no_grad():
        alpha = torch.where(v > 0, v / (1 - iou + v), torch.zeros_like(v))
    return iou - rho2 / (cw ** 2 + ch ** 2) - alpha * v


def yolo_loss(heads: list[torch.Tensor], layers: list[Layer], target: torch.Tensor,
              keep: torch.Tensor, net_wh: tuple[int, int], terms: dict | None = None
              ) -> torch.Tensor:
    """The summed loss of the heads (NHWC, (nB, H, W, A (5 + nC))) against
    target (nB, 50, 5) normalised [cls, x, y, w, h], zero-padded, the
    truths of an image ending at its first row with x = 0; keep (nB,) 0/1;
    net_wh the input's (width, height). Float32 whatever the heads' type.
    `terms`, where given, gets each term's sum (`box`, `obj`, `noobj`,
    `cls`) and the assignments that took a prediction beyond the truths'
    best anchors (`extra`, a count)."""
    net_w, net_h = net_wh
    yolos = [l for l in layers if l.kind == "yolo"]
    rows = target.detach().float().cpu().tolist()
    truths = [[r for r in rows_b[:next((k for k, r in enumerate(rows_b) if r[1] == 0),
                                        len(rows_b))]] for rows_b in rows]
    keep = keep.float()
    loss = torch.zeros((), device=heads[0].device)
    sums = {"box": 0.0, "obj": 0.0, "noobj": 0.0, "cls": 0.0, "extra": 0}
    for head, layer in zip(heads, yolos):
        nb, h, w, _ = head.shape
        a_n, n_c, yk = len(layer.mask), layer.classes, layer.yolo
        o = head.float().reshape(nb, h, w, a_n, 5 + n_c)
        with torch.no_grad():
            boxes = _pred_boxes(o.detach(), layer, net_w, net_h)
            quiet = torch.stack([
                _best_ious(boxes[b], torch.tensor([r[1:5] for r in truths[b]],
                                                  dtype=torch.float32,
                                                  device=o.device).reshape(-1, 4))
                for b in range(nb)]) > layer.ignore_thresh
        # the predictions the assignments take, in order (each truth's best
        # anchor, then its other anchors above iou_thresh): a later
        # assignment's box replaces an earlier one's, its class joins the others
        cells: dict = {}
        for b in range(nb):
            for c, x, y, tw_, th_ in truths[b]:
                ious = [_iou((0.0, 0.0, aw / net_w, ah / net_h), (0.0, 0.0, tw_, th_))
                        for aw, ah in layer.anchors]
                best, best_iou = 0, 0.0
                for n, iou in enumerate(ious):
                    if iou > best_iou:
                        best, best_iou = n, iou
                order = [best] + [n for n in range(len(layer.anchors))
                                  if n != best and ious[n] > yk["iou_thresh"]]
                for n in order:
                    if n not in layer.mask:
                        continue
                    a = layer.mask.index(n)
                    i, j = min(int(x * w), w - 1), min(int(y * h), h - 1)
                    aw, ah = layer.anchors[n]
                    box = (x, y, tw_, th_, x * w - i, y * h - j, float(np.log(tw_ * net_w / aw)),
                           float(np.log(th_ * net_h / ah)), 2.0 - tw_ * th_)
                    classes = cells[(b, j, i, a)][1] if (b, j, i, a) in cells else set()
                    cells[(b, j, i, a)] = (box, classes | {int(c)}, n != best)
        pos = torch.zeros((nb, h, w, a_n), dtype=torch.bool, device=o.device)
        if cells:
            idx = torch.tensor(list(cells), device=o.device)
            b_, j_, i_, a_ = idx.unbind(1)
            pos[b_, j_, i_, a_] = True
            t = torch.tensor([box for box, _, _ in cells.values()], device=o.device)
            labels = torch.zeros((len(cells), n_c))
            for r, (_, classes, _) in enumerate(cells.values()):
                labels[r, sorted(classes)] = 1.0
            labels = labels.to(o.device)
            sums["extra"] += sum(int(keep[b] > 0) for (b, *_), (_, _, extra) in cells.items()
                                 if extra)
            p = o[b_, j_, i_, a_]  # (P, 5 + nC)
            k = keep[b_]
            if yk["iou_loss"] == "ciou":
                s = yk["scale_x_y"]
                anchors = torch.tensor([layer.anchors[layer.mask[int(v)]] for v in a_],
                                       dtype=torch.float32, device=o.device)
                pred = torch.stack([(i_ + s * torch.sigmoid(p[:, 0]) - (s - 1) / 2) / w,
                                    (j_ + s * torch.sigmoid(p[:, 1]) - (s - 1) / 2) / h,
                                    torch.exp(p[:, 2]) * anchors[:, 0] / net_w,
                                    torch.exp(p[:, 3]) * anchors[:, 1] / net_h], -1)
                box = torch.sum(k * (1 - _ciou(pred, t[:, :4])))
            elif yk["iou_loss"] == "mse":
                sc = t[:, 8] * k
                box = (torch.sum(sc * F.binary_cross_entropy_with_logits(
                           p[:, 0], t[:, 4], reduction="none"))
                       + torch.sum(sc * F.binary_cross_entropy_with_logits(
                           p[:, 1], t[:, 5], reduction="none"))
                       + torch.sum(sc * (p[:, 2] - t[:, 6]) ** 2) / 2
                       + torch.sum(sc * (p[:, 3] - t[:, 7]) ** 2) / 2)
            else:
                raise ValueError(f"iou_loss {yk['iou_loss']!r}")
            obj = torch.sum(k * F.binary_cross_entropy_with_logits(
                p[:, 4], torch.ones_like(p[:, 4]), reduction="none"))
            cls = torch.sum(k[:, None] * F.binary_cross_entropy_with_logits(
                p[:, 5:], labels, reduction="none"))
            loss = loss + yk["iou_normalizer"] * box + obj + yk["cls_normalizer"] * cls
            sums["box"] += float(yk["iou_normalizer"] * box.detach())
            sums["obj"] += float(obj.detach())
            sums["cls"] += float(yk["cls_normalizer"] * cls.detach())
        empty = (~pos & ~quiet).float() * keep[:, None, None, None]
        noobj = torch.sum(empty * F.binary_cross_entropy_with_logits(
            o[..., 4], torch.zeros_like(o[..., 4]), reduction="none"))
        loss = loss + noobj
        sums["noobj"] += float(noobj.detach())
    if terms is not None:
        terms.update(sums)
    return loss


# -- one training step ------------------------------------------------------


def train_step(layers: list[Layer], params: dict, mom: dict, x: torch.Tensor,
               target: torch.Tensor, keep: torch.Tensor, *, lr: float, momentum: float,
               decay: float, precision: str = "fp32", recompute: bool = False,
               loss_scale: float = 1.0) -> float:
    """One SGD step, in place: the loss (times `loss_scale`) of the batch,
    its gradient for every leaf but the running statistics (each of which
    must require a gradient), d = g + decay * w on conv weights (g alone on
    batch norm's affine pair and the biases), mom = momentum * mom + d,
    leaf -= lr * mom. `mom` maps "index.key" to a tensor of the leaf's
    shape. Returns the loss."""
    names = [(i, k) for i, p in params.items() for k in p if k not in ("mean", "var")]
    heads = forward(layers, params, x, train=True, precision=precision, recompute=recompute)
    loss = yolo_loss(heads, layers, target, keep, (x.shape[2], x.shape[1])) * loss_scale
    grads = torch.autograd.grad(loss, [params[i][k] for i, k in names], allow_unused=True)
    with torch.no_grad():
        for (i, k), g in zip(names, grads):
            leaf = params[i][k]
            d = torch.zeros_like(leaf) if g is None else g
            if k == "w":
                d = d + decay * leaf
            m = mom[f"{i}.{k}"]
            m.mul_(momentum).add_(d)
            leaf.sub_(lr * m)
    return float(loss.detach())
