"""A plain-PyTorch reference of YOLOv3's training step, written from the
published description: Redmon and Farhadi, "YOLOv3: An Incremental
Improvement", arXiv:1804.02767, with `cfg/yolov3.cfg` and `yolo_layer.c`
of github.com/pjreddie/darknet. It imports nothing of the program and no
kernel: its own cfg reader, the forward pass (conv + batch norm + leaky,
shortcut, nearest upsample, route concat), the loss and one SGD step, in
plain `torch` operations, NCHW inside and NHWC at the boundary. The same
file serves the CPU tests and the benchmark's correctness check.

Parameters: one dict a conv's index, `{"w": (O, I, k, k), "b": (O,)}` for
a conv without batch norm, `{"w", "gamma", "beta", "mean", "var"}` with
it. The type is the input's: in float32 every operation is float32 (set
TF32 off on a card: `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32`); in bfloat16 the images, each weight as
a product takes it, every convolution's output and every activation are
bfloat16, batch norm takes its statistics in float32 over the bfloat16
values and rounds its affine pair to bfloat16 before it multiplies, and the
loss, the running statistics and the master weights are float32.
`precision` other than "fp32" rounds on top of that, the control of a
correctness check: the operands of every convolution's three products (its
input, its weight, its output's gradient) and every activation a layer
holds, to "tf32" (10 mantissa bits), "fp8" (e4m3 values, e5m2 gradients)
or "int8" (symmetric), one scale a tensor.

The loss is darknet's, summed over the batch. Darknet writes its deltas
straight onto the logits, so the loss whose gradient they are is, for a
head of grid W x H, anchor a of its mask at cell (i, j), an input of
net_w x net_h pixels and s = 2 - w h of the truth it takes:
BCEwithlogits(to, 0) at every prediction whose best IoU with its image's
truths is at most `ignore_thresh`; for each truth, at the prediction of
its best anchor over all of them (when this head's mask holds it) and its
cell (int(x W), int(y H)): s BCEwithlogits(tx, x W - i), the same for y,
s (tw - log(w net_w / aw))^2 / 2, the same for h, BCEwithlogits(to, 1)
and BCEwithlogits(c_k, [k = c]) for each class; a later truth on the same
prediction replaces the box terms and sets its class bit beside the
earlier one's.

Departures from darknet: batch norm as PyTorch's BatchNorm2d (eps 1e-5,
the running statistics moved by 0.1 towards the batch mean and the
unbiased variance), the convention the port trains every darknet cfg with,
where darknet's C code uses eps 1e-6 and moves them by 0.01; the optimizer
is SGD with momentum handed lr / batch and decay x batch on conv weights
alone (the PyTorch darknet ports' `train.py`); at most 50 truths an image,
where darknet reads 90; no `truth_thresh` branch (at the published 1 it
never fires); a truth's cell clamped into the grid; one 0/1 `keep` weight
an image on all of its terms; one input size (no `random` resizing).
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
    """One layer of the walk. `kind` is conv, shortcut, route, upsample or
    yolo; a yolo layer's `anchors` are all of the cfg's, (w, h) in input
    pixels, and its `mask` the indices it predicts. No conv is `dynamic`:
    darknet's cfgs for YOLOv3 have none."""

    def __init__(self, index, kind, c_in=0, c_out=0, side_in=0, side_out=0, size=0, stride=1,
                 pad=0, bn=False, activation="linear", sources=(), mask=(), anchors=(),
                 classes=0, ignore_thresh=0.5):
        self.index, self.kind, self.c_in, self.c_out = index, kind, c_in, c_out
        self.side_in, self.side_out, self.size, self.stride = side_in, side_out, size, stride
        self.pad, self.bn, self.activation, self.dynamic = pad, bn, activation, False
        self.sources, self.mask, self.anchors = sources, mask, anchors
        self.classes, self.ignore_thresh = classes, ignore_thresh


def walk(blocks: list[dict], side: int | None = None) -> list[Layer]:
    """The layers of a parsed YOLOv3-style cfg at input side `side`
    (default: the header's width). A conv pads (size - 1) // 2 when
    `pad=1`; a route takes its first source's side and sums its sources'
    channels; a shortcut adds its `from` layer to the previous one."""
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
                          ignore_thresh=float(b.get("ignore_thresh", "0.5")))
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
    """conv [+ batch norm | + bias] [+ leaky] of NCHW x, in x's type."""
    y = F.conv2d(rounded(x, precision), rounded(p["w"].to(x.dtype), precision), None,
                 layer.stride, layer.pad)
    y = stored(y, precision)
    if layer.bn:
        y = stored(_batch_norm(y, p, train, moved), precision)
    else:
        y = y + p["b"].to(y.dtype)[None, :, None, None]
    if layer.activation == "leaky":
        y = stored(F.leaky_relu(y, LEAKY), precision)
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
    return torch.stack([(i + torch.sigmoid(o[..., 0])) / w, (j + torch.sigmoid(o[..., 1])) / h,
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


def yolo_loss(heads: list[torch.Tensor], layers: list[Layer], target: torch.Tensor,
              keep: torch.Tensor, net_wh: tuple[int, int]) -> torch.Tensor:
    """The summed loss of the heads (NHWC, (nB, H, W, A (5 + nC))) against
    target (nB, 50, 5) normalised [cls, x, y, w, h], zero-padded, the
    truths of an image ending at its first row with x = 0; keep (nB,) 0/1;
    net_wh the input's (width, height). Float32 whatever the heads' type."""
    net_w, net_h = net_wh
    yolos = [l for l in layers if l.kind == "yolo"]
    rows = target.detach().float().cpu().tolist()
    truths = [[r for r in rows_b[:next((k for k, r in enumerate(rows_b) if r[1] == 0),
                                        len(rows_b))]] for rows_b in rows]
    keep = keep.float()
    loss = torch.zeros((), device=heads[0].device)
    for head, layer in zip(heads, yolos):
        nb, h, w, _ = head.shape
        a_n, n_c = len(layer.mask), layer.classes
        o = head.float().reshape(nb, h, w, a_n, 5 + n_c)
        with torch.no_grad():
            boxes = _pred_boxes(o.detach(), layer, net_w, net_h)
            quiet = torch.stack([
                _best_ious(boxes[b], torch.tensor([r[1:5] for r in truths[b]],
                                                  dtype=torch.float32,
                                                  device=o.device).reshape(-1, 4))
                for b in range(nb)]) > layer.ignore_thresh
        # the predictions the truths take, in the truths' order: a later
        # truth's box replaces an earlier one's, its class joins the others
        cells: dict = {}
        for b in range(nb):
            for c, x, y, tw_, th_ in truths[b]:
                best, best_iou = 0, 0.0
                for n, (aw, ah) in enumerate(layer.anchors):
                    iou = _iou((0.0, 0.0, aw / net_w, ah / net_h), (0.0, 0.0, tw_, th_))
                    if iou > best_iou:
                        best, best_iou = n, iou
                if best not in layer.mask:
                    continue
                a = layer.mask.index(best)
                i, j = min(int(x * w), w - 1), min(int(y * h), h - 1)
                aw, ah = layer.anchors[best]
                box = (x * w - i, y * h - j, float(np.log(tw_ * net_w / aw)),
                       float(np.log(th_ * net_h / ah)), 2.0 - tw_ * th_)
                classes = cells[(b, j, i, a)][1] if (b, j, i, a) in cells else set()
                cells[(b, j, i, a)] = (box, classes | {int(c)})
        pos = torch.zeros((nb, h, w, a_n), dtype=torch.bool, device=o.device)
        if cells:
            idx = torch.tensor(list(cells), device=o.device)
            b_, j_, i_, a_ = idx.unbind(1)
            pos[b_, j_, i_, a_] = True
            t = torch.tensor([box for box, _ in cells.values()], device=o.device)
            labels = torch.zeros((len(cells), n_c))
            for r, (_, classes) in enumerate(cells.values()):
                labels[r, sorted(classes)] = 1.0
            labels = labels.to(o.device)
            p = o[b_, j_, i_, a_]  # (P, 5 + nC)
            k = keep[b_]
            s = t[:, 4] * k
            loss = (loss + torch.sum(s * F.binary_cross_entropy_with_logits(
                        p[:, 0], t[:, 0], reduction="none"))
                    + torch.sum(s * F.binary_cross_entropy_with_logits(
                        p[:, 1], t[:, 1], reduction="none"))
                    + torch.sum(s * (p[:, 2] - t[:, 2]) ** 2) / 2
                    + torch.sum(s * (p[:, 3] - t[:, 3]) ** 2) / 2
                    + torch.sum(k * F.binary_cross_entropy_with_logits(
                        p[:, 4], torch.ones_like(p[:, 4]), reduction="none"))
                    + torch.sum(k[:, None] * F.binary_cross_entropy_with_logits(
                        p[:, 5:], labels, reduction="none")))
        empty = (~pos & ~quiet).float() * keep[:, None, None, None]
        loss = loss + torch.sum(empty * F.binary_cross_entropy_with_logits(
            o[..., 4], torch.zeros_like(o[..., 4]), reduction="none"))
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
