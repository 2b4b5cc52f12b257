"""The [yolo] heads' loss (YOLOv3's and YOLOv4's), targets built on the
device.

The semantics are darknet's `yolo_layer.c` (forward_yolo_layer,
delta_yolo_box, delta_yolo_class), summed over the batch. Darknet writes
its deltas straight onto the head's logits, so the loss whose gradient they
are is, for a head with grid W x H, anchor a of its mask at cell (i, j), an
input of net_w x net_h pixels and the head's `scale_x_y` s (1 in YOLOv3):

  * the predicted box is bx = (i + s sig(tx) - (s - 1) / 2) / W, by alike,
    bw = exp(tw) * aw / net_w, bh = exp(th) * ah / net_h (sig: the logistic)
  * every prediction takes BCEwithlogits(to, 0), except where its best IoU
    with any truth of its image exceeds the head's `ignore_thresh`
  * a truth (x, y, w, h, c) goes to its best anchor n*, the argmax over ALL
    the anchors of the IoU of (0, 0, w, h) with (0, 0, aw / net_w,
    ah / net_h) (the first on a tie), and, where the head's `iou_thresh` is
    below 1 (YOLOv4), to every other anchor of a mask whose IoU with it
    exceeds `iou_thresh`. Each such assignment in a head's mask takes the
    prediction at (floor(x W), floor(y H), n): its box terms, BCEwithlogits
    (to, 1) in place of its no-object term, and BCEwithlogits(c_k, [k = c])
    over the classes times `cls_normalizer`
  * the box terms, times `iou_normalizer`: with `iou_loss=mse` (YOLOv3), for
    sc = 2 - w h, sc BCEwithlogits(tx, x W - i) and the same for y,
    sc (tw - log(w net_w / aw))^2 / 2 and the same for h; with
    `iou_loss=ciou` (YOLOv4; Zheng et al., arXiv:1911.08287), 1 - CIoU of
    the predicted box and the truth, CIoU = IoU - rho^2 / c^2 - alpha v,
    rho the distance of the centres, c the diagonal of the smallest box
    holding both, v = 4 / pi^2 (atan(w / h) - atan(bw / bh))^2 and
    alpha = v / (1 - IoU + v) held without gradient (no sc factor)
  * the assignments are taken truth by truth, each truth's best anchor
    first and then its other anchors in order; where a later assignment
    lands on a prediction already taken, its box terms replace the earlier
    ones and its class bit is set beside the earlier one's (pjreddie's
    delta_yolo_box and delta_yolo_class on a delta already written)

Departures: at most 50 truths an image (the port's label layout; darknet
reads 90); no `truth_thresh` branch (at the published 1 it never fires);
a truth's cell is clamped into the grid (darknet's int() reaches W only
for a centre at the image's edge); `keep` (one 0/1 weight an image, the
plain trainer's) weighs every term of its image. For YOLOv4 besides: the
gradients are autograd's of the loss above, not darknet's hand-derived
CIoU deltas (dx_box_iou); no `max_delta` clip; a later assignment on a
prediction replaces the box terms where AlexeyAB's darknet adds them; the
`mse` box terms take no `scale_x_y` (a spec that asks for both is refused).

The heads are laid end to end, so each step of the loss runs once for all
of them. Nothing synchronises with the host: each assignment's anchor,
prediction and winner (the last assignment on its prediction) are found
with fixed shapes (a truth slot's best anchor, then, where any head has an
`iou_thresh` below 1, one candidate an anchor of the cfg), the assigned
predictions are gathered at the assignments, and only the ignore mask's IoU
and the no-object term run over every prediction. With YOLOv3's keys there
is one assignment a truth slot and the loss is the same operations on the
same values as before YOLOv4's keys were read.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from ..models.spec import YoloSpec


@functools.lru_cache(maxsize=64)
def _layout(grids: tuple, specs: tuple, net_wh: tuple, device: torch.device) -> dict:
    """Constants of the heads' predictions laid end to end (head by head,
    each (H, W, A) in row-major order), made once a layout and device (a
    tensor built from a list at every step would copy from pageable memory
    and wait): per prediction its cell (i, j), its grid's sides, its
    anchor normalised by the input and its head's ignore threshold; per
    anchor of the cfg the head whose mask holds it (-1: none), its place in
    that mask, that head's grid, anchors a cell and first prediction; and
    the anchors normalised by the input. YOLOv4's keys take constants only
    where some head sets them off their neutral value: `scale` and `shift`
    (each prediction's `scale_x_y` and (s - 1) / 2) with `a_scale` and
    `a_shift` (each anchor's), `a_iou_thresh` (an anchor no head holds
    takes none beyond its best), `a_iou_norm` and `a_cls_norm`; YOLOv3's
    heads hold what they held before."""
    net_w, net_h = net_wh
    per_pred = {k: [] for k in ("i", "j", "w", "h", "aw", "ah", "thresh", "scale", "shift")}
    n_anchors = specs[0].num
    per_anchor = {k: [-1] * n_anchors for k in ("head", "slot", "grid_w", "grid_h", "a", "first")}
    per_anchor_f = {"a_scale": [1.0] * n_anchors, "a_shift": [0.0] * n_anchors,
                    "a_iou_thresh": [float("inf")] * n_anchors,
                    "a_iou_norm": [1.0] * n_anchors, "a_cls_norm": [1.0] * n_anchors}
    first = 0
    for head, ((gh, gw), spec) in enumerate(zip(grids, specs)):
        n_a = len(spec.mask)
        shift = (spec.scale_x_y - 1) / 2
        for j in range(gh):
            for i in range(gw):
                for n in spec.mask:
                    aw, ah = spec.anchor_wh[n]
                    for k, v in (("i", i), ("j", j), ("w", gw), ("h", gh), ("aw", aw / net_w),
                                 ("ah", ah / net_h), ("thresh", spec.ignore_thresh),
                                 ("scale", spec.scale_x_y), ("shift", shift)):
                        per_pred[k].append(v)
        for slot, n in enumerate(spec.mask):
            for k, v in (("head", head), ("slot", slot), ("grid_w", gw), ("grid_h", gh),
                         ("a", n_a), ("first", first)):
                per_anchor[k][n] = v
            for k, v in (("a_scale", spec.scale_x_y), ("a_shift", shift),
                         ("a_iou_thresh", spec.iou_thresh), ("a_iou_norm", spec.iou_normalizer),
                         ("a_cls_norm", spec.cls_normalizer)):
                per_anchor_f[k][n] = v
        first += gh * gw * n_a
    floats = per_pred | per_anchor_f
    for keys, neutral in ((("scale", "shift", "a_scale", "a_shift"),
                           all(s.scale_x_y == 1.0 for s in specs)),
                          (("a_iou_thresh",), all(s.iou_thresh >= 1.0 for s in specs)),
                          (("a_iou_norm",), all(s.iou_normalizer == 1.0 for s in specs)),
                          (("a_cls_norm",), all(s.cls_normalizer == 1.0 for s in specs))):
        if neutral:
            for k in keys:
                del floats[k]
    out = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in floats.items()}
    out.update({k: torch.tensor(v, dtype=torch.int64, device=device)
                for k, v in per_anchor.items()})
    out["anchors"] = torch.tensor([(aw / net_w, ah / net_h) for aw, ah in specs[0].anchor_wh],
                                  dtype=torch.float32, device=device)
    return out


def _corner_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of centre-format boxes (..., 4), broadcast; 0 where they do not
    overlap (darknet's box_iou)."""
    w = (torch.minimum(a[..., 0] + a[..., 2] / 2, b[..., 0] + b[..., 2] / 2)
         - torch.maximum(a[..., 0] - a[..., 2] / 2, b[..., 0] - b[..., 2] / 2)).clamp(min=0)
    h = (torch.minimum(a[..., 1] + a[..., 3] / 2, b[..., 1] + b[..., 3] / 2)
         - torch.maximum(a[..., 1] - a[..., 3] / 2, b[..., 1] - b[..., 3] / 2)).clamp(min=0)
    inter = w * h
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union.clamp(min=1e-12)


def _bce(logit: torch.Tensor, target) -> torch.Tensor:
    """Elementwise BCE with logits against a tensor or a constant (filled
    on the device: a Python number made a device tensor would wait)."""
    if not isinstance(target, torch.Tensor):
        target = torch.full_like(logit, target)
    return F.binary_cross_entropy_with_logits(logit, target, reduction="none")


def _centre(cell, logit: torch.Tensor, grid, scale=None, shift=None) -> torch.Tensor:
    """A decoded centre coordinate, (cell + s sig(logit) - shift) / grid;
    YOLOv3's (cell + sig(logit)) / grid where no head stretches it."""
    if scale is None:
        return (cell + torch.sigmoid(logit)) / grid
    return (cell + scale * torch.sigmoid(logit) - shift) / grid


def _ciou(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """CIoU of centre-format boxes (..., 4) (Zheng et al.): IoU - rho^2 / c^2
    - alpha v, alpha = v / (1 - IoU + v) without gradient (0 where v is)."""
    iou = _corner_iou(pred, truth)
    lo = torch.minimum(pred[..., :2] - pred[..., 2:] / 2, truth[..., :2] - truth[..., 2:] / 2)
    hi = torch.maximum(pred[..., :2] + pred[..., 2:] / 2, truth[..., :2] + truth[..., 2:] / 2)
    c2 = torch.sum(torch.square(hi - lo), -1)
    rho2 = torch.sum(torch.square(pred[..., :2] - truth[..., :2]), -1)
    v = (4 / math.pi ** 2) * torch.square(torch.atan(truth[..., 2] / truth[..., 3])
                                          - torch.atan(pred[..., 2] / pred[..., 3]))
    with torch.no_grad():
        alpha = torch.where(v > 0, v / (1 - iou + v), torch.zeros_like(v))
    return iou - rho2 / c2 - alpha * v


def yolo_loss(
    heads: Sequence[torch.Tensor],
    target: torch.Tensor,
    keep: torch.Tensor,
    specs: Sequence[YoloSpec],
    net_wh: tuple[int, int],
) -> tuple[torch.Tensor, dict[str, Any]]:
    """heads: one (nB, H, W, len(mask) * (5 + nC)) a [yolo] layer, in the
    spec's order, any float type (the loss is float32); target (nB, 50, 5)
    normalised [cls, cx, cy, w, h], zero-padded; keep (nB,) 0/1; net_wh the
    input's (width, height) in pixels. Every head takes the same `iou_loss`.
    Returns (loss, metrics): the terms as the region loss names them
    (`loss_conf` the objectness; with `ciou` the box term is `loss_iou` and
    `loss_x`..`loss_h` read 0), `nGT`, `nCorrect` (truths whose prediction
    at their best anchor overlaps them above 0.5), `nProposals` (objectness
    above 0.25), `positives` (predictions with an object target, one count
    a head), `extra_positives` (those that only an `iou_thresh` assignment
    took; where a head's `iou_thresh` is below 1) and `ignored`
    (predictions whose no-object term the ignore threshold drops)."""
    dev = heads[0].device
    nB, S = target.shape[:2]
    nC = specs[0].num_classes
    kinds = {spec.iou_loss for spec in specs}
    if len(kinds) != 1:
        raise ValueError(f"the heads mix box losses {sorted(kinds)}")
    ciou = kinds == {"ciou"}
    lay = _layout(tuple(tuple(h.shape[1:3]) for h in heads), tuple(specs), tuple(net_wh), dev)
    n_all = specs[0].num
    # candidates a truth slot: its best anchor, then (where a head assigns
    # beyond it) each anchor of the cfg in order
    K = 1 + n_all if "a_iou_thresh" in lay else 1
    t = target.to(device=dev, dtype=torch.float32)
    km = keep.to(device=dev, dtype=torch.float32)[:, None]
    valid = t[:, :, 1] > 0
    gt = t[:, :, 1:5]
    o = torch.cat([h.reshape(nB, -1, 5 + nC) for h in heads], 1).to(torch.float32)

    # each prediction's box and its best IoU with its image's truths
    with torch.no_grad():
        od = o.detach()
        scale, shift = lay.get("scale"), lay.get("shift")
        pred = torch.stack([_centre(lay["i"], od[..., 0], lay["w"], scale, shift),
                            _centre(lay["j"], od[..., 1], lay["h"], scale, shift),
                            torch.exp(od[..., 2]) * lay["aw"],
                            torch.exp(od[..., 3]) * lay["ah"]], -1)
        ious = _corner_iou(pred[:, :, None, :], gt[:, None, :, :])
        best = torch.where(valid[:, None, :], ious, torch.zeros_like(ious)).amax(dim=2)
        drop = best > lay["thresh"]  # (nB, N)

    # each truth's best anchor of all (and its other anchors above their
    # head's iou_thresh), the head whose mask holds each, its prediction
    # there, and the last assignment on each prediction
    anchors = lay["anchors"]
    gw, gh = t[:, :, 3], t[:, :, 4]
    inter = (torch.minimum(gw[..., None], anchors[:, 0]) *
             torch.minimum(gh[..., None], anchors[:, 1]))
    shape_iou = inter / (gw[..., None] * gh[..., None] + anchors[:, 0] * anchors[:, 1] - inter)
    best_n = torch.argmax(shape_iou, dim=-1)  # (nB, S), first of equals
    n, slot_valid = best_n, valid
    if K > 1:
        every = torch.arange(n_all, device=dev)
        n = torch.cat([best_n[..., None], every.expand(nB, S, n_all)], -1).reshape(nB, S * K)
        extra = (shape_iou > lay["a_iou_thresh"]) & (every != best_n[..., None])
        took = torch.cat([torch.ones_like(extra[..., :1]), extra], -1).reshape(nB, S * K)
        slot_valid = valid[:, :, None].expand(-1, -1, K).reshape(nB, S * K) & took
        t = t[:, :, None].expand(-1, -1, K, -1).reshape(nB, S * K, 5)
    gx, gy, gw, gh = t[:, :, 1], t[:, :, 2], t[:, :, 3], t[:, :, 4]
    cls = t[:, :, 0].to(torch.int64)
    head = lay["head"][n]
    mine = slot_valid & (head >= 0)
    grid_w, grid_h = lay["grid_w"][n], lay["grid_h"][n]
    gi = torch.minimum((gx * grid_w).to(torch.int64).clamp(min=0), grid_w - 1)
    gj = torch.minimum((gy * grid_h).to(torch.int64).clamp(min=0), grid_h - 1)
    cell = lay["first"][n] + (gj * grid_w + gi) * lay["a"][n] + lay["slot"][n]
    cell = torch.where(mine, cell, 0)  # (nB, S K); an assignment no head takes reads prediction 0
    M = cell.shape[1]
    later = torch.triu(torch.ones((M, M), dtype=torch.bool, device=dev), diagonal=1)
    same = (cell[:, :, None] == cell[:, None, :]) & mine[:, :, None] & mine[:, None, :]
    win = mine & ~(same & later).any(dim=2)
    w = win.to(torch.float32) * km

    # the object plane: 1 at each winner's prediction (one spare column
    # takes the slots that win nothing)
    spare = o.shape[1]
    pos = torch.zeros((nB, spare + 1), dtype=torch.bool, device=dev)
    pos.scatter_(1, torch.where(win, cell, spare), True)
    pos = pos[:, :spare]

    got = torch.gather(o, 1, cell[..., None].expand(-1, -1, 5 + nC))  # (nB, S K, 5 + nC)
    aw, ah = anchors[n, 0], anchors[n, 1]
    scale, shift = (lay["a_scale"][n], lay["a_shift"][n]) if "a_scale" in lay else (None, None)
    onehot = (cls[..., None] == torch.arange(nC, device=dev)).to(torch.float32)
    labels = same.to(torch.float32) @ onehot  # the classes of the assignments on a prediction
    noobj = (~pos & ~drop).to(torch.float32) * km
    wb = w * lay["a_iou_norm"][n] if "a_iou_norm" in lay else w
    wc = w * lay["a_cls_norm"][n] if "a_cls_norm" in lay else w
    if ciou:
        box = torch.stack([_centre(gi, got[..., 0], grid_w, scale, shift),
                           _centre(gj, got[..., 1], grid_h, scale, shift),
                           torch.exp(got[..., 2]) * aw, torch.exp(got[..., 3]) * ah], -1)
        # an entry no truth fills compares with a unit box: its weight is 0,
        # and its CIoU (and gradient) stay finite
        truth = torch.where(mine[..., None], torch.stack([gx, gy, gw, gh], -1),
                            torch.full_like(box, 0.5))
        terms = {"loss_iou": torch.sum(wb * (1 - _ciou(box, truth)))}
    else:
        tx, ty = gx * grid_w - gi, gy * grid_h - gj
        tw = torch.log(gw.clamp(min=1e-12) / aw)
        th = torch.log(gh.clamp(min=1e-12) / ah)
        ws = wb * (2.0 - gw * gh)
        terms = {
            "loss_x": torch.sum(ws * _bce(got[..., 0], tx)),
            "loss_y": torch.sum(ws * _bce(got[..., 1], ty)),
            "loss_w": torch.sum(ws * torch.square(got[..., 2] - tw)) / 2,
            "loss_h": torch.sum(ws * torch.square(got[..., 3] - th)) / 2,
        }
    terms["loss_conf"] = (torch.sum(w * _bce(got[..., 4], 1.0))
                          + torch.sum(noobj * _bce(o[..., 4], 0.0)))
    terms["loss_cls"] = torch.sum(wc[..., None] * _bce(got[..., 5:], labels.clamp(max=1.0)))
    loss = sum(terms.values())

    with torch.no_grad():
        kept = km > 0
        gd = got.detach()
        box = torch.stack([_centre(gi, gd[..., 0], grid_w, scale, shift),
                           _centre(gj, gd[..., 1], grid_h, scale, shift),
                           torch.exp(gd[..., 2]) * aw, torch.exp(gd[..., 3]) * ah], -1)
        hit = mine & (_corner_iou(box, torch.stack([gx, gy, gw, gh], -1)) > 0.5) & kept
        per_head = head[..., None] == torch.arange(len(heads), device=dev)
        zero = torch.zeros((), device=dev)
        metrics = {
            "nGT": (valid & kept).sum(),
            # each truth's best-anchor assignment, the first of its candidates
            "nCorrect": hit.reshape(nB, S, K)[..., 0].sum(),
            "nProposals": ((torch.sigmoid(od[..., 4]) > 0.25) & kept).sum(),
            **({k: zero for k in ("loss_x", "loss_y", "loss_w", "loss_h")} if ciou else {}),
            **terms, "loss": loss,
            "positives": (per_head & (win & kept)[..., None]).sum(dim=(0, 1)),
            "ignored": (drop & ~pos & kept).sum(),
        }
        if K > 1:
            metrics["extra_positives"] = (win & kept).reshape(nB, S, K)[..., 1:].sum()
    return loss, metrics
