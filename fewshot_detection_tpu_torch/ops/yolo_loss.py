"""YOLOv3 loss over the [yolo] heads, targets built on the device.

The semantics are darknet's `yolo_layer.c` (forward_yolo_layer,
delta_yolo_box, delta_yolo_class), summed over the batch. Darknet writes
its deltas straight onto the head's logits, so the loss whose gradient they
are is, for a head with grid W x H, anchor a of its mask at cell (i, j) and
an input of net_w x net_h pixels:

  * the predicted box is bx = (i + s(tx)) / W, by = (j + s(ty)) / H,
    bw = exp(tw) * aw / net_w, bh = exp(th) * ah / net_h (s: the logistic)
  * every prediction takes BCEwithlogits(to, 0), except where its best IoU
    with any truth of its image exceeds the head's `ignore_thresh`
  * a truth (x, y, w, h, c) goes to its best anchor n*, the argmax over ALL
    the anchors of the IoU of (0, 0, w, h) with (0, 0, aw / net_w,
    ah / net_h) (the first on a tie). Where n* lies in this head's mask, the
    prediction at (floor(x W), floor(y H), n*) takes, with s = 2 - w h:
    s BCEwithlogits(tx, x W - i) and the same for y, s (tw - log(w net_w /
    aw))^2 / 2 and the same for h, BCEwithlogits(to, 1) in place of its
    no-object term, and BCEwithlogits(c_k, [k = c]) over the classes
  * where a later truth lands on the same prediction, its box terms
    replace the earlier one's and its class bit is set beside the earlier
    one's (delta_yolo_class on a delta already written)

Departures: at most 50 truths an image (the port's label layout; darknet
reads 90); no `truth_thresh` branch (at the published 1 it never fires);
a truth's cell is clamped into the grid (darknet's int() reaches W only
for a centre at the image's edge); `keep` (one 0/1 weight an image, the
plain trainer's) weighs every term of its image.

The heads are laid end to end, so each step of the loss runs once for all
of them. Nothing synchronises with the host: each truth slot's anchor,
prediction and winner (the last truth on its prediction) are found with
fixed shapes, the assigned predictions are gathered at the slots, and only
the ignore mask's IoU and the no-object term run over every prediction.
"""

from __future__ import annotations

import functools
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
    that mask, that head's grid, anchors a cell and first prediction, and
    the anchor normalised by the input."""
    net_w, net_h = net_wh
    per_pred = {k: [] for k in ("i", "j", "w", "h", "aw", "ah", "thresh")}
    n_anchors = specs[0].num
    per_anchor = {k: [-1] * n_anchors for k in ("head", "slot", "grid_w", "grid_h", "a", "first")}
    first = 0
    for head, ((gh, gw), spec) in enumerate(zip(grids, specs)):
        n_a = len(spec.mask)
        for j in range(gh):
            for i in range(gw):
                for n in spec.mask:
                    aw, ah = spec.anchor_wh[n]
                    for k, v in (("i", i), ("j", j), ("w", gw), ("h", gh), ("aw", aw / net_w),
                                 ("ah", ah / net_h), ("thresh", spec.ignore_thresh)):
                        per_pred[k].append(v)
        for slot, n in enumerate(spec.mask):
            for k, v in (("head", head), ("slot", slot), ("grid_w", gw), ("grid_h", gh),
                         ("a", n_a), ("first", first)):
                per_anchor[k][n] = v
        first += gh * gw * n_a
    out = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in per_pred.items()}
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
    input's (width, height) in pixels. Returns (loss, metrics): the terms
    as the region loss names them (`loss_conf` the objectness), `nGT`,
    `nCorrect` (truths whose prediction overlaps them above 0.5),
    `nProposals` (objectness above 0.25), `positives` (predictions with an
    object target, one count a head) and `ignored` (predictions whose
    no-object term the ignore threshold drops)."""
    dev = heads[0].device
    nB, S = target.shape[:2]
    nC = specs[0].num_classes
    lay = _layout(tuple(tuple(h.shape[1:3]) for h in heads), tuple(specs), tuple(net_wh), dev)
    t = target.to(device=dev, dtype=torch.float32)
    km = keep.to(device=dev, dtype=torch.float32)[:, None]
    valid = t[:, :, 1] > 0
    gx, gy, gw, gh = t[:, :, 1], t[:, :, 2], t[:, :, 3], t[:, :, 4]
    cls = t[:, :, 0].to(torch.int64)
    gt = t[:, :, 1:5]
    o = torch.cat([h.reshape(nB, -1, 5 + nC) for h in heads], 1).to(torch.float32)

    # each prediction's box and its best IoU with its image's truths
    with torch.no_grad():
        od = o.detach()
        pred = torch.stack([(lay["i"] + torch.sigmoid(od[..., 0])) / lay["w"],
                            (lay["j"] + torch.sigmoid(od[..., 1])) / lay["h"],
                            torch.exp(od[..., 2]) * lay["aw"],
                            torch.exp(od[..., 3]) * lay["ah"]], -1)
        ious = _corner_iou(pred[:, :, None, :], gt[:, None, :, :])
        best = torch.where(valid[:, None, :], ious, torch.zeros_like(ious)).amax(dim=2)
        drop = best > lay["thresh"]  # (nB, N)

    # each truth's best anchor of all, the head whose mask holds it, its
    # prediction there, and the last truth on each prediction
    anchors = lay["anchors"]
    inter = (torch.minimum(gw[..., None], anchors[:, 0]) *
             torch.minimum(gh[..., None], anchors[:, 1]))
    shape_iou = inter / (gw[..., None] * gh[..., None] + anchors[:, 0] * anchors[:, 1] - inter)
    best_n = torch.argmax(shape_iou, dim=-1)  # (nB, S), first of equals
    head = lay["head"][best_n]
    mine = valid & (head >= 0)
    grid_w, grid_h = lay["grid_w"][best_n], lay["grid_h"][best_n]
    gi = torch.minimum((gx * grid_w).to(torch.int64).clamp(min=0), grid_w - 1)
    gj = torch.minimum((gy * grid_h).to(torch.int64).clamp(min=0), grid_h - 1)
    cell = lay["first"][best_n] + (gj * grid_w + gi) * lay["a"][best_n] + lay["slot"][best_n]
    cell = torch.where(mine, cell, 0)  # (nB, S); a slot no head takes reads prediction 0
    later = torch.triu(torch.ones((S, S), dtype=torch.bool, device=dev), diagonal=1)
    same = (cell[:, :, None] == cell[:, None, :]) & mine[:, :, None] & mine[:, None, :]
    win = mine & ~(same & later).any(dim=2)
    w = win.to(torch.float32) * km

    # the object plane: 1 at each winner's prediction (one spare column
    # takes the slots that win nothing)
    spare = o.shape[1]
    pos = torch.zeros((nB, spare + 1), dtype=torch.bool, device=dev)
    pos.scatter_(1, torch.where(win, cell, spare), True)
    pos = pos[:, :spare]

    got = torch.gather(o, 1, cell[..., None].expand(-1, -1, 5 + nC))  # (nB, S, 5 + nC)
    aw, ah = anchors[best_n, 0], anchors[best_n, 1]
    tx, ty = gx * grid_w - gi, gy * grid_h - gj
    tw = torch.log(gw.clamp(min=1e-12) / aw)
    th = torch.log(gh.clamp(min=1e-12) / ah)
    ws = w * (2.0 - gw * gh)
    onehot = (cls[..., None] == torch.arange(nC, device=dev)).to(torch.float32)
    labels = same.to(torch.float32) @ onehot  # the classes of the truths on a prediction
    noobj = (~pos & ~drop).to(torch.float32) * km
    terms = {
        "loss_x": torch.sum(ws * _bce(got[..., 0], tx)),
        "loss_y": torch.sum(ws * _bce(got[..., 1], ty)),
        "loss_w": torch.sum(ws * torch.square(got[..., 2] - tw)) / 2,
        "loss_h": torch.sum(ws * torch.square(got[..., 3] - th)) / 2,
        "loss_conf": (torch.sum(w * _bce(got[..., 4], 1.0))
                      + torch.sum(noobj * _bce(o[..., 4], 0.0))),
        "loss_cls": torch.sum(w[..., None] * _bce(got[..., 5:], labels.clamp(max=1.0))),
    }
    loss = sum(terms.values())

    with torch.no_grad():
        kept = km > 0
        gd = got.detach()
        box = torch.stack([(gi + torch.sigmoid(gd[..., 0])) / grid_w,
                           (gj + torch.sigmoid(gd[..., 1])) / grid_h,
                           torch.exp(gd[..., 2]) * aw, torch.exp(gd[..., 3]) * ah], -1)
        per_head = head[..., None] == torch.arange(len(heads), device=dev)
        metrics = {
            "nGT": (valid & kept).sum(),
            "nCorrect": (mine & (_corner_iou(box, gt) > 0.5) & kept).sum(),
            "nProposals": ((torch.sigmoid(od[..., 4]) > 0.25) & kept).sum(),
            **terms, "loss": loss,
            "positives": (per_head & (win & kept)[..., None]).sum(dim=(0, 1)),
            "ignored": (drop & ~pos & kept).sum(),
        }
    return loss, metrics
