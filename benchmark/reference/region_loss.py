"""The YOLOv2 region loss and the meta detector's loss, as the authors'
`region_loss.py` computes them (RegionLoss; RegionLossV2).

Targets are built image by image and ground truth by ground truth, so two
truths that land on one (anchor, cell) leave the later one's values, as
the authors' loop does. `keep` (one 0/1 weight a row) takes the place of
the authors' dropping of negative rows (`neg_filter`): a dropped row
weighs nothing in any term. Departures: the cell index of a truth is
clamped into the grid (the authors' `int(gx)` never reaches the edge for a
box inside the image), and a row under the meta loss whose cell two kept
copies mark is left out of the classification term, where the authors'
histogram merge would give it a label past the copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WARMUP_SEEN = 12800


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of centre-format boxes (..., 4), broadcast; 0 where the union is 0."""
    uw = torch.maximum(a[..., 0] + a[..., 2] / 2, b[..., 0] + b[..., 2] / 2) - \
        torch.minimum(a[..., 0] - a[..., 2] / 2, b[..., 0] - b[..., 2] / 2)
    uh = torch.maximum(a[..., 1] + a[..., 3] / 2, b[..., 1] + b[..., 3] / 2) - \
        torch.minimum(a[..., 1] - a[..., 3] / 2, b[..., 1] - b[..., 3] / 2)
    cw = a[..., 2] + b[..., 2] - uw
    ch = a[..., 3] + b[..., 3] - uh
    inter = torch.where((cw <= 0) | (ch <= 0), torch.zeros_like(cw), cw * ch)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(union))


def _split(output: torch.Tensor, n_anchors: int, n_classes: int):
    nb, h, w, _ = output.shape
    return output.float().reshape(nb, h, w, n_anchors, 5 + n_classes).permute(0, 3, 4, 1, 2)


def build_targets(o: torch.Tensor, target: torch.Tensor, region: dict, seen: int) -> dict:
    """o: raw (nB, A, 5+nC, H, W); target: (nB, 50, 5) normalised
    [cls, cx, cy, w, h], zero-padded. Returns the target planes (nB, A, H, W)."""
    nb, a_n, _, h, w = o.shape
    dev = o.device
    anchors = torch.tensor(region["anchors"], dtype=torch.float32, device=dev)
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    o = o.detach()
    pred = torch.stack([
        torch.sigmoid(o[:, :, 0]) + gx, torch.sigmoid(o[:, :, 1]) + gy,
        torch.exp(o[:, :, 2]) * anchors[:, 0, None, None],
        torch.exp(o[:, :, 3]) * anchors[:, 1, None, None]], dim=-1)  # (nB, A, H, W, 4)
    t = target.float()
    valid = t[:, :, 1] > 0
    gt = torch.stack([t[:, :, 1] * w, t[:, :, 2] * h, t[:, :, 3] * w, t[:, :, 4] * h], dim=-1)

    shape = (nb, a_n, h, w)
    warm = seen < WARMUP_SEEN
    planes = {
        "coord_mask": torch.full(shape, 1.0 if warm else 0.0, device=dev),
        "cls_mask": torch.zeros(shape, device=dev),
        "tx": torch.full(shape, 0.5 if warm else 0.0, device=dev),
        "ty": torch.full(shape, 0.5 if warm else 0.0, device=dev),
        "tw": torch.zeros(shape, device=dev), "th": torch.zeros(shape, device=dev),
        "tconf": torch.zeros(shape, device=dev), "tcls": torch.zeros(shape, device=dev),
    }
    # a prediction that overlaps any truth above `thresh` is not pushed to 0
    ious = box_iou(pred.reshape(nb, -1, 1, 4), gt[:, None])  # (nB, AHW, 50)
    ious = torch.where(valid[:, None], ious, torch.zeros_like(ious))
    silenced = ious.max(dim=2).values.reshape(shape) > region["thresh"]
    planes["conf_mask"] = torch.where(silenced, 0.0, float(region["noobject_scale"]))

    rows = valid.nonzero().tolist()
    if not rows:
        return planes
    host_gt, host_t = gt.cpu(), t.cpu()
    host_anchors = [tuple(a) for a in region["anchors"]]
    assigned = []
    for b, s in rows:
        x, y, bw, bh = (float(v) for v in host_gt[b, s])
        best, best_iou = 0, -1.0
        for n, (aw, ah) in enumerate(host_anchors):
            inter = min(bw, aw) * min(bh, ah)
            iou = inter / (bw * bh + aw * ah - inter)
            if iou > best_iou:
                best, best_iou = n, iou
        gi, gj = min(int(x), w - 1), min(int(y), h - 1)
        assigned.append((b, s, best, gj, gi))
    idx = torch.tensor(assigned, device=dev)
    b, s, n, j, i = idx.unbind(1)
    tconf = box_iou(gt[b, s], pred[b, n, j, i])
    aw, ah = anchors[n, 0], anchors[n, 1]
    vals = {
        "coord_mask": torch.ones_like(tconf), "cls_mask": torch.ones_like(tconf),
        "conf_mask": torch.full_like(tconf, float(region["object_scale"])),
        "tx": gt[b, s, 0] - i.float(), "ty": gt[b, s, 1] - j.float(),
        "tw": torch.log(gt[b, s, 2] / aw), "th": torch.log(gt[b, s, 3] / ah),
        "tconf": tconf, "tcls": t[b, s, 0],
    }
    # in the authors' order: a later truth on the same cell overwrites
    for k in range(len(assigned)):
        cell = (b[k], n[k], j[k], i[k])
        for name, v in vals.items():
            planes[name][cell] = v[k]
    return planes


def _coord_conf(o, planes, keep, region):
    km = keep[:, None, None, None]
    cm, fm = planes["coord_mask"] * km, planes["conf_mask"] * km
    x, y = torch.sigmoid(o[:, :, 0]), torch.sigmoid(o[:, :, 1])
    w, h, conf = o[:, :, 2], o[:, :, 3], torch.sigmoid(o[:, :, 4])
    cs = region["coord_scale"]
    return (cs * torch.sum(cm * (x - planes["tx"]) ** 2) / 2
            + cs * torch.sum(cm * (y - planes["ty"]) ** 2) / 2
            + cs * torch.sum(cm * (w - planes["tw"]) ** 2) / 2
            + cs * torch.sum(cm * (h - planes["th"]) ** 2) / 2
            + torch.sum(fm * (conf - planes["tconf"]) ** 2) / 2)


def region_loss(output, target, keep, seen: int, region: dict) -> torch.Tensor:
    """Plain YOLOv2: output (nB, H, W, A*(5+nC)), target (nB, 50, 5), keep (nB,)."""
    a_n, n_c = len(region["anchors"]), region["classes"]
    o = _split(output, a_n, n_c)
    planes = build_targets(o, target, region, seen)
    loss = _coord_conf(o, planes, keep, region)
    mask = (planes["cls_mask"] * keep[:, None, None, None]) > 0  # (nB, A, H, W)
    logits = o[:, :, 5:].permute(0, 1, 3, 4, 2)[mask]  # (n, nC)
    labels = planes["tcls"][mask].long()
    return loss + region["class_scale"] * F.cross_entropy(logits, labels, reduction="sum")


def region_loss_v2(output, target, keep, seen: int, region: dict, n_cls: int) -> torch.Tensor:
    """Meta: output (bs*n_cls, H, W, A*6) image-major, target (bs, n_cls, 50, 5),
    keep (bs*n_cls,). Classification is a softmax across the n_cls copies
    of an image at each (anchor, cell) that exactly one kept copy marks."""
    bs = target.shape[0]
    a_n = len(region["anchors"])
    o = _split(output, a_n, 1)
    nb, _, _, h, w = o.shape
    planes = build_targets(o, target.reshape(nb, *target.shape[2:]), region, seen)
    loss = _coord_conf(o, planes, keep, region)
    km = keep[:, None, None, None]
    marked = (planes["cls_mask"] * km).reshape(bs, n_cls, a_n, h, w)
    label = (planes["tcls"] * planes["cls_mask"] * km).reshape(bs, n_cls, a_n, h, w).sum(1)
    one = marked.sum(1) == 1  # (bs, A, H, W)
    logits = o[:, :, 5].reshape(bs, n_cls, a_n, h, w).permute(0, 2, 3, 4, 1)[one]
    return loss + region["class_scale"] * F.cross_entropy(logits, label[one].long(),
                                                           reduction="sum")


def lr_at(processed: int, base: float, steps, scales) -> float:
    """The authors' `adjust_learning_rate`: scale for each step passed,
    stopping at the first not reached or exactly reached."""
    lr = base
    for i, step in enumerate(steps):
        if processed >= step:
            lr *= scales[i] if i < len(scales) else 1.0
            if processed == step:
                break
        else:
            break
    return lr

