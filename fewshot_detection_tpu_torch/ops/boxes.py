"""Box decoding, IoU, and NMS.

Decode runs on the device as one vectorized pass (the reference decoded on
GPU then filtered with a python triple loop on CPU — reference
utils.py:112-290); filtering here is vectorized numpy on host over the small
decoded arrays. Box list layout matches the reference exactly:
``[bcx, bcy, bw, bh, det_conf, cls_conf, cls_id, (extra_conf, extra_id)...]``
with coordinates normalized by the output grid.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------


def iou_xywh(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """Pairwise-broadcastable IoU of center-format boxes (..., 4)."""
    x1min = box1[..., 0] - box1[..., 2] / 2.0
    x1max = box1[..., 0] + box1[..., 2] / 2.0
    y1min = box1[..., 1] - box1[..., 3] / 2.0
    y1max = box1[..., 1] + box1[..., 3] / 2.0
    x2min = box2[..., 0] - box2[..., 2] / 2.0
    x2max = box2[..., 0] + box2[..., 2] / 2.0
    y2min = box2[..., 1] - box2[..., 3] / 2.0
    y2max = box2[..., 1] + box2[..., 3] / 2.0

    uw = np.maximum(x1max, x2max) - np.minimum(x1min, x2min)
    uh = np.maximum(y1max, y2max) - np.minimum(y1min, y2min)
    cw = box1[..., 2] + box2[..., 2] - uw
    ch = box1[..., 3] + box2[..., 3] - uh
    inter = np.where((cw <= 0) | (ch <= 0), 0.0, cw * ch)
    union = box1[..., 2] * box1[..., 3] + box2[..., 2] * box2[..., 3] - inter
    return inter / union


def iou_xywh_t(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise-broadcastable IoU of center-format boxes (..., 4) on tensors.
    Degenerate all-zero boxes yield 0 (guarded divide).

    The operation order is fixed and shared with the CUDA NMS kernel
    (csrc/nms.cu) and with the JAX package's traceable IoU: every
    intermediate is rounded to float32 once, nothing is fused, so a decision
    `iou > thresh` falls the same way on every path."""
    uw = torch.maximum(box1[..., 0] + box1[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2) - \
         torch.minimum(box1[..., 0] - box1[..., 2] / 2, box2[..., 0] - box2[..., 2] / 2)
    uh = torch.maximum(box1[..., 1] + box1[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2) - \
         torch.minimum(box1[..., 1] - box1[..., 3] / 2, box2[..., 1] - box2[..., 3] / 2)
    cw = box1[..., 2] + box2[..., 2] - uw
    ch = box1[..., 3] + box2[..., 3] - uh
    inter = torch.where((cw <= 0) | (ch <= 0), torch.zeros_like(cw), cw * ch)
    union = box1[..., 2] * box1[..., 3] + box2[..., 2] * box2[..., 3] - inter
    return torch.where(
        union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(union)
    )


# ---------------------------------------------------------------------------
# decode (device)
# ---------------------------------------------------------------------------


def decode_region_output(
    output: torch.Tensor,
    anchors: tuple[tuple[float, float], ...],
    num_classes: int,
) -> dict:
    """Decode raw region-head output into normalized boxes + confidences.

    output: (B, H, W, A*(5+nC)) NHWC.
    Returns dict of tensors, each (B, A, H, W[, nC]):
      boxes (B, A, H, W, 4) normalized cx cy w h; det_conf; cls_logits.
    """
    b, h, w, _ = output.shape
    a = len(anchors)
    o = output.reshape(b, h, w, a, 5 + num_classes).permute(0, 3, 1, 2, 4)
    kw = {"dtype": output.dtype, "device": output.device}
    grid_x = torch.arange(w, **kw)[None, None, None, :]
    grid_y = torch.arange(h, **kw)[None, None, :, None]
    anchor_w = torch.tensor([aw for aw, _ in anchors], **kw)[None, :, None, None]
    anchor_h = torch.tensor([ah for _, ah in anchors], **kw)[None, :, None, None]

    xs = (torch.sigmoid(o[..., 0]) + grid_x) / w
    ys = (torch.sigmoid(o[..., 1]) + grid_y) / h
    ws = torch.exp(o[..., 2]) * anchor_w / w
    hs = torch.exp(o[..., 3]) * anchor_h / h
    det_conf = torch.sigmoid(o[..., 4])
    boxes = torch.stack([xs, ys, ws, hs], dim=-1)
    return {"boxes": boxes, "det_conf": det_conf, "cls_logits": o[..., 5:]}


def region_scores_v1(decoded: dict) -> dict:
    """Per-anchor class softmax over the nC channels (reference
    utils.py:140) — the plain YOLOv2 detector's score normalization."""
    return {**decoded, "cls_confs": torch.softmax(decoded["cls_logits"], dim=-1)}


def region_scores_v2(decoded: dict, n_cls: int) -> dict:
    """Cross-copy softmax: class confidence normalized ACROSS the n_cls
    batch copies of each anchor (reference utils.py:212-219) — the meta
    detector's score normalization. decoded tensors lead with batch B*n_cls
    (b-major); the softmax runs over axis 1 of (B, n_cls, A, H, W, nC).
    """
    logits = decoded["cls_logits"]  # (B*n, A, H, W, nC)
    bn = logits.shape[0]
    l = logits.reshape(bn // n_cls, n_cls, *logits.shape[1:])
    cls_confs = torch.softmax(l, dim=1).reshape(logits.shape)
    return {**decoded, "cls_confs": cls_confs}


# ---------------------------------------------------------------------------
# host-side filtering (vectorized replacement for the reference triple loop)
# ---------------------------------------------------------------------------


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def filter_boxes(
    decoded: dict,
    conf_thresh: float,
    only_objectness: bool = True,
    validation: bool = False,
) -> list[list[list[float]]]:
    """Threshold decoded output into per-image reference-format box lists.

    Iteration order inside each image matches the reference loop nesting
    (cy, cx, anchor — reference utils.py:158-184) so downstream NMS tie-breaking is
    identical.
    """
    boxes = _host(decoded["boxes"])  # (B, A, H, W, 4)
    det = _host(decoded["det_conf"])  # (B, A, H, W)
    cls_confs = _host(decoded["cls_confs"])  # (B, A, H, W, nC)
    B, A, H, W = det.shape
    nC = cls_confs.shape[-1]
    cls_max_id = cls_confs.argmax(-1)
    cls_max_conf = np.take_along_axis(cls_confs, cls_max_id[..., None], -1)[..., 0]

    conf = det if only_objectness else det * cls_max_conf
    # reorder to (B, H, W, A) to match loop nesting cy, cx, anchor
    order = (0, 2, 3, 1)
    conf_t = conf.transpose(order)
    keep = conf_t > conf_thresh

    all_boxes: list[list[list[float]]] = []
    for b in range(B):
        picks = np.argwhere(keep[b])  # rows of (cy, cx, a) in C order
        blist = []
        for cy, cx, a in picks:
            box = [
                float(boxes[b, a, cy, cx, 0]),
                float(boxes[b, a, cy, cx, 1]),
                float(boxes[b, a, cy, cx, 2]),
                float(boxes[b, a, cy, cx, 3]),
                float(det[b, a, cy, cx]),
                float(cls_max_conf[b, a, cy, cx]),
                int(cls_max_id[b, a, cy, cx]),
            ]
            if not only_objectness and validation:
                for c in range(nC):
                    tc = float(cls_confs[b, a, cy, cx, c])
                    if c != box[6] and det[b, a, cy, cx] * tc > conf_thresh:
                        box.extend([tc, c])
            blist.append(box)
        all_boxes.append(blist)
    return all_boxes


def get_region_boxes(
    output: torch.Tensor,
    conf_thresh: float,
    num_classes: int,
    anchors: tuple[tuple[float, float], ...],
    only_objectness: bool = True,
    validation: bool = False,
):
    """Plain-YOLOv2 decode: reference utils.py:112-193 contract."""
    decoded = decode_region_output(output, anchors, num_classes)
    return filter_boxes(region_scores_v1(decoded), conf_thresh, only_objectness, validation)


def get_region_boxes_v2(
    output: torch.Tensor,
    n_cls: int,
    conf_thresh: float,
    num_classes: int,
    anchors: tuple[tuple[float, float], ...],
    only_objectness: bool = True,
    validation: bool = False,
):
    """Meta decode with cross-copy class softmax: reference utils.py:195-290 contract.
    output batch is B*n_cls (b-major); returns B*n_cls box lists."""
    decoded = decode_region_output(output, anchors, num_classes)
    decoded = region_scores_v2(decoded, n_cls)
    return filter_boxes(decoded, conf_thresh, only_objectness, validation)


def nms(boxes: list[list[float]], nms_thresh: float) -> list[list[float]]:
    """Greedy NMS by objectness, identical ordering to reference utils.py:85-104."""
    if len(boxes) == 0:
        return boxes
    arr = np.asarray([b[:5] for b in boxes], np.float32)
    order = np.argsort(1.0 - arr[:, 4], kind="stable")
    xywh = arr[order, :4]
    confs = arr[order, 4].copy()
    ious = iou_xywh(xywh[:, None, :], xywh[None, :, :])
    n = len(boxes)
    out = []
    for i in range(n):
        if confs[i] > 0:
            out.append(boxes[int(order[i])])
            suppress = ious[i, i + 1 :] > nms_thresh
            confs[i + 1 :][suppress] = 0
    return out
