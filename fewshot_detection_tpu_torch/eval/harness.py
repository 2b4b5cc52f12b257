"""Precision / recall / F-score harnesses.

  * test_detector      — proposal precision/recall vs loader ground truth
                         (reference train.py:233-284, eval.py:69-116): a
                         proposal is correct when the best-IoU box over a gt
                         exceeds 0.5 AND predicts the gt's class
  * recall_list        — per-image IoU recall over an image list
                         (reference recall.py:5-71), class-agnostic

Both take a detector of this package (`PlainDetector`, or `MetaDetector`
with `meta_batches`) and decode on the host (`ops.boxes.get_region_boxes`
+ `nms`), as the JAX package's harnesses do.
"""

from __future__ import annotations

import os

import numpy as np

from ..config.settings import Settings
from ..data.datasets import DetectionDataset, get_labpath
from ..ops.boxes import get_region_boxes, iou_xywh, nms
from ..utils import log

EPS = 1e-5
CONF_THRESH = 0.25
NMS_THRESH = 0.4
IOU_THRESH = 0.5


def _truths_length(truths: np.ndarray) -> int:
    for i in range(truths.shape[0]):
        if truths[i][1] == 0:
            return i
    return truths.shape[0]


def _best_match(box_gt, boxes):
    best_iou, best_j = 0.0, -1
    for j, b in enumerate(boxes):
        iou = float(iou_xywh(np.asarray(box_gt[:4]), np.asarray(b[:4])))
        if iou > best_iou:
            best_iou, best_j = iou, j
    return best_iou, best_j


def test_detector(
    detector,
    testlist: str,
    settings: Settings,
    batch_size: int = 8,
    meta_batches=None,
) -> tuple[float, float, float]:
    """Run the in-training test() harness. `detector` is PlainDetector or
    MetaDetector; for the latter pass `meta_batches` (an iterator of support
    batches) — reference train_meta.py:258-315."""
    ds = DetectionDataset(
        testlist, settings, shape=(detector.width, detector.height),
        shuffle=False, train=False, filter_valid=False,
    )
    region = detector.region
    total = proposals = correct = 0.0
    for imgs, target in ds.batches(batch_size, drop_last=False):
        if meta_batches is not None:
            metax, mask = next(meta_batches)
            output = detector(imgs, metax, mask)
        else:
            output = detector(imgs)
        all_boxes = get_region_boxes(
            output, CONF_THRESH, region.num_classes, region.anchor_wh
        )
        # labels flatten to (B, n_boxes, 5) for both plain (50) and meta
        # (n_cls*50) layouts
        flat_targets = target.reshape(target.shape[0], -1, 5)
        B = imgs.shape[0]
        for i in range(B):
            if meta_batches is None:
                boxes = nms(all_boxes[i], NMS_THRESH)
            else:
                # meta output is b-major over class copies: gather image
                # i's boxes from every copy, tagging each with its copy
                # index as the class id. (The reference's test() harness was
                # disabled and indexed targets out of bounds here,
                # train_meta.py:288-291.)
                n_cls = len(all_boxes) // B
                boxes = []
                for c in range(n_cls):
                    for b in nms(all_boxes[i * n_cls + c], NMS_THRESH):
                        boxes.append(b[:6] + [c])
            truths = flat_targets[i]
            if settings.metayolo:
                # metayolo labels are binned per class with zero padding
                # between bins — count every nonzero row, not the first run
                gt_rows = [t for t in range(truths.shape[0]) if truths[t][1] > 0]
            else:
                gt_rows = list(range(_truths_length(truths)))
            total += len(gt_rows)
            proposals += sum(1 for b in boxes if b[4] > CONF_THRESH)
            for t in gt_rows:
                box_gt = [truths[t][1], truths[t][2], truths[t][3],
                          truths[t][4], 1.0, 1.0, truths[t][0]]
                best_iou, best_j = _best_match(box_gt, boxes)
                if best_iou > IOU_THRESH and boxes[best_j][6] == box_gt[6]:
                    correct += 1

    precision = correct / (proposals + EPS)
    recall = correct / (total + EPS)
    fscore = 2.0 * precision * recall / (precision + recall + EPS)
    log(f"precision: {precision:f}, recall: {recall:f}, fscore: {fscore:f}")
    return precision, recall, fscore


def recall_list(detector, imglist: str, min_box_scale: float | None = None):
    """Per-image class-agnostic recall sweep (reference recall.py:5-71)."""
    from ..utils.imaging import load_image_resized

    min_box_scale = min_box_scale or 8.0 / detector.width
    with open(imglist) as f:
        lines = [l.rstrip() for l in f if l.strip() and not l.startswith("#")]

    region = detector.region
    total = proposals = correct = 0.0
    avg_iou = 0.0
    for img_path in lines:
        lab_path = get_labpath(img_path)
        truths = np.zeros((0, 5))
        if os.path.exists(lab_path) and os.path.getsize(lab_path):
            truths = np.loadtxt(lab_path).reshape(-1, 5)
            truths = truths[truths[:, 3] >= min_box_scale]
        img = load_image_resized(img_path, detector.width, detector.height)
        output = detector(img[None])
        boxes = get_region_boxes(
            output, CONF_THRESH, region.num_classes, region.anchor_wh
        )[0]
        boxes = nms(boxes, NMS_THRESH)
        total += truths.shape[0]
        proposals += sum(1 for b in boxes if b[4] > CONF_THRESH)
        for t in range(truths.shape[0]):
            box_gt = [truths[t][1], truths[t][2], truths[t][3], truths[t][4], 1.0]
            best_iou, _ = _best_match(box_gt, boxes)
            if best_iou > IOU_THRESH:
                avg_iou += best_iou
                correct += 1

    precision = correct / max(proposals, EPS)
    recall = correct / max(total, EPS)
    fscore = 2.0 * precision * recall / max(precision + recall, EPS)
    print(
        "%d IOU: %f, Recall: %f, Precision: %f, Fscore: %f"
        % (len(lines), avg_iou / max(correct, 1), recall, precision, fscore)
    )
    return precision, recall, fscore
