"""Image IO helpers + box drawing (reference utils.py:293-408, 536-569).
PIL and cv2 are imported inside the functions that open, draw or save image
files, so the package imports (and serves in-memory data) without them."""

from __future__ import annotations

import os

import numpy as np


def get_image_size(fname: str) -> tuple[int, int]:
    """(width, height) without decoding pixel data: from the header through
    the native pipeline under FSD_NATIVE=1 (no PIL needed), else PIL."""
    if os.environ.get("FSD_NATIVE", "0") == "1":
        from ..native import NativeImagePipe

        return NativeImagePipe().image_size(fname)
    from PIL import Image

    with Image.open(fname) as im:
        return im.size


def load_image_resized(fname: str, width: int, height: int) -> np.ndarray:
    """float32 HWC [0,1] resized input (reference detect.py:26-27 semantics):
    PIL's default resize (bicubic), or under FSD_NATIVE=1 the native
    library's copy of it (no PIL needed; the same bytes wherever the two
    decodes agree, native/src/resize.cpp)."""
    if os.environ.get("FSD_NATIVE", "0") == "1":
        from ..native import NativeImagePipe

        img = NativeImagePipe().load_resized_pil(fname, width, height)
        return img.astype(np.float32) / 255.0
    from PIL import Image

    img = Image.open(fname).convert("RGB")
    img = img.resize((width, height))
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0


def scale_bboxes(bboxes, width: float, height: float):
    out = []
    for b in bboxes:
        b = list(b)
        b[0] *= width
        b[1] *= height
        b[2] *= width
        b[3] *= height
        out.append(b)
    return out


def _class_color(cls_id: int, n_classes: int) -> tuple[int, int, int]:
    """Deterministic per-class color (the reference's HSV ramp keyed by
    cls_id*123457 % classes, utils.py:336-343)."""
    colors = np.asarray(
        [[1, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0], [1, 0, 0]],
        np.float32,
    )
    offset = cls_id * 123457 % max(n_classes, 1)
    ratio = offset / max(n_classes, 1) * 5
    i, j = int(np.floor(ratio)), int(np.ceil(ratio))
    r = ratio - i
    rgb = (1 - r) * colors[i] + r * colors[j]
    return tuple(int(v * 255) for v in rgb[::-1])


def plot_boxes_cv2(img, boxes, savename=None, class_names=None, color=None):
    """Draw reference-format boxes on a cv2 image (numpy HWC, BGR) —
    reference utils.py:293-333. The reference passes RGB-ordered color
    tuples to cv2 calls on a BGR image, so saved class colors come out
    channel-swapped; that quirk is part of the contract and reproduced."""
    import cv2

    width, height = img.shape[1], img.shape[0]
    for box in boxes:
        x1 = int(round((box[0] - box[2] / 2.0) * width))
        y1 = int(round((box[1] - box[3] / 2.0) * height))
        x2 = int(round((box[0] + box[2] / 2.0) * width))
        y2 = int(round((box[1] + box[3] / 2.0) * height))
        rgb = color if color else (255, 0, 0)
        if len(box) >= 7 and class_names:
            cls_id = int(box[6])
            print(f"{class_names[cls_id]}: {float(box[5]):f}")
            if color is None:
                rgb = _class_color(cls_id, len(class_names))
            img = cv2.putText(
                img, class_names[cls_id], (x1, y1),
                cv2.FONT_HERSHEY_SIMPLEX, 1.2, rgb, 1,
            )
        img = cv2.rectangle(img, (x1, y1), (x2, y2), rgb, 1)
    if savename:
        print(f"save plot results to {savename}")
        cv2.imwrite(savename, img)
    return img


def plot_boxes(img, boxes, savename: str | None = None, class_names: list[str] | None = None):
    """Draw reference-format boxes ([cx,cy,w,h,conf,cls_conf,cls_id,...],
    normalized) onto a PIL image (reference utils.py:335-371)."""
    from PIL import ImageDraw

    width, height = img.width, img.height
    draw = ImageDraw.Draw(img)
    for box in boxes:
        x1 = (box[0] - box[2] / 2.0) * width
        y1 = (box[1] - box[3] / 2.0) * height
        x2 = (box[0] + box[2] / 2.0) * width
        y2 = (box[1] + box[3] / 2.0) * height
        rgb = (255, 0, 0)
        if len(box) >= 7 and class_names:
            cls_id = int(box[6])
            print(f"{class_names[cls_id]}: {float(box[5]):f}")
            rgb = _class_color(cls_id, len(class_names))
            draw.text((x1, y1), class_names[cls_id], fill=rgb)
        draw.rectangle([x1, y1, x2, y2], outline=rgb)
    if savename:
        print(f"save plot results to {savename}")
        img.save(savename)
    return img
